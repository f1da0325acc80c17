"""The shared decode and verify steps over serving slots — the port of
``veles_tpu/serving/engine.py``.

:func:`paged_decode_step` advances a PACKED batch of active slots one
token: the scheduler pads the active slots to a power-of-two occupancy
bucket ``B`` and bounds the attended range by a power-of-two block
bucket ``T`` over the deepest slot.  Padding rows (token 0, position 0,
an all-zero table) write into and read from the trash block.
:func:`verify_step_paged` is the speculative-decoding step: each row's
pending token and its drafts, scored in ONE model pass.
:func:`slot_decode_step` is the dense layout's step (``kv="dense"``):
every slot rides the batch, free ones as garbage rows, against the
slot-major caches through ``apply_step_slots`` (plain ops, no kernel).

The hidden-state lane: with ``want_hidden`` the paged decode and verify
steps also return the f32 input of the chain's final unit (the target's
last hidden state, ``[B, d]`` or ``[B, K1, d]``), which the model draft
head (:mod:`~veles_tpu_torch.serving.draft`) reads.  It stays on the
device: the lane adds no host sync.

Sampling is row-wise.  Greedy rows (temperature 0) take the argmax —
the same token the JAX package picks from the same logits.  Sampling
rows draw token ``t`` of a request with seed ``s`` from the Threefry
key ``fold_in(key(s), t)`` by the Gumbel-argmax draw
(``prng/threefry.py``): the JAX package's stream, whatever slot or
batch the request rides.

Tensor-parallel serving: a cache built with a ``tp`` context
(``cache.tp_``, :mod:`~veles_tpu_torch.serving.tp`) runs both steps
over its positions — each block's shards and head-wise pools on every
position, the row-parallel reductions explicit.  The reference has two
forms of that decode step (the GSPMD one and, under ``tp_overlap`` over
fp32 pools, the explicit per-shard one); the port has only the
per-shard body, so ``root.common.serving.tp_overlap`` chooses nothing
here.
"""

import numpy
import torch

from veles_tpu_torch.prng import threefry


def _fold_keys(seeds, counts, device):
    """Per-request stream keys [B, 2]: each request's draw counter
    folded into its seed's key."""
    return threefry.fold_in(
        threefry.key(torch.as_tensor(numpy.asarray(seeds, numpy.int64),
                                     device=device)),
        torch.as_tensor(numpy.asarray(counts, numpy.int64), device=device))


def sample_slots(logits, temps, topks, seeds, counts):
    """Per-row next-token sampler over ``logits`` [B, vocab] f32:
    rows with ``temps[n] == 0`` take the greedy argmax; sampling rows
    draw categorical(logits / temp) restricted to the row's top-k
    (0 = full vocab; ties with the k-th value stay in) with the key of
    ``(seeds[n], counts[n])``.  ``temps``/``topks``/``seeds``/
    ``counts`` are host sequences.  Returns [B] int64 on the logits'
    device.  Only the sampling rows are drawn, and the top-k sort runs
    only when one of them sets a k."""
    dev = logits.device
    logits = logits.to(torch.float32)
    tokens = torch.argmax(logits, dim=-1)
    temps = numpy.asarray(temps, numpy.float32)
    rows = numpy.flatnonzero(temps > 0)
    if not rows.size:
        return tokens
    topks = numpy.asarray(topks, numpy.int64)[rows]
    idx = torch.as_tensor(rows, device=dev)
    z = logits[idx] / torch.as_tensor(numpy.maximum(temps[rows], 1e-6),
                                      device=dev)[:, None]
    if (topks > 0).any():
        v = z.shape[-1]
        kth = torch.sort(z, dim=-1).values.gather(-1, torch.as_tensor(
            numpy.clip(v - topks, 0, v - 1), device=dev)[:, None])
        keep_all = torch.as_tensor(topks <= 0, device=dev)[:, None]
        z = z.masked_fill(~keep_all & (z < kth), float("-inf"))
    keys = _fold_keys(numpy.asarray(seeds)[rows],
                      numpy.asarray(counts)[rows], dev)
    return tokens.index_copy(0, idx, threefry.categorical(keys, z))


def sample_first(logits, temps, topks, seeds, counts):
    """Post-prefill sampler: draw ``counts[n]`` of each request's
    stream from its last-position logits."""
    return sample_slots(logits, temps, topks, seeds, counts)


def first_tokens(last_logits, temps, topks, seeds, counts=None):
    """Sample each admitted request's first token from its prefill
    logits ([k, vocab] f32); ``counts`` defaults to 0 (a fresh
    admission).  Returns a host numpy array."""
    if counts is None:
        counts = [0] * len(seeds)
    logits = torch.as_tensor(last_logits, dtype=torch.float32)
    return sample_first(logits, list(temps), list(topks), list(seeds),
                        list(counts)).cpu().numpy()


def hidden_supported(forwards):
    """True when the chain ends in a position-wise vocab head over a
    [batch, seq, d] hidden stream: the ``want_hidden`` lane returns the
    input of that final unit."""
    if len(forwards) < 2:
        return False
    last = forwards[-1]
    return getattr(last, "DECODE_POINTWISE", False) \
        and not hasattr(last, "init_cache")


def _ints(a, dtype, device):
    return torch.as_tensor(numpy.asarray(a, dtype), device=device)


def slot_decode_logits(forwards, cache, toks, pos):
    """The chain's forward of ONE dense decode step over every slot of
    ``cache`` (:class:`~veles_tpu_torch.serving.kv_slots.SlotKVCache`,
    whose rows update in place): ``toks`` [S, 1] each slot's last token
    at ``pos`` [S] — host arrays.  Returns the [S, vocab] f32 logits on
    the cache's device."""
    h = _ints(toks, numpy.int64, cache.device)
    pos_t = _ints(pos, numpy.int64, cache.device)
    for i, u in enumerate(forwards):
        if i in cache.caches:
            h, cache.caches[i] = u.apply_step_slots(h, pos_t,
                                                    cache.caches[i])
        elif hasattr(u, "apply_step_slots"):
            h = u.apply_step_slots(h, pos_t)
        else:
            h = u.apply(h)
    return h[:, 0].to(torch.float32)


def slot_decode_step(forwards, cache, toks, pos, temps, topks, seeds,
                     counts):
    """Run ONE dense decode step (:func:`slot_decode_logits`; free slots
    decode garbage rows) and sample each row with its settings
    ``temps``/``topks`` and the draw ``counts[n]`` of stream
    ``seeds[n]`` (host arrays [S]).  Returns the [S] next tokens as a
    host numpy array."""
    logits = slot_decode_logits(forwards, cache, toks, pos)
    return sample_slots(logits, list(numpy.asarray(temps)),
                        list(numpy.asarray(topks)),
                        list(numpy.asarray(seeds)),
                        list(numpy.asarray(counts))).cpu().numpy()


def _per_position(ctx, *arrays):
    """Each host array as one tensor per tp position (on its device)."""
    return [[torch.as_tensor(a, device=d) for d in ctx.devices]
            for a in arrays]


def _other_step(i, u, h, pos_t, verify):
    if verify and hasattr(u, "apply_verify_slots"):
        return u.apply_verify_slots(h, pos_t)
    if not verify and hasattr(u, "apply_step_slots"):
        return u.apply_step_slots(h, pos_t)
    return u.apply(h)


def paged_decode_logits(forwards, cache, toks, pos, tables,
                        want_hidden=False):
    """The chain's forward of ONE decode step over a packed batch
    against ``cache`` (:class:`~veles_tpu_torch.serving.kv_slots.
    PagedKVCache`, whose pools update in place).  ``toks`` [B, 1],
    ``pos`` [B], ``tables`` [B, T] (T·block_size covers ``max(pos) +
    1``) — host arrays.  Returns the [B, vocab] f32 logits on the
    cache's device, and with ``want_hidden`` the [B, d] f32 input of
    the final unit beside them."""
    device = cache.device
    h = _ints(toks, numpy.int64, device)
    pos_t = _ints(pos, numpy.int64, device)
    tables_t = _ints(tables, numpy.int32, device)
    ctx = getattr(cache, "tp_", None)
    if ctx is not None:
        pos_p, tab_p = _per_position(ctx, numpy.asarray(pos, numpy.int64),
                                     numpy.asarray(tables, numpy.int32))
        h, hid = ctx.run_chain(
            forwards, h,
            lambda i, u, views, xs: u.apply_step_paged_tp(
                views, xs, pos_p, tab_p, cache.pools[i]),
            lambda i, u, x: _other_step(i, u, x, pos_t, False),
            want_hidden)
        logits = h[:, 0].to(torch.float32)
        return (logits, hid[:, 0]) if want_hidden else logits
    hid = None
    last = len(forwards) - 1
    for i, u in enumerate(forwards):
        if want_hidden and i == last:
            hid = h[:, 0].to(torch.float32)
        if i in cache.pools:
            h, cache.pools[i] = u.apply_step_paged(h, pos_t, tables_t,
                                                   cache.pools[i])
        elif hasattr(u, "apply_step_slots"):
            h = u.apply_step_slots(h, pos_t)
        else:
            h = u.apply(h)
    logits = h[:, 0].to(torch.float32)
    return (logits, hid) if want_hidden else logits


def paged_decode_step(forwards, cache, toks, pos, tables, temps, topks,
                      seeds, counts, want_hidden=False):
    """Run ONE decode step (:func:`paged_decode_logits`) and sample
    each row with its settings ``temps``/``topks``/``seeds``/
    ``counts`` [B] (host arrays).  Returns the [B] next tokens as a
    host numpy array, and with ``want_hidden`` also the [B, d] f32
    hidden states (on the device)."""
    got = paged_decode_logits(forwards, cache, toks, pos, tables,
                              want_hidden=want_hidden)
    logits, hid = got if want_hidden else (got, None)
    nxt = sample_slots(logits, list(numpy.asarray(temps)),
                       list(numpy.asarray(topks)),
                       list(numpy.asarray(seeds)),
                       list(numpy.asarray(counts))).cpu().numpy()
    return (nxt, hid) if want_hidden else nxt


def verify_logits(forwards, cache, toks, pos, lens, tables,
                  fused_verify=False, want_hidden=False):
    """The chain's forward of ONE verify pass over a packed batch
    against ``cache`` (pools updated in place): ``toks`` [B, K1] — row
    n's pending token then its drafts, padded past ``lens[n]``; ``pos``
    [B] the pending token's position; ``lens`` [B] real positions per
    row; ``tables`` [B, T] (T·block_size covers ``max(pos + lens)``) —
    host arrays.  ``fused_verify`` takes the single-pass verify over
    fp32 pools.  Returns the [B, K1, vocab] f32 logits on the cache's
    device, and with ``want_hidden`` the [B, K1, d] f32 input of the
    final unit beside them."""
    device = cache.device
    h = _ints(toks, numpy.int64, device)
    pos_t = _ints(pos, numpy.int64, device)
    lens_t = _ints(lens, numpy.int64, device)
    tables_t = _ints(tables, numpy.int32, device)
    ctx = getattr(cache, "tp_", None)
    if ctx is not None:
        pos_p, lens_p, tab_p = _per_position(
            ctx, numpy.asarray(pos, numpy.int64),
            numpy.asarray(lens, numpy.int64),
            numpy.asarray(tables, numpy.int32))
        h, hid = ctx.run_chain(
            forwards, h,
            lambda i, u, views, xs: u.apply_verify_paged_tp(
                views, xs, pos_p, lens_p, tab_p, cache.pools[i],
                fused_verify=fused_verify),
            lambda i, u, x: _other_step(i, u, x, pos_t, True),
            want_hidden)
        logits = h.to(torch.float32)
        return (logits, hid) if want_hidden else logits
    hid = None
    last = len(forwards) - 1
    for i, u in enumerate(forwards):
        if want_hidden and i == last:
            hid = h.to(torch.float32)
        if i in cache.pools:
            h, cache.pools[i] = u.apply_verify_paged(
                h, pos_t, lens_t, tables_t, cache.pools[i],
                fused_verify=fused_verify)
        elif hasattr(u, "apply_verify_slots"):
            h = u.apply_verify_slots(h, pos_t)
        else:
            h = u.apply(h)
    logits = h.to(torch.float32)
    return (logits, hid) if want_hidden else logits


def verify_step_paged(forwards, cache, toks, pos, lens, tables, temps,
                      topks, seeds, counts, fused_verify=False,
                      want_hidden=False):
    """Run ONE verify pass (:func:`verify_logits`) and sample every
    position: entry (n, j) is drawn as a sequential decode of row n's
    context extended by its first j drafts would draw it — greedy rows
    take the argmax, sampling rows the key ``fold_in(key(seeds[n]),
    counts[n] + j)``.  ``counts`` [B] is the draw counter of each row's
    first sampled token.  Returns the [B, K1] tokens as a host numpy
    array; the caller accepts the matched prefix
    (:func:`~veles_tpu_torch.serving.spec.accept_drafts`).  With
    ``want_hidden`` also the [B, K1, d] f32 hidden states (on the
    device): after accepting L tokens of row n, row n's position L - 1
    is the hidden the draft head reads next."""
    got = verify_logits(forwards, cache, toks, pos, lens, tables,
                        fused_verify=fused_verify, want_hidden=want_hidden)
    logits, hid = got if want_hidden else (got, None)
    b, k1, vocab = logits.shape

    def rows(a):
        return list(numpy.repeat(numpy.asarray(a), k1))

    draws = (numpy.asarray(counts, numpy.int64)[:, None]
             + numpy.arange(k1)[None, :]).reshape(-1)
    nxt = sample_slots(logits.reshape(b * k1, vocab), rows(temps),
                       rows(topks), rows(seeds), list(draws))
    nxt = nxt.reshape(b, k1).cpu().numpy()
    return (nxt, hid) if want_hidden else nxt


def verify_supported(forwards):
    """True when every cacheable block speaks the paged verify step and
    every other sequence-positioned unit can place a width-K1 run (or
    is position-wise) — the gate speculative decoding checks."""
    has = False
    for u in forwards:
        if hasattr(u, "init_cache"):
            has = True
            if not hasattr(u, "apply_verify_paged"):
                return False
        elif hasattr(u, "apply_step_slots") \
                and not hasattr(u, "apply_verify_slots"):
            return False
    return has
