"""The shared decode step over serving slots — the port of
``veles_tpu/serving/engine.py`` (paged path).

:func:`paged_decode_step` advances a PACKED batch of active slots one
token: the scheduler pads the active slots to a power-of-two occupancy
bucket ``B`` and bounds the attended range by a power-of-two block
bucket ``T`` over the deepest slot.  Padding rows (token 0, position 0,
an all-zero table) write into and read from the trash block.

Sampling is row-wise.  Greedy rows (temperature 0) take the argmax —
the same token the JAX package picks from the same logits.  Sampling
rows draw from a per-request ``torch.Generator`` seeded from
``(seed, count)``, so a request's stream is reproducible per seed
whatever slot or batch it rides — but it is NOT the JAX package's
threefry stream (``fold_in(key(seed), count)``); seeded streams of the
two packages differ.
"""

import numpy
import torch


def _generator(device, seed, count):
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                  | (int(count) & 0xFFFFFFFF))
    return g


def sample_slots(logits, temps, topks, seeds, counts):
    """Per-row next-token sampler over ``logits`` [B, vocab] f32:
    rows with ``temps[n] == 0`` take the greedy argmax; sampling rows
    draw categorical(logits / temp) restricted to the row's top-k
    (0 = full vocab; ties with the k-th value stay in), from the
    generator of ``(seeds[n], counts[n])``.  ``temps``/``topks``/
    ``seeds``/``counts`` are host sequences.  Returns [B] int64 on
    the logits' device."""
    out = torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    for n, temp in enumerate(temps):
        if temp <= 0:
            continue
        z = logits[n].to(torch.float32) / max(float(temp), 1e-6)
        k = int(topks[n])
        if k > 0:
            kth = torch.sort(z).values[max(v - k, 0)]
            z = z.masked_fill(z < kth, float("-inf"))
        probs = torch.softmax(z, dim=-1)
        out[n] = torch.multinomial(
            probs, 1, generator=_generator(z.device, seeds[n],
                                           counts[n]))[0]
    return out


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


def paged_decode_logits(forwards, cache, toks, pos, tables):
    """The chain's forward of ONE decode step over a packed batch
    against ``cache`` (:class:`~veles_tpu_torch.serving.kv_slots.
    PagedKVCache`, whose pools update in place).  ``toks`` [B, 1],
    ``pos`` [B], ``tables`` [B, T] (T·block_size covers ``max(pos) +
    1``) — host arrays.  Returns the [B, vocab] f32 logits on the
    cache's device."""
    device = cache.device
    h = torch.as_tensor(numpy.asarray(toks, numpy.int64), device=device)
    pos_t = torch.as_tensor(numpy.asarray(pos, numpy.int64), device=device)
    tables_t = torch.as_tensor(numpy.asarray(tables, numpy.int32),
                               device=device)
    for i, u in enumerate(forwards):
        if i in cache.pools:
            h, cache.pools[i] = u.apply_step_paged(h, pos_t, tables_t,
                                                   cache.pools[i])
        elif hasattr(u, "apply_step_slots"):
            h = u.apply_step_slots(h, pos_t)
        else:
            h = u.apply(h)
    return h[:, 0].to(torch.float32)


def paged_decode_step(forwards, cache, toks, pos, tables, temps, topks,
                      seeds, counts):
    """Run ONE decode step (:func:`paged_decode_logits`) and sample
    each row with its settings ``temps``/``topks``/``seeds``/
    ``counts`` [B] (host arrays).  Returns the [B] next tokens as a
    host numpy array."""
    logits = paged_decode_logits(forwards, cache, toks, pos, tables)
    return sample_slots(logits, list(numpy.asarray(temps)),
                        list(numpy.asarray(topks)),
                        list(numpy.asarray(seeds)),
                        list(numpy.asarray(counts))).cpu().numpy()
