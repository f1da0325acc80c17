"""Autoregressive decoding outside the scheduler — the port of
``veles_tpu/models/generate.py``.

:func:`generate` decodes ``steps`` tokens after a batch of prompts on a
fixed-length token buffer ``[batch, prompt_len + steps]`` in one of
the reference's four forms, each started where the reference's scan
starts it:

- rescan (``kv_cache=False``): every step reruns the whole chain
  (``unit.apply``) over the buffer, whose tail past the cursor holds
  zeros that causal attention keeps away from every read position;
  from ``prompt_len`` for ``steps`` steps.  On the card a bf16 block at
  head dim 128 or 256 runs the FlashAttention forward kernel here;
- kv (``kv_cache=True``): one batched prefill over the prompt's
  predecessors fills per-block K/V caches, then single-token steps
  (``apply_step``) from ``prompt_len - 1``;
- kv, variable length (``prompt_lens``): single-token steps from 0 for
  ``total - 1`` steps, no prefill; a row's prompt tokens pass through
  and its padding is overwritten as the cursor reaches it;
- rescan, variable length: from ``min(prompt_lens) - 1`` for ``total -
  min(prompt_lens)`` steps.

Each sampled step splits the key once (``k, sub = split(k)``), so the
four forms draw different sampled streams, as in the reference (a
greedy step reads no key and skips its split).  Sampling
draws ONE Gumbel array ``[batch, vocab]`` from ``sub``
(``jax.random.categorical``'s draw), not a key per row.
:func:`generate_beam` is the beam search over the kv path.

Decoding runs eagerly under ``torch.no_grad()``: PyTorch has no
executable to cache, so the reference's compile caches
(``_decode_cached*``, ``clear_decode_caches``) have no counterpart.
The PRNG key is :func:`veles_tpu_torch.prng.threefry.key`'s ``[2]``
words, whose bits equal ``jax.random.key(seed)``'s.
"""

import numpy
import torch

from veles_tpu_torch.prng import threefry


def _chain_logits(forwards, tokens):
    h = tokens
    for u in forwards:
        h = u.apply(h)
    return h


def _chain_step(forwards, tok, pos, caches):
    """One-token forward with per-block K/V caches (written in place):
    tok [batch, 1] at sequence index ``pos`` → [batch, 1, vocab]."""
    h = tok
    for i, u in enumerate(forwards):
        if hasattr(u, "init_cache"):
            h, caches[i] = u.apply_step(h, pos, caches[i])
        elif hasattr(u, "apply_step"):
            h = u.apply_step(h, pos)
        else:
            h = u.apply(h)
    return h


def _check_positions(forwards, total):
    for u in forwards:
        table = getattr(u, "params", {}).get("positions")
        if table is not None and table.dim() == 2 \
                and total > table.shape[0]:
            raise ValueError(
                "prompt_len + steps = %d exceeds the model's learned "
                "positional table (%d — the training sequence length)"
                % (total, table.shape[0]))


def _fill_caches(forwards, buf, p_len, caches):
    """Write every cacheable block's K/V rows over the prompt's
    predecessors [0, p_len - 1) in one batched prefill, running the
    chain up to its last cacheable block."""
    if p_len <= 1 or not caches:
        return
    h = buf[:, :p_len - 1]
    for i, u in enumerate(forwards[:max(caches) + 1]):
        if i in caches:
            h, caches[i] = u.apply_prefill(h, caches[i])
        else:
            h = u.apply(h)


def _init_caches(forwards, b, total):
    return {i: u.init_cache(b, total, u.dtype)
            for i, u in enumerate(forwards) if hasattr(u, "init_cache")}


def kv_cache_eligible(forwards):
    """True when :func:`generate` can decode this chain with
    ``kv_cache=True``: every cacheable block is causal and every other
    unit either has a single-token step or is position-wise."""
    for u in forwards:
        if hasattr(u, "init_cache"):
            if not u.causal:
                return False
        elif not hasattr(u, "apply_step") \
                and not getattr(u, "DECODE_POINTWISE", False):
            return False
    return True


def generate(forwards, prompt, steps, temperature=0.0, top_k=0,
             key=None, kv_cache=False, prompt_lens=None,
             stop_token=None):
    """Decode ``steps`` tokens after ``prompt`` [batch, prompt_len] (ints)
    through a chain ending in per-token logits.

    - ``temperature`` 0 → greedy argmax; otherwise categorical sampling
      of logits / temperature with ``key`` (a ``threefry.key``);
    - ``top_k`` > 0 keeps the k most likely tokens (ties with the k-th
      stay in);
    - ``kv_cache`` → single-token steps against per-block K/V caches;
    - ``prompt_lens`` ([batch] ints): row n's prompt is its first
      ``prompt_lens[n]`` positions; every row decodes to the buffer end;
    - ``stop_token``: a row that GENERATES it repeats it from then on.

    Returns the [batch, prompt_len + steps] int64 tokens on the chain's
    device."""
    device = forwards[0].device
    prompt = torch.as_tensor(numpy.asarray(prompt, numpy.int64),
                             device=device)
    b, p_len = prompt.shape
    total = p_len + int(steps)
    lens = None
    if prompt_lens is not None:
        lens_np = numpy.asarray(prompt_lens, numpy.int64)
        if lens_np.shape != (b,):
            raise ValueError("prompt_lens must be [batch] ints")
        if lens_np.min() < 1 or lens_np.max() > p_len:
            raise ValueError(
                "prompt_lens must be in [1, %d] (the prompt width)" % p_len)
        lens = torch.as_tensor(lens_np, device=device)
    if temperature and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    k = threefry.key(0, device) if key is None \
        else torch.as_tensor(key, device=device).to(torch.int64)
    _check_positions(forwards, total)
    vocab = getattr(forwards[-1], "vocab", None)
    if top_k and vocab is not None and int(top_k) > int(vocab):
        raise ValueError("top_k %d > vocab %d" % (top_k, vocab))
    if top_k and not temperature:
        raise ValueError(
            "top_k only applies to sampling — set temperature > 0 "
            "(greedy ignores it)")
    if kv_cache:
        for u in forwards:
            if hasattr(u, "init_cache"):
                if not u.causal:
                    raise ValueError(
                        "kv_cache decoding needs causal blocks — a "
                        "non-causal block's past outputs change when "
                        "future tokens arrive, so single-token steps "
                        "cannot reproduce them")
            elif not hasattr(u, "apply_step") \
                    and not getattr(u, "DECODE_POINTWISE", False):
                raise ValueError(
                    "kv_cache decoding: %s has no apply_step and is not "
                    "position-wise — use kv_cache=False for this chain"
                    % type(u).__name__)

    def sample(logits):
        # one key split per step; a greedy step reads no key, so its
        # split is skipped (the host dispatches ~150 small ops for one)
        nonlocal k
        logits = logits.to(torch.float32)
        if not temperature:
            return torch.argmax(logits, dim=-1)
        k, sub = threefry.split(k, 2)
        z = logits / float(temperature)
        if top_k:
            kth = torch.sort(z, dim=-1).values[:, -int(top_k)][:, None]
            z = z.masked_fill(z < kth, float("-inf"))
        return torch.argmax(threefry.gumbel(sub, tuple(z.shape)) + z, dim=-1)

    def freeze(nxt, consumed, consumed_pos, gen_start):
        # a row whose consumed token was a GENERATED stop token repeats
        # it (prompt occurrences never freeze a row)
        if stop_token is None:
            return nxt
        frozen = (consumed == int(stop_token)) & torch.as_tensor(
            consumed_pos >= gen_start, device=device)
        return torch.where(frozen, torch.full_like(nxt, int(stop_token)),
                           nxt)

    def write(buf, pos, nxt):
        # variable length: only rows whose prompt has ended take the
        # sample; prompt tokens pass through
        if lens is not None:
            nxt = torch.where(pos >= lens, nxt, buf[:, pos])
        buf[:, pos] = nxt

    with torch.no_grad():
        buf = torch.zeros((b, total), dtype=torch.int64, device=device)
        buf[:, :p_len] = prompt
        gen_start = p_len if lens is None else lens
        if kv_cache:
            caches = _init_caches(forwards, b, total)
            if lens is None:
                _fill_caches(forwards, buf, p_len, caches)
                start, n = p_len - 1, int(steps)
            else:
                start, n = 0, total - 1
            for pos in range(start, start + n):
                tok = buf[:, pos:pos + 1]
                logits = _chain_step(forwards, tok, pos, caches)
                nxt = freeze(sample(logits[:, 0]), tok[:, 0], pos, gen_start)
                write(buf, pos + 1, nxt)
            return buf
        # rescan: the logits at the cursor's predecessor predict it
        if lens is None:
            start, n = p_len - 1, int(steps)
        else:
            vmin = int(lens_np.min())
            start, n = vmin - 1, total - vmin
        for pos in range(start, start + n):
            row = _chain_logits(forwards, buf)[:, pos]
            nxt = freeze(sample(row), buf[:, pos], pos, gen_start)
            write(buf, pos + 1, nxt)
        return buf


def generate_beam(forwards, prompt, steps, beam):
    """Beam-search decode over the kv path: keep the ``beam`` highest
    cumulative-log-probability continuations each step; the caches hold
    ``batch·beam`` rows, regathered to each step's parents.

    Returns ``(tokens, scores)``: tokens [batch, beam, prompt_len +
    steps] best first, scores [batch, beam] f32, the cumulative log-prob
    of each generated region.  Candidates are ranked as
    ``jax.lax.top_k`` ranks them: by value, the lower flat index first
    among equals (a stable descending sort).  ``beam=1`` equals greedy
    :func:`generate`."""
    if not kv_cache_eligible(forwards):
        raise ValueError(
            "beam search decodes on the kv-cache path — this chain is not "
            "cacheable (see kv_cache_eligible)")
    beam = int(beam)
    if beam < 1:
        raise ValueError("beam must be >= 1")
    device = forwards[0].device
    prompt = torch.as_tensor(numpy.asarray(prompt, numpy.int64),
                             device=device)
    b, p_len = prompt.shape
    total = p_len + int(steps)
    _check_positions(forwards, total)
    vocab = getattr(forwards[-1], "vocab", None)
    if vocab is not None and beam > int(vocab):
        raise ValueError("beam %d > vocab %d" % (beam, vocab))
    with torch.no_grad():
        buf = torch.zeros((b, total), dtype=torch.int64, device=device)
        buf[:, :p_len] = prompt
        caches = _init_caches(forwards, b, total)
        _fill_caches(forwards, buf, p_len, caches)
        # tile beam-ways: row n's copies are rows n·beam .. n·beam+beam-1
        bufs = buf[:, None, :].repeat(1, beam, 1)
        for i, c in caches.items():
            caches[i] = {n: t.repeat_interleave(beam, dim=0)
                         for n, t in c.items()}
        scores = torch.zeros((b, beam), dtype=torch.float32, device=device)
        # the first expansion starts from `beam` identical rows: all but
        # row 0 are masked, or the top-k would pick one token k times
        dup_pen = torch.zeros((1, beam, 1), dtype=torch.float32,
                              device=device)
        dup_pen[:, 1:] = float("-inf")
        for pos in range(p_len - 1, p_len - 1 + int(steps)):
            tok = bufs[:, :, pos].reshape(b * beam, 1)
            logits = _chain_step(forwards, tok, pos, caches)
            logp = torch.log_softmax(logits[:, 0].to(torch.float32),
                                     dim=-1).reshape(b, beam, -1)
            cand = scores[:, :, None] + logp
            if pos == p_len - 1:
                cand = cand + dup_pen
            nv = cand.shape[-1]
            ranked = torch.sort(cand.reshape(b, beam * nv), dim=-1,
                                descending=True, stable=True)
            scores = ranked.values[:, :beam]
            flat = ranked.indices[:, :beam]
            parent = flat // nv
            bufs = torch.gather(bufs, 1, parent[:, :, None].expand(
                -1, -1, total)).clone()
            bufs[:, :, pos + 1] = flat % nv
            rows = (parent + beam * torch.arange(
                b, device=device)[:, None]).reshape(-1)
            for i, c in caches.items():
                caches[i] = {n: t[rows] for n, t in c.items()}
        return bufs, scores
