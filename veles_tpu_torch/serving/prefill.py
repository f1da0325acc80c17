"""Batched and chunked prompt prefill — the port of
``veles_tpu/serving/prefill.py``.

:func:`prefill` runs the chain once over whole prompts and writes every
cacheable block's K/V rows in that pass; :func:`prefill_chunk` runs one
chunk of a prompt into existing staging caches (Sarathi-style chunked
prefill).  Both return the f32 logits at each row's last prompt
position.  PyTorch runs eagerly, so there is no executable cache to
key: the JAX package's per-shape compile caches have no counterpart.
``tp`` (a :class:`~veles_tpu_torch.serving.tp.ServingTP`) runs the pass
over the tensor-parallel positions: each block's shards write their
heads' columns of the whole-width staging caches.
"""

import numpy
import torch

from veles_tpu_torch.models.generate import kv_cache_eligible


def serving_supported(forwards):
    """True when the chain can serve through the scheduler: kv-cache
    eligible (``models.generate.kv_cache_eligible``), every cacheable
    block speaks a batched prefill and the per-slot step
    (``apply_step_slots``), and every other unit with a single-token
    step is position-wise or has a per-slot one.  The paged layout
    needs ``apply_step_paged`` besides (``kv_slots.paged_supported``)."""
    if not kv_cache_eligible(forwards):
        return False
    has_cache = False
    for u in forwards:
        if hasattr(u, "init_cache"):
            has_cache = True
            if not hasattr(u, "apply_prefill") \
                    or not hasattr(u, "apply_step_slots"):
                return False
        elif hasattr(u, "apply_step") \
                and not getattr(u, "DECODE_POINTWISE", False) \
                and not hasattr(u, "apply_step_slots"):
            return False
    return has_cache


def serving_window(forwards):
    """The widest window the chain supports: the smallest learned
    positional table in it (None when nothing bounds the length)."""
    best = None
    for u in forwards:
        n = getattr(u, "window", None)
        if n:
            best = n if best is None else min(best, n)
    return best


def chunked_supported(forwards):
    """True when every cacheable block continues from an offset and
    every other positioned unit speaks chunk offsets."""
    has = False
    for u in forwards:
        if hasattr(u, "init_cache"):
            has = True
            if not hasattr(u, "apply_prefill_chunk"):
                return False
        elif getattr(u, "window", None) and not hasattr(u, "apply_chunk"):
            return False
    return has


def _device(forwards):
    return forwards[0].device


def _lens(lens, b, hi, what, device):
    lens_np = numpy.asarray(lens, numpy.int64)
    if lens_np.shape != (b,):
        raise ValueError("%s must be [batch] ints" % what)
    if lens_np.min() < 1 or lens_np.max() > hi:
        raise ValueError("%s must be in [1, %d]" % (what, hi))
    return torch.as_tensor(lens_np, device=device)


def _last(h, lens):
    idx = (lens - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return torch.gather(h, 1, idx)[:, 0].to(torch.float32)


def prefill(forwards, prompt, prompt_lens=None, window=None, tp=None):
    """Prefill ``prompt`` [batch, P] (front-aligned rows) in one pass.

    Returns ``(caches, last_logits)``: ``caches`` maps the chain index
    of every cacheable block to ``{"k", "v"}`` [batch, window, d] with
    rows [0, lens[n]) holding the prompt's K/V and later rows zero;
    ``last_logits`` [batch, vocab] f32 at each row's position
    ``lens[n] - 1``.  ``window`` (default P) sizes the caches."""
    for u in forwards:
        if hasattr(u, "init_cache") and not hasattr(u, "apply_prefill"):
            raise ValueError("batched prefill: %s has no apply_prefill"
                             % type(u).__name__)
    device = _device(forwards)
    prompt = torch.as_tensor(numpy.asarray(prompt, numpy.int64),
                             device=device)
    b, p = prompt.shape
    window = int(window or p)
    if window < p:
        raise ValueError("window %d < prompt width %d" % (window, p))
    bound = serving_window(forwards)
    if bound is not None and p > bound:
        raise ValueError("prompt width %d exceeds the positional table "
                         "(%d)" % (p, bound))
    lens = torch.full((b,), p, dtype=torch.int64, device=device) \
        if prompt_lens is None \
        else _lens(prompt_lens, b, p, "prompt_lens", device)
    caches = {}
    if tp is not None:
        for i, u in enumerate(forwards):
            if hasattr(u, "init_cache"):
                caches[i] = u.init_cache(b, window, u.dtype)
        h, _ = tp.run_chain(
            forwards, prompt,
            lambda i, u, views, xs: u.apply_prefill_chunk_tp(
                views, xs, caches[i], 0, lens, key_width=p)[0],
            lambda i, u, x: u.apply(x))
        return caches, _last(h, lens)
    h = prompt
    for i, u in enumerate(forwards):
        if hasattr(u, "init_cache"):
            caches[i] = u.init_cache(b, window, u.dtype)
            h, caches[i] = u.apply_prefill(h, caches[i], lens=lens)
        else:
            h = u.apply(h)
    return caches, _last(h, lens)


def prefill_chunk(forwards, chunk, offset, chunk_lens, caches,
                  key_width=None, tp=None):
    """Prefill ONE chunk — ``chunk`` [batch, C] tokens at positions
    [offset, offset+C) — into staging ``caches`` ({index: {"k", "v"}
    [batch, W, d]}, W a multiple of C, zero past every written row).
    ``chunk_lens`` [batch]: how much of the chunk each row covers;
    ``key_width`` (default W) bounds the attended keys.  Returns
    ``(caches, last_logits)``; the chunks in order reproduce
    :func:`prefill`."""
    if not chunked_supported(forwards):
        raise ValueError("chain cannot prefill in chunks (see "
                         "chunked_supported)")
    device = _device(forwards)
    chunk = torch.as_tensor(numpy.asarray(chunk, numpy.int64),
                            device=device)
    b, c = chunk.shape
    widths = {a.shape[1] for layer in caches.values()
              for a in layer.values()}
    if len(widths) != 1:
        raise ValueError("staging caches disagree on width")
    w = widths.pop()
    if w % c or offset % c or offset + c > w:
        raise ValueError("chunk [%d, %d) must tile the staging width %d"
                         % (offset, offset + c, w))
    kw = int(key_width or w)
    if kw > w or kw < min(offset + c, w):
        raise ValueError("key_width %d outside [%d, %d]"
                         % (kw, offset + c, w))
    lens = _lens(chunk_lens, b, c, "chunk_lens", device)
    out = dict(caches)
    if tp is not None:
        h, _ = tp.run_chain(
            forwards, chunk,
            lambda i, u, views, xs: u.apply_prefill_chunk_tp(
                views, xs, caches[i], offset, chunk_lens=lens,
                key_width=kw)[0],
            lambda i, u, x: u.apply_chunk(x, offset)
            if hasattr(u, "apply_chunk") else u.apply(x))
        return out, _last(h, lens)
    h = chunk
    for i, u in enumerate(forwards):
        if hasattr(u, "init_cache"):
            h, out[i] = u.apply_prefill_chunk(h, caches[i], offset,
                                              chunk_lens=lens,
                                              key_width=kw)
        elif hasattr(u, "apply_chunk"):
            h = u.apply_chunk(h, offset)
        else:
            h = u.apply(h)
    return out, _last(h, lens)
