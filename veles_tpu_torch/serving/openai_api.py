"""The compute half of the OpenAI-compatible facade — the port of
``veles_tpu/serving/openai_api.py`` (``:61-183``): pooled embeddings
(``/v1/embeddings``) and last-position class scores (``/v1/classify``),
which the scheduler runs on its aux lane (``submit_embed``,
``submit_score``).  Both run the chain's prefill path (plain ops: no
kernel launches on the card).  The request parsing and reply helpers
come with the REST layer.
"""

import numpy
import torch

from veles_tpu_torch.models.generate import _check_positions
from veles_tpu_torch.serving.prefill import prefill, serving_supported


def _bucket(n, floor=1):
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


def embed_supported(forwards):
    """True when the chain can answer ``/v1/embeddings``: a prefill-
    capable chain with a distinct head unit to strip (the pooled states
    come from the layer UNDER the logits projection)."""
    return len(forwards) >= 2 and serving_supported(forwards)


def embed_pool(forwards, prompt, prompt_lens):
    """Pooled embeddings for ``prompt`` [b, P] ints (front-aligned rows,
    ``prompt_lens`` [b] real lengths): one prefill pass through the
    chain's hidden layers (the logits head skipped), the mean of each
    row's real positions in f32, L2-normalized: [b, d] f32 on the
    chain's device."""
    if not embed_supported(forwards):
        raise ValueError("chain cannot serve embeddings (needs a "
                         "prefill-capable chain with a head unit)")
    device = forwards[0].device
    prompt = torch.as_tensor(numpy.asarray(prompt, numpy.int64),
                             device=device)
    b, p = prompt.shape
    _check_positions(forwards, p)
    lens_np = numpy.asarray(prompt_lens, numpy.int64)
    if lens_np.shape != (b,) or lens_np.min() < 1 or lens_np.max() > p:
        raise ValueError("prompt_lens must be [batch] ints in [1, %d]" % p)
    lens = torch.as_tensor(lens_np, device=device)
    h = prompt
    with torch.no_grad():
        for u in forwards[:-1]:
            if hasattr(u, "init_cache"):
                h, _ = u.apply_prefill(h, u.init_cache(b, p, u.dtype),
                                       lens=lens)
            else:
                h = u.apply(h)
        # padding positions must not dilute the vector
        mask = (torch.arange(p, device=device)[None, :]
                < lens[:, None]).to(torch.float32)
        pooled = (h.to(torch.float32) * mask[:, :, None]).sum(1) \
            / torch.clamp(lens, min=1).to(torch.float32)[:, None]
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)


def _pad_rows(rows, width_cap):
    """Front-aligned [b_bucket, p_bucket] padding of ragged token rows:
    both axes power-of-two bucketed, width capped at the serving
    window."""
    lens = [len(r) for r in rows]
    width = min(_bucket(max(lens), 8), int(width_cap))
    b = _bucket(len(rows), 1)
    padded = numpy.zeros((b, width), numpy.int32)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    lens_arr = numpy.ones((b,), numpy.int32)
    lens_arr[:len(rows)] = lens
    return padded, lens_arr


def pooled_embeddings(forwards, rows, window):
    """Batched ``/v1/embeddings`` execution: bucket + pad the rows, one
    :func:`embed_pool` pass, unpadded [n, d] float lists back."""
    padded, lens = _pad_rows(rows, window)
    out = embed_pool(forwards, padded, lens).cpu().numpy()
    return [out[i].tolist() for i in range(len(rows))]


def score_rows(forwards, rows, window):
    """Batched ``/v1/classify`` execution: the last-position logits of
    each row through the FULL chain, log-softmaxed on the host in f64
    to per-class log-probabilities [n, classes]."""
    padded, lens = _pad_rows(rows, window)
    with torch.no_grad():
        _, last = prefill(forwards, padded, prompt_lens=lens,
                          window=padded.shape[1])
    logits = last.cpu().numpy().astype(numpy.float64)[:len(rows)]
    z = logits - logits.max(axis=-1, keepdims=True)
    return z - numpy.log(numpy.exp(z).sum(axis=-1, keepdims=True))
