"""The OpenAI-compatible facade — the port of
``veles_tpu/serving/openai_api.py``.

The compute half: pooled embeddings (``/v1/embeddings``) and
last-position class scores (``/v1/classify``), which the scheduler runs
on its aux lane (``submit_embed``, ``submit_score``).  Both run the
chain's prefill path (plain ops: no kernel launches on the card).

The wire half, which :mod:`veles_tpu_torch.restful_api` calls: request
parsing (:func:`parse_token_rows`, :func:`parse_completions`, raising
``ValueError`` with the reference's client-facing messages — HTTP 400
material) and reply shaping (``/v1/completions`` replies and SSE
chunks, ``/v1/models``, ``/v1/embeddings``, ``/v1/classify``).  The
engine is tokenizer-free: clients send token ids, and a choice's
``text`` is its token ids as space-separated decimals beside the
non-standard ``tokens`` list.  The model name is an argument (default
:data:`MODEL_ID`, the reference's ``root.common.api.model_id``).  Every
reply holds plain Python ints, floats and lists: tensors and numpy
arrays are converted before shaping.
"""

import os
import time

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


# -- request parsing ----------------------------------------------------------

#: the model name ``/v1/*`` serves under unless given another
MODEL_ID = "veles-lm"


def model_id(name=None):
    """The model name ``/v1/*`` serves under: ``name``, else
    :data:`MODEL_ID`."""
    return str(name or MODEL_ID)


def parse_token_rows(raw, what="prompt"):
    """An OpenAI prompt/input: one token row or a batch of rows → (list
    of non-empty int lists, whether ``raw`` was a single row).  Raises
    ``ValueError`` on anything else — silently coercing junk would
    decode a phantom prompt."""
    if not isinstance(raw, list) or not raw:
        raise ValueError(
            "%s must be a non-empty token list or a batch of token "
            "lists (this engine is tokenizer-free: send token ids)"
            % what)
    rows = list(raw) if isinstance(raw[0], list) else [raw]
    out = []
    for r in rows:
        if not isinstance(r, list) or not r:
            raise ValueError("%s rows must be non-empty flat token "
                             "lists" % what)
        try:
            out.append([int(t) for t in r])
        except (TypeError, ValueError):
            raise ValueError("%s rows must be flat lists of int "
                             "token ids" % what)
    return out, not isinstance(raw[0], list)


def parse_completions(body, default_model=MODEL_ID):
    """``/v1/completions`` body → submit parameters.  Client errors
    raise ``ValueError``; unsupported OpenAI parameters are REJECTED (a
    silently ignored ``n=4`` bills the client for answers it never
    gets), except at the neutral values SDKs send by default."""
    def _neutral_only(name, neutral):
        v = body.get(name)
        if v is not None and float(v) != float(neutral):
            raise ValueError("unsupported parameter %r (only the "
                             "neutral value %r)" % (name, neutral))
    _neutral_only("n", 1)
    _neutral_only("best_of", 1)
    _neutral_only("top_p", 1)
    _neutral_only("presence_penalty", 0)
    _neutral_only("frequency_penalty", 0)
    for unsupported in ("logprobs", "logit_bias", "suffix"):
        if body.get(unsupported):
            raise ValueError("unsupported parameter %r" % unsupported)
    rows, squeeze = parse_token_rows(body.get("prompt"))
    try:
        steps = int(body.get("max_tokens", 16))
    except (TypeError, ValueError):
        raise ValueError("max_tokens must be an int")
    if steps < 1:
        raise ValueError("max_tokens must be >= 1")
    try:
        temperature = float(body.get("temperature") or 0.0)
        top_k = int(body.get("top_k") or 0)
    except (TypeError, ValueError):
        raise ValueError("temperature must be a number and top_k an "
                         "int")
    stop = body.get("stop")
    if stop is not None:
        try:
            stop = int(stop)
        except (TypeError, ValueError):
            raise ValueError("stop must be an int token id (this "
                             "engine is tokenizer-free)")
    seed = body.get("seed")
    if seed is not None:
        try:
            seed = int(seed)
        except (TypeError, ValueError):
            raise ValueError("seed must be an int")
    return {
        "rows": rows, "squeeze": squeeze, "steps": steps,
        "temperature": temperature, "top_k": top_k, "stop": stop,
        "seed": seed, "stream": bool(body.get("stream")),
        "echo": bool(body.get("echo")),
        "priority": body.get("priority"),
        "model": str(body.get("model") or model_id(default_model)),
    }


# -- reply shaping ------------------------------------------------------------

def _host(values):
    """A tensor or an array on the host as numpy (replies carry plain
    Python numbers, never a tensor's ``str``)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return numpy.asarray(values)


def completion_id():
    return "cmpl-%s" % os.urandom(12).hex()


def text_of(tokens):
    """The ``text`` rendering of a token list: space-separated decimal
    ids (a tokenizer-free engine)."""
    return " ".join(str(int(t)) for t in tokens)


def finish_reason(generated, steps, stop):
    return "stop" if (stop is not None and generated
                      and generated[-1] == stop) else "length"


def completion_choice(index, prompt, generated, params):
    toks = [int(t) for t in (list(prompt) + list(generated)
                             if params["echo"] else generated)]
    return {"index": index, "text": text_of(toks), "tokens": toks,
            "finish_reason": finish_reason(generated, params["steps"],
                                           params["stop"]),
            "logprobs": None}


def usage_of(rows, generated_counts):
    p = sum(len(r) for r in rows)
    c = sum(int(n) for n in generated_counts)
    return {"prompt_tokens": p, "completion_tokens": c,
            "total_tokens": p + c}


def completion_reply(cid, created, model, choices, usage):
    return {"id": cid, "object": "text_completion", "created": created,
            "model": model, "choices": choices, "usage": usage}


def completion_chunk(cid, created, model, index, tokens, finish=None,
                     usage=None, trace_id=None):
    """One SSE chunk of a streaming completion: the newly accepted
    tokens; finish_reason, usage and the request's ``trace_id`` only on
    the terminal chunk."""
    out = {"id": cid, "object": "text_completion", "created": created,
           "model": model,
           "choices": [{"index": index, "text": text_of(tokens),
                        "tokens": [int(t) for t in tokens],
                        "finish_reason": finish, "logprobs": None}]}
    if usage is not None:
        out["usage"] = usage
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def models_reply(model=MODEL_ID):
    return {"object": "list",
            "data": [{"id": model_id(model), "object": "model",
                      "created": int(time.time()),
                      "owned_by": "veles_tpu"}]}


def embeddings_reply(model, vectors, rows):
    """``vectors``: one pooled vector per row (lists, arrays or a [n, d]
    tensor)."""
    data = [{"object": "embedding", "index": i,
             "embedding": [float(x) for x in _host(v).reshape(-1)]}
            for i, v in enumerate(vectors)]
    return {"object": "list", "model": model, "data": data,
            "usage": {"prompt_tokens": sum(len(r) for r in rows),
                      "total_tokens": sum(len(r) for r in rows)}}


def classify_reply(model, logp, rows, top):
    """Per-row class scores: the full log-probability vector and the
    ``top`` best (label = class index)."""
    logp = _host(logp).astype(numpy.float64)
    data = []
    for i in range(len(rows)):
        order = numpy.argsort(-logp[i])[:max(1, int(top))]
        data.append({
            "index": i,
            "label": int(order[0]),
            "top": [{"label": int(c),
                     "logprob": round(float(logp[i][c]), 6)}
                    for c in order],
            "logprobs": [round(float(x), 6) for x in logp[i]],
        })
    return {"object": "list", "model": model, "data": data,
            "usage": {"prompt_tokens": sum(len(r) for r in rows),
                      "total_tokens": sum(len(r) for r in rows)}}
