"""Quality gates of the quantized KV cache and of int8 weight
checkpoints — the port of ``veles_tpu/serving/kv_quality.py``.

A sequence is teacher-forced through the paged verify path —
``block_size``-wide :meth:`apply_verify_paged` passes, so every key a
position attends over was quantized when its block was written, as
live decode reads it — once over fp32 pools and once over int8
(:func:`kv_quant_quality`), or once with f32 weights and once after
``quantize_weights`` (:func:`weight_quant_quality`).  Each reports the
mean next-token cross-entropy (nats) of both runs, their delta, and
whether the delta is within the declared tolerance.  On the card the
int8 passes run the paged-attention kernel at K1 = ``block_size``.
"""

import numpy
import torch

#: the int8-KV quality bound: mean next-token CE delta against fp32
#: pools, in nats (the reference's)
KV_QUANT_CE_TOLERANCE = 0.05

#: the int8-weight quality bound, same units (the reference's)
WEIGHT_QUANT_CE_TOLERANCE = 0.05


def _verify_pass(forwards, toks, pos, lens, tables, pools):
    """One teacher-forced chunk through the chain's verify path (the
    unit dispatch of ``engine.verify_logits``), returning f32 logits."""
    h = toks
    for i, u in enumerate(forwards):
        if i in pools:
            h, pools[i] = u.apply_verify_paged(h, pos, lens, tables,
                                               pools[i])
        elif hasattr(u, "apply_verify_slots"):
            h = u.apply_verify_slots(h, pos)
        else:
            h = u.apply(h)
    return h.to(torch.float32)


def teacher_forced_logits(forwards, seq, block_size=16, kv_dtype="fp32"):
    """Per-position next-token logits of ``seq`` through the paged
    verify path over ``kv_dtype`` pools, ``block_size`` tokens per pass.
    Returns [L, vocab] f32 numpy where row j predicts ``seq[j + 1]``
    (L = the whole-block prefix length)."""
    bs = int(block_size)
    n_blocks = len(seq) // bs
    if n_blocks < 1:
        raise ValueError("sequence shorter than one block")
    device = forwards[0].device
    pools = {}
    for i, u in enumerate(forwards):
        if not hasattr(u, "init_cache"):
            continue
        if not hasattr(u, "init_block_pool"):
            raise ValueError("%s has no init_block_pool" % type(u).__name__)
        pools[i] = u.init_block_pool(n_blocks + 1, bs, u.dtype,
                                     kv_dtype=kv_dtype)
    tables = torch.arange(1, n_blocks + 1, dtype=torch.int32,
                          device=device)[None, :]
    lens = torch.tensor([bs], dtype=torch.int64, device=device)
    rows = []
    with torch.no_grad():
        for t in range(n_blocks):
            chunk = torch.as_tensor(
                numpy.asarray(seq[t * bs:(t + 1) * bs], numpy.int64),
                device=device)[None, :]
            pos = torch.tensor([t * bs], dtype=torch.int64, device=device)
            logits = _verify_pass(forwards, chunk, pos, lens, tables, pools)
            rows.append(logits[0].cpu().numpy())
    return numpy.concatenate(rows, axis=0)


def _mean_ce(logits, targets):
    z = logits - logits.max(axis=-1, keepdims=True)
    logp = z - numpy.log(numpy.exp(z).sum(axis=-1, keepdims=True))
    return float(-logp[numpy.arange(len(targets)), targets].mean())


def kv_quant_quality(forwards, seqs, block_size=16,
                     tolerance=KV_QUANT_CE_TOLERANCE):
    """The int8-KV quality cost on ``seqs`` (token lists): teacher-forced
    CE and greedy top-1 agreement, fp32 pools against int8, through the
    same verify path.  Returns the reference's record."""
    ce_fp, ce_q8, agree, total = [], [], 0, 0
    for seq in seqs:
        lf = teacher_forced_logits(forwards, seq, block_size, "fp32")
        lq = teacher_forced_logits(forwards, seq, block_size, "int8")
        n = min(len(lf), len(seq) - 1)   # row j predicts seq[j + 1]
        targets = numpy.asarray(seq[1:n + 1], numpy.intp)
        ce_fp.append(_mean_ce(lf[:n], targets))
        ce_q8.append(_mean_ce(lq[:n], targets))
        agree += int((lf[:n].argmax(-1) == lq[:n].argmax(-1)).sum())
        total += n
    ce_fp32 = float(numpy.mean(ce_fp))
    ce_int8 = float(numpy.mean(ce_q8))
    delta = ce_int8 - ce_fp32
    return {
        "kv_quant_ce_fp32": round(ce_fp32, 6),
        "kv_quant_ce_int8": round(ce_int8, 6),
        "kv_quant_ce_delta": round(delta, 6),
        "kv_quant_top1_agreement": round(agree / total, 6)
        if total else None,
        "kv_quant_ce_tolerance": tolerance,
        "kv_quant_within_tolerance": bool(delta <= tolerance),
        "kv_quant_positions": total,
        "kv_quant_block_size": int(block_size),
    }


def weight_quant_quality(forwards, seqs, block_size=16,
                         tolerance=WEIGHT_QUANT_CE_TOLERANCE):
    """The int8 weight-checkpoint quality cost: teacher-forced CE through
    the same verify path with f32 weights, then after
    ``quantize_weights`` on every block.  The chain comes back
    quantized: run it on a copy, or last."""
    ce_fp, total_targets = [], []
    for seq in seqs:
        lf = teacher_forced_logits(forwards, seq, block_size, "fp32")
        n = min(len(lf), len(seq) - 1)
        targets = numpy.asarray(seq[1:n + 1], numpy.intp)
        ce_fp.append(_mean_ce(lf[:n], targets))
        total_targets.append((n, targets))
    quantized = 0
    for u in forwards:
        if hasattr(u, "quantize_weights"):
            u.quantize_weights()
            quantized += 1
    if not quantized:
        raise ValueError("no quantizable unit in the chain")
    ce_q8, total = [], 0
    for seq, (n, targets) in zip(seqs, total_targets):
        lf = teacher_forced_logits(forwards, seq, block_size, "fp32")
        ce_q8.append(_mean_ce(lf[:n], targets))
        total += n
    ce_fp32 = float(numpy.mean(ce_fp))
    ce_int8 = float(numpy.mean(ce_q8))
    delta = ce_int8 - ce_fp32
    return {
        "weight_quant_ce_fp32": round(ce_fp32, 6),
        "weight_quant_ce_int8": round(ce_int8, 6),
        "weight_quant_ce_delta": round(delta, 6),
        "weight_quant_ce_tolerance": tolerance,
        "weight_quant_within_tolerance": bool(delta <= tolerance),
        "weight_quant_positions": total,
        "weight_quant_blocks": quantized,
    }
