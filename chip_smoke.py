#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build — every kernel under ``veles_tpu_torch/csrc/`` with ``nvcc``
   (one compiler per source, all started together);
2. kernels — each kernel wrapper on the card at the shapes of its path,
   held against its plain PyTorch version on the same inputs, then
   timed beside the plain version and one library call: the serving
   kernels at the serving shapes; the three FlashAttention kernels
   (forward, dq, dk/dv) at the training shapes (b 4, s 2048, 16 heads
   of 128, bf16, causal) and at small odd ones (f32, sq != sk,
   non-causal, lengths off the tile), element by element; at the
   training shapes three planted faults must fail the same check;
3. reference — a small float32 chain served through the kernels on the
   card, its prefill and decode logits held against the same chain on
   the CPU (plain versions);
4. train reference — a small float32 chain (d 256, 2 heads of 128, 2
   layers) takes 3 SGD-momentum steps from the same weights and
   minibatches on the card through the attention kernels, on the card
   through the dense core, and on the CPU through the plain versions:
   the kernel run must match the dense card run closely (losses, and
   each parameter relative to its update) and the CPU run loosely;
5. learns — ``samples/lm.train_lm`` on the Markov corpus (d 256, 2
   heads of 128, 2 blocks, seq 128, vocab 64, Adam + cosine, bf16):
   the validation cross-entropy must fall below the corpus' unigram
   entropy;
6. serve — the LM chain at the serving model's width (d=1024, 8 heads,
   vocab 32768, window 1024, depth cut to 8 layers, random weights
   from seed 0, bfloat16) through ``InferenceScheduler`` with int8 KV
   pools and ``int8_decode``: one warm-up request, then 8 concurrent
   128-token prompts x 32 greedy steps.  The kernels' launch counts
   are zeroed just before and read just after: ``paged_attend`` must
   launch once per layer per decode step, ``int8_gemm`` three times;
7. train — the LM trainer at ``bench.py``'s ``bench_lm`` configuration
   (d 2048, 8 layers, 16 heads of 128, seq 2048, batch 4, vocab 32768,
   bf16, SGD lr 0.01 momentum 0.9; random weights from seed 0 and
   random tokens): 2 warm-up steps, then 5 timed steps with the
   attention kernels' counts zeroed just before and read just after —
   each must launch once per layer per step — then one step under
   ``torch.profiler``.

Output, last lines: a ``{"kernels": [...]}`` JSON line, the card's
name and power limit from ``nvidia-smi``, and the
``{"ok": true, "device": {...}}`` line.
"""

import json
import re
import subprocess
import sys
import time

import numpy

#: the serving model of the smoke (``bench.py``'s serving width)
VOCAB, DIM, LAYERS, HEADS, WINDOW, BLOCK, SLOTS = 32768, 1024, 8, 8, 1024, 16, 8
PROMPT, STEPS, CHUNK = 128, 32, 64
#: kernel-vs-plain tolerances: both sides sum in f32, in another order
TOL = {"bfloat16": 2e-3, "float32": 1e-5}

#: the training model of the smoke (``bench.py``'s ``bench_lm``)
T_VOCAB, T_DIM, T_LAYERS, T_HEADS, T_SEQ, T_BATCH = 32768, 2048, 8, 16, 2048, 4
T_WARM, T_STEPS = 2, 5
#: FlashAttention kernel-vs-plain tolerance (tol, floor) by the
#: compared tensor's type, held element by element: |got - want| <=
#: tol * (|want| + rms(want)) + floor.  bf16 2e-2 is five half-steps of
#: bf16 (both sides round their f32 result once; the kernel rounds P
#: and ds at each tile's running max, the plain version once per row);
#: f32 (the LSE always) 1e-4 (sums in another order).  The floor covers
#: gradients that are rounding noise of both sides (a row of one key
#: has ds = P·(dP - delta) = 0 but for the order of dP's and delta's
#: sums)
FLASH_TOL = {"bfloat16": (2e-2, 1e-4), "float32": (1e-4, 1e-5)}
#: the kernel-path training run against the dense-core one on the card:
#: losses (relative) and each parameter's distance (relative to its
#: update over the run)
TRAIN_REF_LOSS, TRAIN_REF_STEP = 1e-6, 1e-4
#: (b, sq, sk, h, d, dtype, causal): the training shapes, then small odd
FLASH_CASES = [(T_BATCH, T_SEQ, T_SEQ, T_HEADS, T_DIM // T_HEADS,
                "bfloat16", True),
               (2, 100, 77, 3, 128, "float32", False),
               (1, 130, 200, 2, 128, "float32", True),
               (1, 77, 50, 2, 128, "float32", True)]

#: device-memory rate (bytes/s) by card name (NVIDIA data sheets)
HBM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12))
#: dense peak (operations/s) of the inputs' type (NVIDIA's H100 SXM
#: data sheet): bf16 tensor cores, f32 outside them
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name):
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise SystemExit("no memory rate known for card %r" % name)


def time_ms(torch, fn, reps=20):
    """Mean milliseconds of ``fn()`` on the card (CUDA events around
    ``reps`` calls after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, dtype, rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak of ``dtype``."""
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels ---------------------------------------------------------

def _attend_inputs(torch, rng, dev, b, t, k1, pool, nb, lo, hi):
    """Pools of ``nb`` blocks, a [b, t] table whose last row is
    occupancy padding (all trash block 0, position 0) and whose other
    rows, at positions drawn from [lo, hi], own distinct blocks up to
    their position, trash past it."""
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    qdt = torch.float32 if pool == "float32" else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, k1, DIM)),
                        dtype=torch.float32).to(dev, qdt)
    tables = numpy.zeros((b, t), numpy.int32)
    qpos = numpy.zeros((b, k1), numpy.int32)
    free = list(rng.permutation(numpy.arange(1, nb)))
    for r in range(b - 1 if b > 1 else b):
        p = int(rng.integers(lo, hi + 1))
        live = (p + k1 - 1) // BLOCK + 1
        tables[r, :live] = [free.pop() for _ in range(live)]
        qpos[r] = p + numpy.arange(k1)
    kv = [torch.as_tensor(rng.standard_normal((nb, BLOCK, DIM)),
                          dtype=torch.float32).to(dev) for _ in range(2)]
    extra = {}
    if pool == "int8":
        (pk, sk), (pv, sv) = (quantize_kv_rows(x) for x in kv)
        kv = [pk, pv]
        extra = dict(scale_k=sk, scale_v=sv)
    else:
        kv = [x.to(getattr(torch, pool)) for x in kv]
    args = (q, kv[0], kv[1], torch.as_tensor(tables).to(dev),
            torch.as_tensor(qpos).to(dev), HEADS)
    return args, extra


def _attend_bytes_ops(args, extra):
    """Bytes the paged attention must move and operations it must do
    for these inputs: each row reads its table's blocks up to its
    deepest query, once."""
    q, pk, _, tables, qpos, _ = args
    b, k1, d = q.shape
    rows = ((qpos.max(dim=1).values // BLOCK + 1) * BLOCK).cpu()
    row_bytes = 2 * d * pk.element_size() + (8 if extra else 0)
    nbytes = (int(rows.sum()) * row_bytes + q.numel() * q.element_size()
              + b * k1 * d * 4 + tables.numel() * 4 + qpos.numel() * 4)
    ops = 4 * d * k1 * int(rows.sum())
    return nbytes, ops


def check_kernels(torch, dev, rate):
    """Every kernel against its plain version at the serving shapes,
    then timed.  Returns the measured fields of each kernel."""
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    rng = numpy.random.default_rng(1)
    nb = SLOTS * (WINDOW // BLOCK) + 1      # the smoke's pool: 512 + trash
    errs = {"paged_attend": 0.0, "int8_gemm": 0.0}
    cases = [("int8", b, t, 1) for b in (1, 8) for t in (4, 64)]
    cases += [("float32", 8, 16, 1), ("float32", 8, 16, 5),
              ("bfloat16", 8, 16, 1)]
    for pool, b, t, k1 in cases:
        args, extra = _attend_inputs(torch, rng, dev, b, t, k1, pool, nb,
                                     0, t * BLOCK - k1)
        got = pa.paged_attend(*args, **extra)
        want = pa.paged_attend_plain(*args, **extra)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL["float32" if pool == "float32" else "bfloat16"]
        log("paged_attend pool=%s B=%d T=%d K1=%d max_abs_err=%.3g"
            % (pool, b, t, k1, err))
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise SystemExit("paged_attend disagrees with its plain "
                             "version (pool=%s B=%d T=%d K1=%d): %g"
                             % (pool, b, t, k1, err))
        errs["paged_attend"] = max(errs["paged_attend"], err)
    shapes = ((DIM, DIM), (DIM, 4 * DIM), (4 * DIM, DIM))
    for m in (1, 8):
        for k, n in shapes:
            a = torch.as_tensor(rng.standard_normal((m, k)),
                                dtype=torch.float32).to(dev, torch.bfloat16)
            wq, scale = gemm.int8_weight_quantize(torch.as_tensor(
                rng.standard_normal((k, n)) * 0.02,
                dtype=torch.float32).to(dev))
            got = gemm.int8_matmul(a, wq, scale)
            want = gemm.int8_matmul_plain(a, wq, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            log("int8_gemm m=%d k=%d n=%d max_abs_err=%.3g" % (m, k, n, err))
            if not torch.allclose(got, want, rtol=TOL["bfloat16"],
                                  atol=TOL["bfloat16"]):
                raise SystemExit("int8_gemm disagrees with its plain "
                                 "version (m=%d k=%d n=%d): %g"
                                 % (m, k, n, err))
            errs["int8_gemm"] = max(errs["int8_gemm"], err)
    return {"paged_attend": time_attend(torch, dev, rng, nb, rate,
                                        errs["paged_attend"]),
            "int8_gemm": time_gemm(torch, dev, rng, rate,
                                   errs["int8_gemm"])}


def time_attend(torch, dev, rng, nb, rate, err):
    """One decode step's attention: 8 layers' int8 pools (so the pools,
    134 MB together, do not sit in the 50 MB L2 as one layer's would),
    B=8 rows (7 requests and one padding row) at positions 128..159,
    the smoke's decode range (T=16, its block bucket), one query each.
    Times are per launch."""
    from veles_tpu_torch.ops import paged_attend as pa
    layers = [_attend_inputs(torch, rng, dev, 8, 16, 1, "int8", nb,
                             PROMPT, PROMPT + STEPS - 1)
              for _ in range(LAYERS)]
    # every layer gets the same table and positions, as in a real step
    for args, _ in layers[1:]:
        args[3].copy_(layers[0][0][3])
        args[4].copy_(layers[0][0][4])

    def kernel():
        for args, extra in layers:
            pa.paged_attend(*args, **extra)

    def plain():
        for args, extra in layers:
            pa.paged_attend_plain(*args, **extra)

    def library():
        # gather + dequantize the table's blocks, then one
        # scaled_dot_product_attention call with the causal mask
        for (q, pk, pv, tables, qpos, heads), ex in layers:
            b, k1, d = q.shape
            idx = tables.long()
            hd = d // heads
            length = idx.shape[1] * BLOCK
            k = (pk[idx].to(q.dtype) * ex["scale_k"][idx][..., None]
                 .to(q.dtype)).reshape(b, length, heads, hd).transpose(1, 2)
            v = (pv[idx].to(q.dtype) * ex["scale_v"][idx][..., None]
                 .to(q.dtype)).reshape(b, length, heads, hd).transpose(1, 2)
            keep = (torch.arange(length, device=q.device)[None, None, :]
                    <= qpos.long()[:, :, None])[:, None]
            torch.nn.functional.scaled_dot_product_attention(
                q.reshape(b, k1, heads, hd).transpose(1, 2), k, v,
                attn_mask=keep).float()

    nbytes, ops = _attend_bytes_ops(*layers[0])
    b_ms, b_by = bound(nbytes, ops, "bfloat16", rate)
    before = pa.launches
    fields = {"ms": time_ms(torch, kernel) / LAYERS,
              "plain_ms": time_ms(torch, plain) / LAYERS,
              "library_ms": time_ms(torch, library) / LAYERS,
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
              "bytes": nbytes}
    pa.launches = before              # timing launches are not the path's
    return fields


def time_gemm(torch, dev, rng, rate, err):
    """One decode step's int8 GEMMs per layer (wo, ffn_w1, ffn_w2 at
    m=8), over 8 layers' distinct weights (72 MB of int8, more than
    the L2 holds).  Times are per layer (three launches)."""
    from veles_tpu_torch.ops import gemm
    shapes = ((DIM, DIM), (DIM, 4 * DIM), (4 * DIM, DIM))
    m = SLOTS
    work = []
    for _ in range(LAYERS):
        for k, n in shapes:
            a = torch.as_tensor(rng.standard_normal((m, k)),
                                dtype=torch.float32).to(dev, torch.bfloat16)
            wq, scale = gemm.int8_weight_quantize(torch.as_tensor(
                rng.standard_normal((k, n)) * 0.02,
                dtype=torch.float32).to(dev))
            work.append((a, wq, scale))

    def kernel():
        for a, wq, scale in work:
            gemm.int8_matmul(a, wq, scale)

    def plain():
        for a, wq, scale in work:
            gemm.int8_matmul_plain(a, wq, scale)

    def library():
        for a, wq, scale in work:
            torch.matmul(a, wq.to(a.dtype)) * scale

    nbytes = sum(m * k * 2 + k * n + n * 4 + m * n * 4 for k, n in shapes)
    ops = sum(2 * m * k * n for k, n in shapes)
    b_ms, b_by = bound(nbytes, ops, "bfloat16", rate)
    before = gemm.launches
    fields = {"ms": time_ms(torch, kernel) / LAYERS,
              "plain_ms": time_ms(torch, plain) / LAYERS,
              "library_ms": time_ms(torch, library) / LAYERS,
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
              "bytes": nbytes}
    gemm.launches = before
    return fields


# -- phase 2: FlashAttention kernels ------------------------------------------

def _flash_inputs(torch, dev, case, seed):
    b, sq, sk, h, d, dt, _ = case
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
               for s in (sq, sk, sk))
    return q, k, v, torch.randn((b, sq, h, d), generator=gen).to(dev, dtype)


def flash_excess(got, want):
    """The largest ratio, over the elements, of ``|got - want|`` to its
    limit ``tol * (|want| + rms(want)) + floor`` (FLASH_TOL by
    ``want``'s type): at most 1 passes."""
    tol, floor = FLASH_TOL[str(want.dtype).rsplit(".", 1)[-1]]
    got, want = got.float(), want.float()
    lim = tol * (want.abs() + want.square().mean().sqrt()) + floor
    return float(((got - want).abs() / lim).max())


def planted_faults(fa, q, k, v, do, o, lse, causal):
    """What the plain versions give for three kernel faults, to show
    that the check of FLASH_TOL rejects them at the training shapes:
    the forward and dq without their last key tile (the rows of the
    last query tile lose 64 of their ~2000 keys), the forward with the
    scale 10% off, and dk/dv without their last query tile."""
    t = 64
    scale = fa.default_scale(q.shape[-1])
    o_short, lse_short = fa.flash_fwd_plain(q, k[:, :-t], v[:, :-t], causal)
    o_scaled, lse_scaled = fa.flash_fwd_plain(q, k, v, causal, 1.1 * scale)
    dk_short, dv_short = fa.flash_bwd_dkv_plain(
        q[:, :-t], k, v, do[:, :-t], o[:, :-t], lse[..., :-t], causal)
    return {
        "flash_attn_fwd": {"last key tile dropped": (o_short, lse_short),
                           "scale x1.1": (o_scaled, lse_scaled)},
        "flash_attn_dq": {"last key tile dropped": (fa.flash_bwd_dq_plain(
            q, k[:, :-t], v[:, :-t], do, o, lse, causal),)},
        "flash_attn_dkv": {"last query tile dropped": (dk_short, dv_short)}}


def check_flash(torch, dev, rate):
    """The forward, dq and dk/dv kernels against their plain versions
    on every case of FLASH_CASES (the backward ones from the kernel's
    O and LSE), element by element (:func:`flash_excess`); at the
    training shapes, planted faults must fail the same check.  Then
    timed at the training shapes."""
    from veles_tpu_torch.ops import flash_attention as fa
    errs = dict.fromkeys(fa.launches, 0.0)
    for n, case in enumerate(FLASH_CASES):
        causal = case[-1]
        q, k, v, do = _flash_inputs(torch, dev, case, n)
        o, lse = fa.flash_fwd(q, k, v, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, o, lse, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, o, lse, causal)
        got = {"flash_attn_fwd": (o, lse), "flash_attn_dq": (dq,),
               "flash_attn_dkv": (dk, dv)}
        want = {"flash_attn_fwd": fa.flash_fwd_plain(q, k, v, causal),
                "flash_attn_dq": (fa.flash_bwd_dq_plain(
                    q, k, v, do, o, lse, causal),),
                "flash_attn_dkv": fa.flash_bwd_dkv_plain(
                    q, k, v, do, o, lse, causal)}
        faults = planted_faults(fa, q, k, v, do, o, lse, causal) \
            if n == 0 else {}
        torch.cuda.synchronize()
        for name in got:
            for g, w in zip(got[name], want[name]):
                err = float((g.float() - w.float()).abs().max())
                excess = flash_excess(g, w)
                log("%s %s max_abs_err=%.3g, %.3g of the limit"
                    % (name, case, err, excess))
                if not excess <= 1.0:
                    raise SystemExit("%s disagrees with its plain version "
                                     "at %s: %.3g of the limit"
                                     % (name, case, excess))
                errs[name] = max(errs[name], err)
            for fault, bad in faults.get(name, {}).items():
                excess = max(flash_excess(b, w)
                             for b, w in zip(bad, want[name]))
                err = max(float((b.float() - w.float()).abs().max())
                          for b, w in zip(bad, want[name]))
                log("%s %s planted fault (%s): max_abs_err=%.3g, %.3g of "
                    "the limit" % (name, case, fault, err, excess))
                if not excess > 1.0:
                    raise SystemExit("%s: the check passes a planted fault "
                                     "(%s)" % (name, fault))
    return time_flash(torch, dev, rate, errs)


def time_flash(torch, dev, rate, errs):
    """Each kernel at the training shapes beside its plain version and
    the library's ``scaled_dot_product_attention`` (forward; its
    backward through autograd computes dq, dk and dv together and is
    the yardstick of both backward kernels).  Bounds count the kept
    (row, col) pairs of the causal mask: 4, 6 and 8 flops per pair and
    head dim for the forward, dq and dk/dv (two, three and four
    products), and each input read once, each output written once."""
    from veles_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case = FLASH_CASES[0]
    b, sq, sk, h, d, dt, causal = case
    q, k, v, do = _flash_inputs(torch, dev, case, 100)
    o, lse = fa.flash_fwd(q, k, v, causal)
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ldo = do.transpose(1, 2).contiguous()
    lo = sdpa(lq, lk, lv, is_causal=causal)

    def lib_fwd():
        with torch.no_grad():
            sdpa(lq, lk, lv, is_causal=causal)

    def lib_bwd():
        torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    pairs = b * h * sum(min(r + 1, sk) if causal else sk for r in range(sq))
    row = b * h * d * q.element_size()           # one sequence position
    lse_bytes = b * h * sq * 4
    bwd_in = (3 * sq + 2 * sk) * row + lse_bytes   # q, do, o, k, v, lse
    work = {
        "flash_attn_fwd": (
            (2 * sq + 2 * sk) * row + lse_bytes, 4 * d * pairs,
            lambda: fa.flash_fwd(q, k, v, causal),
            lambda: fa.flash_fwd_plain(q, k, v, causal), lib_fwd),
        "flash_attn_dq": (
            bwd_in + sq * row, 6 * d * pairs,
            lambda: fa.flash_bwd_dq(q, k, v, do, o, lse, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, o, lse, causal),
            lib_bwd),
        "flash_attn_dkv": (
            bwd_in + 2 * sk * row, 8 * d * pairs,
            lambda: fa.flash_bwd_dkv(q, k, v, do, o, lse, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, o, lse, causal),
            lib_bwd)}
    before = dict(fa.launches)
    out = {}
    for name, (nbytes, ops, kernel, plain, library) in work.items():
        b_ms, b_by = bound(nbytes, ops, dt, rate)
        out[name] = {"ms": time_ms(torch, kernel, reps=10),
                     "plain_ms": time_ms(torch, plain, reps=5),
                     "library_ms": time_ms(torch, library, reps=10),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": errs[name], "bytes": nbytes,
                     "flops": ops}
    fa.launches.update(before)        # timing launches are not the path's
    return out


# -- phase 3: small reference -------------------------------------------------

def reference_check(torch, dev):
    """A small float32 chain (d=256, 2 heads of 128, 2 layers, vocab
    512) with int8 pools and ``int8_decode``, on the card through the
    kernels and on the CPU through the plain versions, same weights
    and tokens: prefill logits and 4 decode steps' logits must agree
    to 1e-3 (f32 sums in another order; an int8 K/V or weight value
    that lands on a rounding edge may quantize one step apart)."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.serving import (
        PagedKVCache, paged_decode_logits, prefill)
    spec = [{"type": "embedding", "vocab": 512, "dim": 256}]
    spec += [{"type": "transformer_block", "heads": 2, "int8_decode": True}
             for _ in range(2)]
    spec += [{"type": "token_logits", "vocab": 512}]
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    prompt = numpy.random.default_rng(2).integers(0, 512, (1, 40))
    # the CPU run picks the greedy tokens; the card is fed the same ones
    toks = []
    runs = {}
    for d in ("cpu", dev):
        chain = init_params(spec, 3, 128, device=d, dtype="float32")
        cache = PagedKVCache(chain, 2, 128, block_size=BLOCK,
                             kv_dtype="int8")
        slot = cache.alloc(48)
        caches, last = prefill(chain, prompt, window=48)
        cache.insert(slot, caches, 40)
        tables = cache.table_rows([slot], 4)
        logits = [last]
        launches = (pa.launches, gemm.launches)
        for step in range(4):
            if d == "cpu":
                toks.append(int(logits[-1].argmax()))
            logits.append(paged_decode_logits(chain, cache, [[toks[step]]],
                                              [40 + step], tables))
        runs[str(d)] = torch.stack([x[0] for x in logits]).cpu()
    if (pa.launches - launches[0], gemm.launches - launches[1]) != (8, 24):
        raise SystemExit("reference: the card's decode did not run "
                         "through the kernels")
    err = float((runs["cpu"] - runs[str(dev)]).abs().max())
    scale = float(runs["cpu"].abs().max())
    log("reference: prefill + 4 decode steps, logits max_abs_err=%.3g "
        "(|logits| <= %.3g)" % (err, scale))
    if not torch.allclose(runs[str(dev)], runs["cpu"], rtol=1e-3,
                          atol=1e-3) or not torch.isfinite(
                              runs[str(dev)]).all():
        raise SystemExit("reference: card and CPU logits disagree: %g"
                         % err)


# -- phase 4: train reference -------------------------------------------------

def _span_steps(torch, gd, loader, rows):
    """Train minibatches ``rows`` of the loader's current span one at a
    time (``GradientDescent.run_minibatch``); returns their losses."""
    from veles_tpu_torch.loader import TRAIN
    idx = torch.as_tensor(loader.span_indices_).long().to(gd.device)
    losses = []
    for k in rows:
        x = loader.dataset_dev[idx[k]]
        loss, _, _ = gd.run_minibatch(x, x, int(loader.span_sizes_[k]),
                                      TRAIN)
        losses.append(loss)
    return losses


def train_reference(torch, dev):
    """A small float32 LM chain (d 256, 2 heads of 128, 2 layers, vocab
    256, seq 64, minibatch 4) takes 3 SGD-momentum steps from the same
    weights and minibatches three times: on the card through the
    FlashAttention kernels, on the card through the dense core
    (``attn_impl="dense"``), and on the CPU through the kernels' plain
    versions.  The kernel run is held to the dense card run: losses to
    TRAIN_REF_LOSS relative, and each parameter's distance from the
    dense run's to TRAIN_REF_STEP of the dense run's own update (the
    other matmuls are the card's same calls on the same inputs, so only
    the attention core differs).  The CPU run is a loose second
    witness: losses to 1e-4 relative, weights to 5e-4 (f32 sums in
    another order; a ReLU input that rounds to the other side of 0
    moves its whole gradient)."""
    from veles_tpu_torch.convert import init_params, params_to_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.samples.lm import lm_spec
    toks = numpy.random.default_rng(4).integers(0, 256, (12, 64)).astype(
        numpy.int32)
    runs, launched = {}, {}
    for name, d, impl in (("kernels", dev, None), ("dense", dev, "dense"),
                          ("cpu", "cpu", "pallas")):
        chain = init_params(lm_spec(256, 256, 2, 2, attn_impl=impl), 5, 64,
                            device=d, dtype="float32")
        start = params_to_numpy(chain)
        loader = FullBatchLoader(toks, None, [0, 0, 12], minibatch_size=4,
                                 seed=6, device=d)
        gd = GradientDescent(chain, EvaluatorNextToken(), solver="sgd",
                             learning_rate=0.01, gradient_moment=0.9)
        loader.serve_span()
        before = dict(fa.launches)
        losses = torch.stack(_span_steps(torch, gd, loader, range(3)))
        launched[name] = {n: fa.launches[n] - before[n] for n in before}
        runs[name] = (losses.cpu().double(), params_to_numpy(chain))
    if launched["kernels"] != dict.fromkeys(fa.launches, 6) or any(
            launched["dense"].values()):
        raise SystemExit("train reference: launched %s (want 6 of each in "
                         "the kernel run: 2 layers x 3 steps, none in the "
                         "dense run)" % launched)
    (k_loss, k_p), (d_loss, d_p), (c_loss, c_p) = (
        runs[n] for n in ("kernels", "dense", "cpu"))
    step = {}
    for i in d_p:
        for n in d_p[i]:
            moved = numpy.linalg.norm((d_p[i][n] - start[i][n]).ravel())
            step["%d.%s" % (i, n)] = float(numpy.linalg.norm(
                (k_p[i][n] - d_p[i][n]).ravel()) / max(moved, 1e-30))
    worst = max(step, key=step.get)
    loss_err = float(((k_loss - d_loss).abs() / d_loss.abs()).max())
    cpu_err = max(float(numpy.abs(k_p[i][n] - c_p[i][n]).max())
                  for i in c_p for n in c_p[i])
    log("train reference: losses %s (kernels) vs %s (dense, card) vs %s "
        "(CPU); kernels vs dense: losses %.3g relative, parameters <= %.3g "
        "of their update (%s); kernels vs CPU weights max_abs_err=%.3g"
        % (k_loss.tolist(), d_loss.tolist(), c_loss.tolist(), loss_err,
           step[worst], worst, cpu_err))
    if not loss_err <= TRAIN_REF_LOSS or not step[worst] <= TRAIN_REF_STEP:
        raise SystemExit("train reference: the kernel run and the dense "
                         "run disagree")
    if not torch.allclose(k_loss, c_loss, rtol=1e-4, atol=0) \
            or cpu_err > 5e-4:
        raise SystemExit("train reference: card and CPU training disagree")


# -- phase 5: learns ----------------------------------------------------------

def learns(torch, dev):
    """``train_lm`` on the Markov corpus through the kernels: 9 epochs of
    32 Adam steps (cosine over 256 steps, 20 warm-up steps); the
    validation span that opens the ninth epoch (after 256 steps) must
    score a per-token cross-entropy below the corpus' unigram entropy
    (``tests/test_lm.py``'s check of the JAX sample)."""
    from veles_tpu_torch.samples.lm import build_lm, train_lm
    t0 = time.perf_counter()
    lm = build_lm(vocab=64, dim=256, blocks=2, heads=2, seq=128,
                  n_train=4096, n_valid=512, minibatch_size=128,
                  learning_rate=2e-3,
                  lr_schedule_params={"total_steps": 256, "floor": 0.1,
                                      "warmup": 20},
                  device=dev, dtype="bfloat16")
    history = train_lm(lm, 9)
    torch.cuda.synchronize()
    curve = [round(r["validation_loss"], 4) for r in history]
    h_uni = lm.loader.h_unigram_
    log(json.dumps({"learns": {
        "validation_loss_by_epoch": curve, "h_unigram": h_uni,
        "h_bigram": lm.loader.h_bigram_, "steps": lm.trainer.global_step,
        "seconds": time.perf_counter() - t0}}))
    if not 0.0 < curve[-1] < h_uni:
        raise SystemExit("learns: validation CE %.4f is not below the "
                         "unigram entropy %.4f" % (curve[-1], h_uni))


# -- phase 6: serve -----------------------------------------------------------

def serve_check(torch, dev):
    """The main path at the serving width; returns the launch counts
    of the measured run and prints its serving numbers."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler
    spec = [{"type": "embedding", "vocab": VOCAB, "dim": DIM}]
    spec += [{"type": "transformer_block", "heads": HEADS,
              "int8_decode": True} for _ in range(LAYERS)]
    spec += [{"type": "token_logits", "vocab": VOCAB}]
    t0 = time.perf_counter()
    chain = init_params(spec, 0, WINDOW, device=dev, dtype="bfloat16")
    sch = InferenceScheduler(chain, max_slots=SLOTS, window=WINDOW,
                             block_size=BLOCK, kv_dtype="int8",
                             prefill_chunk=CHUNK, device=dev).start()
    log("serve: chain and scheduler up in %.1f s"
        % (time.perf_counter() - t0))
    rng = numpy.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(SLOTS)]
    try:
        warm = sch.submit(prompts[0], STEPS).result(600)
        if len(warm) != PROMPT + STEPS:
            raise SystemExit("serve: warm-up returned %d tokens"
                             % len(warm))
        steps0, toks0 = sch.decode_steps, sch.decode_tokens
        secs0, done0 = sch.decode_seconds, len(sch.completed)
        torch.cuda.synchronize()
        pa.launches = 0
        gemm.launches = 0
        t0 = time.perf_counter()
        futs = [sch.submit(p, STEPS) for p in prompts]
        outs = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"paged_attend": pa.launches,
                    "int8_gemm": gemm.launches}
        steps = sch.decode_steps - steps0
        dtoks = sch.decode_tokens - toks0
        dsecs = sch.decode_seconds - secs0
        times = sch.completed[done0:]
        prof = profile_window(torch, sch, prompts)
    finally:
        sch.close()
    sch.check_kv()
    cache = sch.cache_
    if cache.free_slots != SLOTS or cache.free_blocks \
            != cache.capacity_blocks:
        raise SystemExit("serve: slots or blocks leaked after close()")
    for p, out in zip(prompts, outs):
        if len(out) != PROMPT + STEPS or out[:PROMPT] != p \
                or not all(0 <= t < VOCAB for t in out[PROMPT:]):
            raise SystemExit("serve: a result is malformed")
    if steps < 1 or launches["paged_attend"] != LAYERS * steps \
            or launches["int8_gemm"] != 3 * LAYERS * steps:
        raise SystemExit("serve: %d decode steps but launches %s (want "
                         "%d and %d per step)" % (steps, launches, LAYERS,
                                                  3 * LAYERS))
    ttft = sorted(t for t, _ in times)
    log(json.dumps({"serve": {
        "requests": len(outs), "prompt": PROMPT, "steps": STEPS,
        "decode_steps": steps, "launches": launches,
        "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
        "ttft_ms_max": 1e3 * ttft[-1],
        "decode_tokens_per_s": dtoks / dsecs,
        "decode_step_ms": 1e3 * dsecs / steps,
        "wall_s": wall,
        "tokens_per_s": len(outs) * STEPS / wall}}))
    log(json.dumps({"profile": prof}))
    return {"launches": launches}


def profile_window(torch, sch, prompts, steps=8):
    """Where the serving time goes: the same 8 prompts for ``steps``
    tokens under ``torch.profiler`` (after the measured run, so its
    cost stays out of the serving numbers).  Returns the window's wall
    time, the device's busy time (kernels' self time summed) and idle
    share, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [sch.submit(p, steps) for p in prompts]
        for f in futs:
            f.result(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_kernels": [[e.key[:60], e.count,
                             e.self_device_time_total / 1e3]
                            for e in top]}


# -- phase 7: train -----------------------------------------------------------

def train_check(torch, dev):
    """The trainer's main path at ``bench_lm``'s configuration; returns
    the attention kernels' launch counts of the timed steps and prints
    the training numbers."""
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.samples.lm import build_lm
    t0 = time.perf_counter()
    n_train = T_BATCH * 8
    toks = numpy.random.default_rng(0).integers(
        0, T_VOCAB, (n_train, T_SEQ)).astype(numpy.int32)
    loader = FullBatchLoader(toks, None, [0, 0, n_train],
                             minibatch_size=T_BATCH, seed=0, device=dev)
    lm = build_lm(vocab=T_VOCAB, dim=T_DIM, blocks=T_LAYERS, heads=T_HEADS,
                  seq=T_SEQ, loader=loader, solver="sgd", learning_rate=0.01,
                  gradient_moment=0.9, lr_schedule="constant", device=dev,
                  dtype="bfloat16")
    gd = lm.trainer
    n_params = sum(t.numel() for u in lm.chain for t in u.params.values())
    log("train: %d parameters, chain and trainer up in %.1f s"
        % (n_params, time.perf_counter() - t0))
    loader.serve_span()
    torch.cuda.reset_peak_memory_stats()
    warm = _span_steps(torch, gd, loader, range(T_WARM))
    torch.cuda.synchronize()
    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.perf_counter()
    losses = _span_steps(torch, gd, loader, range(T_WARM, T_WARM + T_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in warm + losses]
    if not all(numpy.isfinite(losses)):
        raise SystemExit("train: non-finite losses %s" % losses)
    if launches != dict.fromkeys(launches, T_LAYERS * T_STEPS):
        raise SystemExit("train: %d steps launched %s (want %d of each)"
                         % (T_STEPS, launches, T_LAYERS * T_STEPS))
    prof = profile_train(torch, gd, loader)
    log(json.dumps({"train": {
        "steps": T_STEPS, "step_ms": 1e3 * wall / T_STEPS,
        "tokens_per_s": T_STEPS * T_BATCH * T_SEQ / wall,
        "max_memory_allocated_gb": peak / 1e9, "losses": losses,
        "launches": launches, "parameters": n_params}}))
    log(json.dumps({"train_profile": prof}))
    return {"launches": launches}


def profile_train(torch, gd, loader):
    """One more step under ``torch.profiler``: wall time, device busy
    time (kernels' self time summed), idle share, top kernels."""
    from torch.profiler import ProfilerActivity, profile
    k = T_WARM + T_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _span_steps(torch, gd, loader, range(k, k + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_kernels": [[e.key[:60], e.count,
                             e.self_device_time_total / 1e3]
                            for e in top]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from veles_tpu_torch import _build
    dev = torch.device("cuda")
    card = card_line()
    rate = hbm_rate(card)

    t0 = time.perf_counter()
    _build.build_all()
    log("build: %.1f s (%s)" % (time.perf_counter() - t0,
                                ", ".join(sorted(_build.SOURCES))))
    for name, report in sorted(_build.ptxas_reports.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", report))
        log("ptxas %s: %d kernels, <= %d registers, %d bytes spilled"
            % (name, len(regs), max(regs, default=0), spills))

    measured = check_kernels(torch, dev, rate)
    measured.update(check_flash(torch, dev, rate))
    reference_check(torch, dev)
    train_reference(torch, dev)
    learns(torch, dev)
    launches = serve_check(torch, dev)["launches"]
    launches.update(train_check(torch, dev)["launches"])

    replaces = {
        "paged_attend": ("paged_attend.cu", "pallas_paged.py:112"),
        "int8_gemm": ("int8_gemm.cu", "gemm.py:131"),
        "flash_attn_fwd": ("flash_attention.cu", "pallas_attention.py:179"),
        "flash_attn_dq": ("flash_attention.cu", "pallas_attention.py:330"),
        "flash_attn_dkv": ("flash_attention.cu", "pallas_attention.py:352"),
    }
    kernels = [dict(name=name, route="cuda",
                    source="veles_tpu_torch/csrc/" + src,
                    replaces="veles_tpu/ops/" + tpu,
                    launches=launches[name], **measured[name])
               for name, (src, tpu) in replaces.items()]
    for k in kernels:
        k["kernel_ms"] = k["ms"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
