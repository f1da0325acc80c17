"""The port's hand-written CUDA kernels held against their plain
PyTorch versions ON THE CARD, at the serving model's width (d=1024,
8 heads, block 16).  The kernels have no CPU mode, so without a CUDA
device every test here skips.  This file imports no jax (the card's
machine has none): run it there with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: bf16 queries/activations 2e-3, f32 1e-5 — both sides
compute in f32, only the order of the sums differs."""

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

D, HEADS, BS = 1024, 8, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-3, atol=2e-3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("k1", [1, 5])
def test_paged_attend_kernel_matches_plain(card, pool, k1):
    from veles_tpu_torch.ops import paged_attend as mod
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    rng = numpy.random.default_rng(11 + k1)
    nb, b, t = 40, 4, 8
    qdt = torch.float32 if pool == "float32" else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, k1, D)),
                        dtype=qdt).to(card)
    tables = numpy.zeros((b, t), numpy.int32)
    tables[:3, :4] = rng.permutation(numpy.arange(1, nb))[:12].reshape(3, 4)
    qpos = (numpy.asarray([58, 33, 7, 0])[:, None]
            + numpy.arange(k1)[None, :]).astype(numpy.int32)
    qpos[3] = 0                      # an all-trash padding row
    kv = [torch.as_tensor(rng.standard_normal((nb, BS, D)),
                          dtype=torch.float32) for _ in range(2)]
    scales = {}
    if pool == "int8":
        (kq, ks), (vq, vs) = (quantize_kv_rows(x) for x in kv)
        kv = [kq, vq]
        scales = dict(scale_k=ks.to(card), scale_v=vs.to(card))
    else:
        kv = [x.to(getattr(torch, pool)) for x in kv]
    args = (q, kv[0].to(card), kv[1].to(card),
            torch.as_tensor(tables).to(card), torch.as_tensor(qpos).to(card),
            HEADS)
    before = mod.launches
    got = mod.paged_attend(*args, **scales)
    want = mod.paged_attend_plain(*args, **scales)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, k1, D)
    torch.testing.assert_close(got, want, **_tol(qdt))


@pytest.mark.parametrize("m", [1, 3, 8, 13])
@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 4096), (4096, 1024),
                                 (100, 70)])
def test_int8_gemm_kernel_matches_plain(card, m, k, n):
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(m + n)
    a = torch.as_tensor(rng.standard_normal((m, k)),
                        dtype=torch.bfloat16).to(card)
    wq, scale = gemm.int8_weight_quantize(
        torch.as_tensor(rng.standard_normal((k, n)) * 0.3,
                        dtype=torch.float32).to(card))
    before = gemm.launches
    got = gemm.int8_matmul(a, wq, scale)
    want = gemm.int8_matmul_plain(a, wq, scale)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1
    torch.testing.assert_close(got, want, **_tol(torch.bfloat16))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.ops.paged_attend import paged_attend
    a = torch.zeros((2, 8), device=card)
    with pytest.raises(ValueError):
        gemm.int8_matmul(a, torch.zeros((8, 4), device=card),
                         torch.ones(4, device=card))
    with pytest.raises(ValueError):
        gemm.int8_matmul(a, torch.zeros((8, 4), dtype=torch.int8),
                         torch.ones(4, device=card))
    q = torch.zeros((1, 1, D), device=card)
    pool = torch.zeros((2, BS, D), dtype=torch.int8, device=card)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="scale"):
        paged_attend(q, pool, pool, tables, tables, HEADS)
