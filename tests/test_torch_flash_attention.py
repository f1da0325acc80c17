"""The port's FlashAttention (``veles_tpu_torch/ops/flash_attention.py``)
held against the JAX package's Pallas kernels
(``veles_tpu/ops/pallas_attention.py``, interpret mode on the CPU) on
the same numpy inputs: the forward and its LSE, and dq/dk/dv of the
autograd Function against ``jax.grad`` through ``pallas_attention``.
On the CPU the Function runs its plain versions, which mirror the
kernels' math.

Tolerances: float32 2e-5 on outputs and 1e-4 on gradients, as
``tests/test_pallas_attention.py`` holds the Pallas kernels to the
dense reference (the sums run in another order); bfloat16 outputs and
gradients 2e-2 relative to the largest magnitude (bf16's unit roundoff
is 3.9e-3, and an element rounded on the other side of a tie is one
bf16 step off)."""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops.pallas_attention import _run_fwd, pallas_attention

pytestmark = pytest.mark.torch_port

F32 = dict(out=2e-5, grad=1e-4)
BF16 = 2e-2

#: (b, sq, sk, h, d, dv): equal lengths, odd lengths, sq != sk both
#: ways, and a value width other than the key width
SHAPES = [(2, 32, 32, 2, 16, 16), (1, 37, 37, 2, 16, 16),
          (2, 21, 45, 1, 8, 8), (1, 50, 19, 3, 16, 16),
          (1, 24, 24, 2, 16, 8)]


def _inputs(shape, seed):
    b, sq, sk, h, d, dv = shape
    rng = numpy.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(numpy.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(numpy.float32)
    v = rng.standard_normal((b, sk, h, dv)).astype(numpy.float32)
    g = rng.standard_normal((b, sq, h, dv)).astype(numpy.float32)
    return q, k, v, g


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(arrays, dtype, grad=False):
    return [torch.as_tensor(a).to(dtype).requires_grad_(grad)
            for a in arrays]


def _close(got, want, tol, rel=False):
    got = numpy.asarray(got.detach().float().numpy(), numpy.float32)
    want = numpy.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(numpy.abs(want).max())) if rel else 1.0
    numpy.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_and_lse_match_pallas(shape, causal):
    from veles_tpu_torch.ops.flash_attention import (
        default_scale, flash_fwd_plain)
    q, k, v, _ = _inputs(shape, 1)
    b, sq, sk, h, d, dv = shape
    want = pallas_attention(*_jax((q, k, v), jnp.float32), causal=causal,
                            backend="cpu")
    o, lse = flash_fwd_plain(*_torch((q, k, v), torch.float32), causal)
    assert o.shape == (b, sq, h, dv) and lse.shape == (b, h, sq)
    _close(o, want, F32["out"])

    def flat(t):
        return jnp.swapaxes(jnp.asarray(t), 1, 2).reshape(
            b * h, t.shape[1], t.shape[3])

    bq, bk = max(sq, 16), max(sk, 16)
    pad = [jnp.pad(flat(t), ((0, 0), (0, n - t.shape[1]), (0, 0)))
           for t, n in ((q, bq), (k, bk), (v, bk))]
    _, want_lse = _run_fwd(*pad, default_scale(d), causal, bq, bk, True, sk)
    _close(lse.reshape(b * h, sq), want_lse[:, :sq, 0], F32["out"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES[1:4], ids=str)
def test_function_gradients_match_pallas(shape, causal):
    from veles_tpu_torch.ops.flash_attention import flash_attention
    q, k, v, g = _inputs(shape, 2)

    def f(a, b, c):
        return jnp.sum(pallas_attention(a, b, c, causal=causal,
                                        backend="cpu") * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*_jax((q, k, v), jnp.float32))
    tq, tk, tv = _torch((q, k, v), torch.float32, grad=True)
    (flash_attention(tq, tk, tv, causal) * torch.as_tensor(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, F32["grad"])


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_forward_and_gradients(causal):
    """The bf16 path (the training dtype): P rounds to bf16 before its
    products, outputs and gradients are bf16."""
    from veles_tpu_torch.ops.flash_attention import flash_attention
    q, k, v, g = _inputs((2, 40, 40, 2, 16, 16), 3)
    jq, jk, jv = _jax((q, k, v), jnp.bfloat16)
    jg = jnp.asarray(g, jnp.bfloat16)

    def f(a, b, c):
        o = pallas_attention(a, b, c, causal=causal, backend="cpu")
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    want_o = pallas_attention(jq, jk, jv, causal=causal, backend="cpu")
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _torch((q, k, v), torch.bfloat16, grad=True)
    o = flash_attention(tq, tk, tv, causal)
    assert o.dtype == torch.bfloat16
    _close(o, want_o, BF16, rel=True)
    tg = torch.as_tensor(g).to(torch.bfloat16).float()
    (o.float() * tg).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.bfloat16
        _close(got, w, BF16, rel=True)


def test_plain_backward_matches_autograd_of_the_forward():
    """flash_bwd_plain (P recomputed from the LSE) equals autograd
    through the plain forward, for dv != d."""
    from veles_tpu_torch.ops.flash_attention import (
        flash_bwd_plain, flash_fwd_plain)
    q, k, v, g = _inputs((1, 24, 30, 2, 16, 8), 4)
    tq, tk, tv = _torch((q, k, v), torch.float32, grad=True)
    o, lse = flash_fwd_plain(tq, tk, tv, True)
    (o * torch.as_tensor(g)).sum().backward()
    with torch.no_grad():
        got = flash_bwd_plain(tq, tk, tv, torch.as_tensor(g), o, lse, True)
    for a, b in zip(got, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """No CUDA tensor here, so the checks themselves: an unbuilt head
    width names itself, and a CPU tensor never reaches a kernel."""
    from veles_tpu_torch.ops import flash_attention as fa
    q = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="head_dim 64 is not built"):
        fa._check("flash_attn_fwd", q.to("meta"), q.to("meta"),
                  q.to("meta"))
    before = dict(fa.launches)
    fa.flash_attention(q, q, q, causal=True)
    assert fa.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,block", [((2, 32, 32, 2, 16, 16), 8),
                                         ((1, 37, 45, 2, 16, 8), 16),
                                         ((1, 30, 19, 2, 16, 16), 64)],
                         ids=str)
def test_dense_and_blockwise_cores_match_jax(shape, block, causal):
    """The cores ``mha_apply`` takes off the kernel rule: dense, and
    blockwise (ragged last block, sq != sk)."""
    from veles_tpu.ops.attention import attention as jax_dense
    from veles_tpu.ops.attention import blockwise_attention as jax_blockwise
    from veles_tpu_torch.ops.attention import attention, blockwise_attention
    q, k, v, _ = _inputs(shape, 5)
    jq, jk, jv = _jax((q, k, v), jnp.float32)
    tq, tk, tv = _torch((q, k, v), torch.float32)
    _close(blockwise_attention(tq, tk, tv, block, causal),
           jax_blockwise(jq, jk, jv, block, causal), F32["out"])
    if shape[-1] == shape[-2]:
        _close(attention(tq, tk, tv, causal), jax_dense(jq, jk, jv, causal),
               F32["out"])
