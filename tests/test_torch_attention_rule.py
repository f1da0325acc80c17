"""The port's attention-core selection
(``veles_tpu_torch/models/attention.py::select_core``) held against the
JAX package's rule as ``veles_tpu/models/attention.py::mha_apply``
applies it.  The JAX function runs here with its four cores replaced by
recorders, on the backend that stands for the card (``"tpu"``, where
its rule picks its Pallas kernel for every ``head_dim % 128 == 0``) and
on ``"cpu"``; the port's rule must pick the same core, except that by
default it sends the FlashAttention kernels only the head dims they are
built for (``KERNEL_HEAD_DIMS``): any other head dim takes the core the
JAX rule takes off its kernel (blockwise when ``block_size`` is set,
else dense) instead of raising on the card."""

import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.torch_port

HEAD_DIMS = (64, 128, 256, 384, 512)
IMPLS = (None, "auto", "pallas", "flash", "blockwise", "dense")


def _jax_choice(monkeypatch, backend, head_dim, block_size, attn_impl):
    """The cores JAX's ``mha_apply`` calls for one head of ``head_dim``
    on ``backend``."""
    import veles_tpu.ops.attention as jax_attention
    import veles_tpu.ops.flash as jax_flash
    import veles_tpu.ops.pallas_attention as jax_pallas
    from veles_tpu.models.attention import mha_apply
    called = []

    def recorder(name):
        def core(q, k, v, *args, **kwargs):
            called.append(name)
            return q
        return core

    monkeypatch.setattr(jax_pallas, "pallas_attention", recorder("pallas"))
    monkeypatch.setattr(jax_flash, "flash_attention", recorder("flash"))
    monkeypatch.setattr(jax_attention, "blockwise_attention",
                        recorder("blockwise"))
    monkeypatch.setattr(jax_attention, "attention", recorder("dense"))
    params = {n: jnp.zeros((head_dim, head_dim), jnp.float32)
              for n in ("wq", "wk", "wv", "wo")}
    mha_apply(params, jnp.zeros((1, 2, head_dim), jnp.float32), 1, True,
              block_size, attn_impl=attn_impl, backend=backend)
    return called


@pytest.mark.parametrize("attn_impl", IMPLS, ids=str)
@pytest.mark.parametrize("block_size", [None, 16], ids=str)
@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_select_core_follows_the_jax_rule(monkeypatch, head_dim, device,
                                          block_size, attn_impl):
    from veles_tpu_torch.models.attention import select_core
    from veles_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS
    backend = "tpu" if device == "cuda" else "cpu"
    (want,) = _jax_choice(monkeypatch, backend, head_dim, block_size,
                          attn_impl)
    if attn_impl in (None, "auto") and head_dim not in KERNEL_HEAD_DIMS \
            and want == "pallas":
        want = "blockwise" if block_size else "dense"
    assert select_core(device, head_dim, block_size, attn_impl) == want


@pytest.mark.parametrize("head_dim", [384, 512])
def test_unbuilt_head_dims_are_the_jax_kernel_dims(monkeypatch, head_dim):
    """The head dims the port keeps off its kernels are ones the JAX
    rule sends to its kernel on the accelerator: the case the rule's
    one difference exists for."""
    from veles_tpu_torch.models.attention import select_core
    assert _jax_choice(monkeypatch, "tpu", head_dim, None, None) \
        == ["pallas"]
    assert select_core("cuda", head_dim) == "dense"
    assert select_core("cuda", head_dim, attn_impl="pallas") == "pallas"
