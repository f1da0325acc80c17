"""``attn_impl="flash"`` — the port of ``veles_tpu/ops/flash.py``.

The JAX package routes this core to the flash kernel that ships with
JAX for the TPU.  It computes the same function as the package's own
kernel (``ops/pallas_attention.py``), so the port serves both through
one hand-written kernel: :func:`flash_attention` here is
``ops/flash_attention.flash_attention``, the forward and backward
kernels of ``csrc/flash_attention.cu`` on the card, their plain
versions on the CPU."""

from veles_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
