"""Device-side uniform fill — the port of ``veles_tpu/ops/random.py``
(kernel 5, ``pallas_uniform``).

The TPU kernel reads the TPU's hardware PRNG, whose bits have no
specification elsewhere.  Every path it stands in for on the card draws
``jax.random.uniform``'s Threefry stream (the synthetic ImageNet
dataset, the dropout masks), so the port's kernel computes exactly that
stream (``csrc/uniform.cu``): :func:`uniform` equals
``jax.random.uniform(key, shape)`` bit for bit, on the card through the
kernel and on the CPU through :func:`uniform_plain`
(``prng.threefry.uniform``).

Keys are ``[2]`` int64 words (``prng.threefry``).  The kernel takes the
words as launch arguments, so a key that lies on the host costs the
launch no device→host read; the trainer keeps its keys there.
"""

import ctypes

import torch

from veles_tpu_torch import _build
from veles_tpu_torch.backends import resolve_device
from veles_tpu_torch.ops import check_cuda_inputs, ptr, require, stream_ptr
from veles_tpu_torch.prng import threefry

#: kernel launches so far (the wrapper adds one per launch)
launches = 0

_argtypes_set = False


def uniform_plain(k, shape, offset=0):
    """Plain version: ``jax.random.uniform(k, shape)`` in torch integer
    ops on ``k``'s device (``offset`` shifts the element index, as in
    ``threefry.random_bits``)."""
    return threefry.uniform(k, shape, offset=offset)


def _lib():
    global _argtypes_set
    lib = _build.library("uniform")
    if not _argtypes_set:
        lib.veles_uniform_fill.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.veles_uniform_fill.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def uniform_fill(k, shape, device, offset=0):
    """The kernel wrapper: a float32 tensor of ``shape`` on the CUDA
    ``device`` holding :func:`uniform_plain` ``(k, shape, offset)``.
    ``k`` may lie anywhere (a key on the card is read back first)."""
    global launches
    device = torch.device(device)
    require(device.type == "cuda", "uniform_fill: unsupported device %s",
            device)
    words = [int(w) for w in torch.as_tensor(k).reshape(-1).tolist()]
    require(len(words) == 2 and all(0 <= w <= threefry.MASK for w in words),
            "uniform_fill: a key is two 32-bit words, got %s", words)
    require(0 <= int(offset) < 2 ** 64, "uniform_fill: offset %s", offset)
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                      device=device)
    check_cuda_inputs("uniform_fill", out.device, out=out)
    if out.numel():
        rc = _lib().veles_uniform_fill(words[0], words[1], int(offset),
                                       out.numel(), ptr(out),
                                       stream_ptr(out.device))
        _build.check(rc, "uniform_fill launch")
        launches += 1
    return out


def uniform(key_or_seed, shape, device=None):
    """Uniform [0, 1) float32 of ``shape``: ``jax.random.uniform(key,
    shape)`` where an int seed stands for ``key(seed)`` (as the JAX
    package's ``uniform(..., use_pallas=False)``).  Drawn on ``device``
    (default: the key's device for a key tensor, else the card): the
    kernel on the card, the plain version on the CPU."""
    if isinstance(key_or_seed, int):
        k = threefry.key(key_or_seed)
        dev = resolve_device(device)
    else:
        k = key_or_seed
        dev = k.device if device is None else resolve_device(device)
    if dev.type == "cpu":
        return uniform_plain(k.to(dev), shape)
    return uniform_fill(k, shape, dev)


def pallas_uniform(seed, shape, device=None):
    """The counterpart of the TPU's ``pallas_uniform(seed, shape)``: the
    uniform draw keyed on ``key(seed & 0x7FFFFFFF)`` (the JAX package
    masks the seed to the 31 bits its hardware seed register takes)."""
    return uniform(threefry.key(int(seed) & 0x7FFFFFFF), shape,
                   device=resolve_device(device))
