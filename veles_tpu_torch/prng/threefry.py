"""Threefry-2x32 and the ``jax.random`` draws the port must reproduce
bit for bit, in torch integer ops.

JAX's default PRNG is Threefry-2x32 (20 rounds) over a key of two
32-bit words.  The functions here follow ``jax._src.prng`` and
``jax._src.random`` as they run with ``jax_threefry_partitionable``
on (the default since jax 0.5):

- ``key(seed)`` of a 32-bit seed is ``[0, seed]``;
- ``fold_in(key, data)`` hashes the count pair ``(0, data)`` under
  ``key``: the two output words are the new key;
- ``split(key, num)`` hashes the counts ``(0, i)``: key ``i`` is the
  pair of output words (so ``split(k)[i] == fold_in(k, i)``);
- ``random_bits(key, shape)`` hashes ``(hi, lo)`` of each element's
  row-major index under ``key`` and XORs the two output words;
- ``uniform`` puts the top 23 bits in a float's mantissa in [1, 2)
  and subtracts 1; ``bernoulli(key, p, shape)`` is
  ``uniform(key, shape) < float32(p)``;
- ``randint(key, shape, minval, maxval)`` (int32) splits the key,
  draws a higher and a lower 32-bit word per element and reduces the
  pair modulo ``span = maxval - minval`` through the multiplier
  ``(2**16 % span)**2 % span``, in uint32 arithmetic;
- ``categorical`` is the Gumbel-argmax draw, with
  ``-log(-log(uniform(tiny, 1)))``.

Words are held as int64 tensors in [0, 2**32): torch has no full
uint32 arithmetic, and int64 keeps every sum and shift exact before
the mask.  Keys are ``[..., 2]`` int64 tensors, so a batch of
per-request keys is one tensor and every draw is vectorized.
"""

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: smallest normal float32 (``jnp.finfo(jnp.float32).tiny``)
F32_TINY = 1.1754943508222875e-38


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of count words ``(x0, x1)`` under key
    words ``(k0, k1)`` (int64 tensors of 32-bit values, broadcast
    together); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed, device=None):
    """``jax.random.key(seed)`` of a 32-bit seed (an int or an
    integer tensor of seeds): ``[..., 2]`` int64 words ``[0, seed]``."""
    s = torch.as_tensor(seed, device=device).to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: ``k`` [..., 2], ``data`` an
    int or integer tensor broadcasting against ``k[..., 0]`` (taken
    as uint32, as JAX casts it)."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k, num=2):
    """``jax.random.split(k, num)``: [..., num, 2] keys; key ``i`` is
    the hash of the count ``(0, i)``."""
    i = torch.arange(int(num), dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., None, 0], k[..., None, 1],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k, shape, offset=0):
    """``jax.random.bits(k, shape)`` (32-bit): [..., *shape] int64
    words for keys ``k`` [..., 2]; element ``i`` (row-major) hashes
    the count ``(j >> 32, j & MASK)`` of its index ``j = offset + i``
    (``offset`` 0 is JAX's draw; others reach the count's high word
    without 2**32 elements)."""
    shape = tuple(int(n) for n in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device) + int(offset)
    lead = k.shape[:-1]
    view = lead + (1,) * len(shape)
    k0 = k[..., 0].reshape(view)
    k1 = k[..., 1].reshape(view)
    y0, y1 = threefry2x32(k0, k1, (idx >> 32).reshape(shape),
                          (idx & MASK).reshape(shape))
    return y0 ^ y1


def uniform(k, shape, minval=0.0, maxval=1.0, offset=0):
    """``jax.random.uniform(k, shape, float32, minval, maxval)``
    (``offset`` as in :func:`random_bits`)."""
    bits = random_bits(k, shape, offset)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    # XLA fuses the scale and shift into one fused multiply-add (one
    # rounding); the product of two floats is exact in float64, so
    # the sum taken there and rounded once gives the same float
    fused = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def bernoulli(k, p, shape):
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < float32(p)``."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32)


I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(k, shape, minval, maxval):
    """``jax.random.randint(k, shape, minval, maxval)`` (int32): an
    int32 tensor of ``shape`` on ``k``'s device; ``minval``/``maxval``
    ints or integer tensors broadcasting against ``shape``."""
    shape = tuple(int(n) for n in shape)
    dev = k.device
    lo = torch.as_tensor(minval, device=dev).to(torch.int64)
    hi = torch.as_tensor(maxval, device=dev).to(torch.int64)
    # a maxval past the type's top widens the span by one (JAX's
    # randint(..., 0, 256, uint8) rule), after both are clipped
    hi_out = hi > I32_MAX
    lo = lo.clamp(I32_MIN, I32_MAX).expand(shape)
    hi = hi.clamp(I32_MIN, I32_MAX).expand(shape)
    hi_out = hi_out.expand(shape)
    keys = split(k)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    span = torch.where(hi_out & (hi > lo), (span + 1) & MASK, span)
    # a span that wrapped to 0 leaves the words as they are (XLA's
    # unsigned remainder by zero)
    safe = torch.where(span == 0, torch.ones_like(span), span)

    def rem(x):
        return torch.where(span == 0, x, x % safe)

    mult = rem(torch.full_like(span, 2 ** 16))
    mult = rem((mult * mult) & MASK)
    off = (rem(higher) * mult) & MASK
    off = rem((off + rem(lower)) & MASK)
    # uint32 -> int32 and the int32 add wrap as XLA's do
    out = (lo + off) & MASK
    return torch.where(out > I32_MAX, out - 2 ** 32, out).to(torch.int32)


def gumbel(k, shape):
    """``jax.random.gumbel(k, shape)`` (float32, the default "low"
    mode)."""
    return -torch.log(-torch.log(uniform(k, shape, F32_TINY, 1.0)))


def categorical(k, logits):
    """``jax.random.categorical`` over the last axis, one key per
    row: ``k`` [..., 2], ``logits`` [..., V] float32 → [...] int64."""
    g = gumbel(k, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
