"""In-step data augmentation — the port of ``veles_tpu/ops/augment.py``.

The trainer applies the configured augment to train minibatches only,
on the device, inside its step (``models/gd.py``); evaluation sees
clean data.  Every draw is the JAX package's for the same key: the
flip is ``bernoulli(kf, 0.5, (b,))`` drawn through
``ops.random.uniform`` (the uniform kernel on the card, as dropout's
masks are), the crop offsets and the cutout boxes are
``threefry.randint`` draws.  Keys lie on the host, so the offsets are
computed there and cross to the card as a few integers: no step waits
on a device read.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import random as ops_random
from veles_tpu_torch.prng import threefry


def image_augment(flip=True, pad=0, cutout=0, shape=None):
    """Random horizontal flip, random crop after reflect-padding
    ``pad`` pixels, and an optional ``cutout``-sized erased box.
    Returns ``fn(x, key)`` for [batch, h, w, c] inputs, or for flat
    [batch, features] minibatches when ``shape=(h, w, c)`` is given."""

    def fn(x, key):
        flat_in = shape is not None and x.dim() == 2
        if flat_in:
            x = x.reshape((x.shape[0],) + tuple(shape))
        b, h, w, c = x.shape
        dev = x.device
        kf, kc, ku = threefry.split(key, 3).unbind(-2)
        if flip:
            do = ops_random.uniform(kf, (b,), device=dev) \
                < torch.tensor(0.5, dtype=torch.float32, device=dev)
            x = torch.where(do[:, None, None, None], x.flip(2), x)
        if pad:
            xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                       mode="reflect").permute(0, 2, 3, 1)
            off = threefry.randint(kc, (b, 2), 0, 2 * pad + 1).to(
                device=dev, dtype=torch.int64)
            rows = off[:, 0:1] + torch.arange(h, device=dev)
            cols = off[:, 1:2] + torch.arange(w, device=dev)
            x = xp[torch.arange(b, device=dev)[:, None, None],
                   rows[:, :, None], cols[:, None, :]]
        if cutout:
            # an exactly cutout x cutout box, top-left anchored, which
            # may hang off the edge (Python's floor division, as the
            # reference's -cutout // 2)
            cy = threefry.randint(ku, (b,), -cutout // 2, h).to(dev)
            cx = threefry.randint(threefry.fold_in(ku, 1), (b,),
                                  -cutout // 2, w).to(dev)
            yy = torch.arange(h, device=dev)[None, :, None]
            xx = torch.arange(w, device=dev)[None, None, :]
            cy = cy[:, None, None]
            cx = cx[:, None, None]
            mask = (yy >= cy) & (yy < cy + cutout) & (xx >= cx) \
                & (xx < cx + cutout)
            x = torch.where(mask[..., None],
                            torch.zeros((), dtype=x.dtype, device=dev), x)
        if flat_in:
            x = x.reshape(b, h * w * c)
        return x

    return fn


def make_augment(kind, **kwargs):
    """Config-friendly factory: ``kind`` names the recipe."""
    if kind in ("image", "flip_crop"):
        return image_augment(**kwargs)
    raise ValueError("unknown augment kind %r" % (kind,))
