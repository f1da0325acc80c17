"""Procedural object-scene stand-in, CIFAR-shaped (32x32 RGB) — the
port of ``veles_tpu/datasets/scenes.py``.

Ten shape classes rendered over noisy gradient backgrounds with
randomized colour, position, scale and rotation.  Colours are drawn
independently of the class, so a classifier must read shape.
Difficulty comes from scale and rotation ranges, low-contrast draws,
pixel noise, a random occluding bar and per-class morphs toward a
neighbouring class.

Classes: 0 disk, 1 ring, 2 triangle, 3 square, 4 cross, 5 horizontal
stripes, 6 vertical stripes, 7 checker, 8 crescent, 9 dumbbell.
"""

import numpy


def _rot(gx, gy, cx, cy, theta):
    ct, st = numpy.cos(theta), numpy.sin(theta)
    x = gx - cx[:, None, None]
    y = gy - cy[:, None, None]
    return (ct[:, None, None] * x + st[:, None, None] * y,
            -st[:, None, None] * x + ct[:, None, None] * y)


def _shape_mask(cls, gx, gy, rng, n):
    """Soft [n, H, W] mask in [0,1] for one class.

    Every class has a *morph* parameter sweeping part of its population
    toward another class's appearance (fat ring -> disk, fat cross ->
    square, huge stripe period -> blob, shallow crescent bite -> disk,
    merged dumbbell -> disk…).  That overlap is the irreducible
    ambiguity that keeps a large training set from driving the error
    to zero — the CIFAR-like part of the task."""
    cx = rng.uniform(0.35, 0.65, n)
    cy = rng.uniform(0.35, 0.65, n)
    r = rng.uniform(0.16, 0.3, n)
    # bounded rotation: under uniform 0..2pi the horizontal- and
    # vertical-stripe classes would be the SAME distribution (so would
    # rotated checkers) — +-20 degrees keeps orientation a label signal
    # while still forcing rotation tolerance
    theta = rng.uniform(-0.35, 0.35, n)
    morph = rng.uniform(0.0, 1.0, n)[:, None, None]
    x, y = _rot(gx, gy, cx, cy, theta)
    rr = r[:, None, None]
    soft = 60.0
    d = numpy.sqrt(x * x + y * y)
    if cls == 0:      # disk
        m = d - rr
    elif cls == 1:    # ring; fat rings (high morph) approach the disk
        m = numpy.abs(d - rr * (1 - 0.3 * morph)) \
            - (0.2 + 0.55 * morph) * rr
    elif cls == 2:    # triangle (3 half-planes)
        k = numpy.sqrt(3.0)
        m = numpy.maximum.reduce([y - rr * 0.5,
                                  -y - k * x - rr * 0.5,
                                  -y + k * x - rr * 0.5]) / 1.5
    elif cls == 3:    # square
        m = numpy.maximum(numpy.abs(x), numpy.abs(y)) - rr * 0.85
    elif cls == 4:    # cross; fat arms (high morph) approach the square
        w = (0.25 + 0.5 * morph) * rr
        arm = numpy.minimum(
            numpy.maximum(numpy.abs(x) - w, numpy.abs(y) - rr),
            numpy.maximum(numpy.abs(y) - w, numpy.abs(x) - rr))
        m = arm
    elif cls == 5:    # horizontal stripes; huge periods show one band
        period = (0.6 + 1.4 * morph[:, :, 0:1]) * rr
        band = numpy.abs(((y / period) % 1.0) - 0.5) - 0.22
        m = numpy.maximum(band * period * 2, d - 1.6 * rr)
    elif cls == 6:    # vertical stripes
        period = (0.6 + 1.4 * morph[:, :, 0:1]) * rr
        band = numpy.abs(((x / period) % 1.0) - 0.5) - 0.22
        m = numpy.maximum(band * period * 2, d - 1.6 * rr)
    elif cls == 7:    # checker; huge cells look like stripes/squares
        period = (0.7 + 1.3 * morph[:, :, 0:1]) * rr
        sq = (numpy.floor(x / period) + numpy.floor(y / period)) % 2
        m = numpy.where(sq > 0.5, -0.01, 0.01) + 0 * d
        m = numpy.maximum(m, d - 1.6 * rr)
    elif cls == 8:    # crescent; shallow bites approach the disk
        off = (0.25 + 0.6 * morph) * rr
        d2 = numpy.sqrt((x - off) ** 2 + y * y)
        m = numpy.maximum(d - rr, -(d2 - 0.75 * rr))
    else:             # dumbbell; fat bars merge into one blob
        da = numpy.sqrt((x - 0.8 * rr) ** 2 + y * y) - 0.55 * rr
        db = numpy.sqrt((x + 0.8 * rr) ** 2 + y * y) - 0.55 * rr
        bar = numpy.maximum(numpy.abs(y) - (0.1 + 0.45 * morph) * rr,
                            numpy.abs(x) - 0.8 * rr)
        m = numpy.minimum.reduce([da, db, bar])
    return 1.0 / (1.0 + numpy.exp(soft * m))


def render_scenes(n, seed=0, size=32, noise=0.07, contrast_min=0.4,
                  label_noise=0.115, _chunk=4096):
    """Render ``n`` scenes; returns (images [n,size,size,3] f32 in
    [0,1], labels [n] int64).

    ``label_noise`` uniformly corrupts that fraction of labels (train
    AND validation, like real annotation noise).  The class morphs
    above supply ~4% of irreducible confusion; the label noise supplies
    the rest (the JAX package's calibration against the caffe-quick
    net puts ``label_noise=0.115`` near CIFAR-10's published error).
    Set ``label_noise=0`` for the clean variant."""
    if n > _chunk:
        parts = [render_scenes(min(_chunk, n - i), seed + 104729 * i,
                               size, noise, contrast_min, label_noise)
                 for i in range(0, n, _chunk)]
        return (numpy.concatenate([p[0] for p in parts]),
                numpy.concatenate([p[1] for p in parts]))
    rng = numpy.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    px = (numpy.arange(size, dtype=numpy.float32) + 0.5) / size
    gxx, gyy = numpy.meshgrid(px, px)
    gx = gxx[None]  # [1, H, W] broadcast over samples
    gy = gyy[None]

    # background: linear gradient between two random colors + noise
    c0 = rng.uniform(0.0, 1.0, (n, 1, 1, 3)).astype(numpy.float32)
    c1 = rng.uniform(0.0, 1.0, (n, 1, 1, 3)).astype(numpy.float32)
    ang = rng.uniform(0, 2 * numpy.pi, n)
    t = (numpy.cos(ang)[:, None, None] * gxx[None]
         + numpy.sin(ang)[:, None, None] * gyy[None])
    t = (t - t.min(axis=(1, 2), keepdims=True))
    t = t / numpy.maximum(t.max(axis=(1, 2), keepdims=True), 1e-6)
    img = c0 + (c1 - c0) * t[..., None]

    # object color: random, pushed away from the local background mean
    # by at least `contrast_min` so shapes are visible but can be faint
    obj = rng.uniform(0.0, 1.0, (n, 3)).astype(numpy.float32)
    bg_mean = (c0[:, 0, 0] + c1[:, 0, 0]) / 2
    delta = obj - bg_mean
    norm = numpy.linalg.norm(delta, axis=1, keepdims=True)
    scale = numpy.maximum(contrast_min / numpy.maximum(norm, 1e-6), 1.0)
    obj = numpy.clip(bg_mean + delta * scale, 0, 1)

    mask = numpy.zeros((n, size, size), numpy.float32)
    for cls in range(10):
        sel = labels == cls
        k = int(sel.sum())
        if k:
            mask[sel] = _shape_mask(cls, gx, gy, rng, k)
    img = img + mask[..., None] * (obj[:, None, None, :] - img)

    # occluding bar (random thin stripe of a third color)
    occ = rng.random(n) < 0.35
    if occ.any():
        k = int(occ.sum())
        oc = rng.uniform(0, 1, (k, 1, 1, 3)).astype(numpy.float32)
        pos = rng.uniform(0.1, 0.9, k)
        width = rng.uniform(0.04, 0.1, k)
        horiz = rng.random(k) < 0.5
        coord = numpy.where(horiz[:, None, None], gyy[None], gxx[None])
        bar = (numpy.abs(coord - pos[:, None, None])
               < width[:, None, None]).astype(numpy.float32)
        sub = img[occ]
        img[occ] = sub + bar[..., None] * (oc - sub)

    img += rng.normal(scale=noise, size=img.shape)

    if label_noise > 0:
        flip = rng.random(n) < label_noise
        labels = numpy.where(flip, rng.integers(0, 10, n), labels)
    return numpy.clip(img, 0, 1).astype(numpy.float32), labels
