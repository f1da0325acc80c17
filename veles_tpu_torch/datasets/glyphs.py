"""Procedural handwritten-digit stand-in, MNIST-shaped (28x28 gray) —
the port of ``veles_tpu/datasets/glyphs.py``.

Each digit class is a stroke skeleton (polyline segments in a unit
box).  Every rendered sample applies a random affine warp (rotation,
anisotropic scale, shear, translation), per-endpoint jitter and a
random stroke width, then draws intensity as a soft distance field —
max over segments of exp(-d^2 / 2*sigma^2) — plus pixel noise.  All
geometry is vectorized numpy.
"""

import numpy

# stroke skeletons per digit, unit box (x right, y DOWN), as polylines
_POLYLINES = {
    0: [[(.3, .15), (.7, .15), (.82, .5), (.7, .85), (.3, .85),
         (.18, .5), (.3, .15)]],
    1: [[(.35, .3), (.55, .15), (.55, .85)]],
    2: [[(.25, .3), (.4, .15), (.65, .15), (.75, .35), (.25, .85),
         (.75, .85)]],
    3: [[(.25, .2), (.65, .15), (.72, .33), (.5, .48), (.72, .65),
         (.65, .85), (.25, .8)]],
    4: [[(.6, .85), (.6, .15), (.22, .6), (.8, .6)]],
    5: [[(.7, .15), (.3, .15), (.28, .45), (.65, .45), (.74, .65),
         (.6, .85), (.28, .8)]],
    6: [[(.65, .15), (.35, .35), (.25, .62), (.4, .85), (.62, .82),
         (.72, .62), (.55, .48), (.3, .55)]],
    7: [[(.25, .15), (.75, .15), (.45, .85)]],
    8: [[(.5, .15), (.7, .25), (.62, .46), (.38, .52), (.3, .72),
         (.5, .85), (.7, .72), (.62, .52), (.38, .46), (.3, .25),
         (.5, .15)]],
    9: [[(.7, .4), (.5, .5), (.3, .4), (.32, .2), (.55, .13),
         (.7, .25), (.66, .6), (.5, .85)]],
}


def _segments(cls):
    segs = []
    for line in _POLYLINES[cls]:
        pts = numpy.asarray(line, numpy.float32)
        segs.append(numpy.concatenate([pts[:-1], pts[1:]], axis=1))
    return numpy.concatenate(segs, axis=0)  # [S, 4] = x1 y1 x2 y2


_SEGS = [_segments(c) for c in range(10)]
_MAX_S = max(len(s) for s in _SEGS)
#: [10, S, 4], zero-padded; padded segments carry weight 0
_SEG_BANK = numpy.zeros((10, _MAX_S, 4), numpy.float32)
_SEG_MASK = numpy.zeros((10, _MAX_S), numpy.float32)
for _c, _s in enumerate(_SEGS):
    _SEG_BANK[_c, :len(_s)] = _s
    _SEG_MASK[_c, :len(_s)] = 1.0


def render_digits(n, seed=0, size=28, noise=0.14, jitter=0.024,
                  max_rot=0.42, shear=0.28, seg_dropout=0.03,
                  distractor_p=0.12, _chunk=4096):
    """Render ``n`` digit samples; returns (images [n,size,size] f32 in
    [0,1], labels [n] int64).

    ``seg_dropout`` (random missing stroke pieces) and ``distractor_p``
    (a random extra stroke) give the task *irreducible* ambiguity so a
    large training set can't drive the error to zero — without them a
    60k corpus was memorizable to 0.13% where real MNIST sits at
    ~1.5%."""
    if n > _chunk:
        # the [chunk, S, size*size] distance field is the memory peak —
        # render in slabs
        parts = [render_digits(min(_chunk, n - i), seed + 7919 * i,
                               size, noise, jitter, max_rot, shear,
                               seg_dropout, distractor_p)
                 for i in range(0, n, _chunk)]
        return (numpy.concatenate([p[0] for p in parts]),
                numpy.concatenate([p[1] for p in parts]))
    rng = numpy.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    segs = _SEG_BANK[labels].copy()          # [n, S, 4]
    mask = _SEG_MASK[labels].copy()          # [n, S]

    # per-endpoint jitter (bends strokes sample-to-sample)
    segs += rng.normal(scale=jitter, size=segs.shape).astype(
        numpy.float32)

    # stroke-piece dropout: erase random segments (pen skips)
    mask = mask * (rng.random(mask.shape) >= seg_dropout)

    # distractor stroke: one random short segment (pen smudge)
    has_extra = rng.random(n) < distractor_p
    p0 = rng.uniform(0.15, 0.85, (n, 2)).astype(numpy.float32)
    p1 = p0 + rng.uniform(-0.3, 0.3, (n, 2)).astype(numpy.float32)
    extra = numpy.concatenate([p0, p1], axis=1)[:, None, :]  # [n,1,4]
    segs = numpy.concatenate([segs, extra], axis=1)
    mask = numpy.concatenate(
        [mask, has_extra[:, None].astype(numpy.float32)], axis=1)

    # random affine about the glyph center
    theta = rng.uniform(-max_rot, max_rot, n)
    sx = rng.uniform(0.72, 1.12, n)
    sy = rng.uniform(0.72, 1.12, n)
    sh = rng.uniform(-shear, shear, n)
    tx = rng.uniform(-0.09, 0.09, n)
    ty = rng.uniform(-0.09, 0.09, n)
    ct, st = numpy.cos(theta), numpy.sin(theta)
    # A = R(theta) @ Shear @ diag(sx, sy)
    a00 = ct * sx + (-st) * sh * sx
    a01 = (-st) * sy
    a10 = st * sx + ct * sh * sx
    a11 = ct * sy
    for off in (0, 2):  # both endpoints
        x = segs[:, :, off] - 0.5
        y = segs[:, :, off + 1] - 0.5
        segs[:, :, off] = (a00[:, None] * x + a01[:, None] * y
                           + 0.5 + tx[:, None])
        segs[:, :, off + 1] = (a10[:, None] * x + a11[:, None] * y
                               + 0.5 + ty[:, None])

    # soft distance field on the pixel grid
    px = (numpy.arange(size, dtype=numpy.float32) + 0.5) / size
    gx, gy = numpy.meshgrid(px, px)          # [size, size], gy rows
    gx = gx.ravel()[None, None, :]           # [1, 1, P]
    gy = gy.ravel()[None, None, :]
    x1 = segs[:, :, 0:1]
    y1 = segs[:, :, 1:2]
    dx = segs[:, :, 2:3] - x1
    dy = segs[:, :, 3:4] - y1
    seg_len2 = numpy.maximum(dx * dx + dy * dy, 1e-8)
    t = ((gx - x1) * dx + (gy - y1) * dy) / seg_len2
    t = numpy.clip(t, 0.0, 1.0)
    d2 = (gx - (x1 + t * dx)) ** 2 + (gy - (y1 + t * dy)) ** 2
    sigma = rng.uniform(0.022, 0.042, n).astype(numpy.float32)
    field = numpy.exp(-d2 / (2 * sigma[:, None, None] ** 2))
    field = field * mask[:, :, None]
    img = field.max(axis=1).reshape(n, size, size)

    img += rng.normal(scale=noise, size=img.shape)
    return numpy.clip(img, 0.0, 1.0).astype(numpy.float32), labels
