"""Procedural GTZAN stand-in — ten synthetic "genres" of music-like
audio written as a GTZAN-layout wav tree (the port of
``veles_tpu/datasets/tones.py``; the same tracks for the same seed).

Each genre is a parametric style over the dimensions the feature
pipeline measures — spectral centre and rolloff (register and harmonic
rolloff), zero crossings (noisiness), the energy envelope and the beat
autocorrelation (tempo and beat sharpness).  Per-track jitter overlaps
neighbouring styles so no single feature separates them.
"""

import getpass
import hashlib
import os
import tempfile

import numpy

#: style table: fundamental (Hz), harmonic count, harmonic decay,
#: tempo (BPM), beat depth, noise floor, noise lowpass (Hz or None)
GENRES = {
    "drone":     dict(f0=82,  nh=9, decay=0.92, bpm=0,   beat=0.0,
                      noise=0.04, cut=900),
    "ballad":    dict(f0=147, nh=6, decay=0.80, bpm=72,  beat=0.35,
                      noise=0.06, cut=2400),
    "folk":      dict(f0=196, nh=5, decay=0.70, bpm=96,  beat=0.45,
                      noise=0.08, cut=3600),
    "pop":       dict(f0=262, nh=4, decay=0.62, bpm=118, beat=0.65,
                      noise=0.10, cut=5200),
    "dance":     dict(f0=220, nh=3, decay=0.55, bpm=132, beat=0.85,
                      noise=0.12, cut=7000),
    "techno":    dict(f0=110, nh=2, decay=0.50, bpm=144, beat=0.95,
                      noise=0.16, cut=9000),
    "rock":      dict(f0=330, nh=6, decay=0.75, bpm=126, beat=0.70,
                      noise=0.22, cut=8000),
    "metal":     dict(f0=392, nh=8, decay=0.85, bpm=152, beat=0.75,
                      noise=0.30, cut=None),
    "ambient":   dict(f0=523, nh=3, decay=0.45, bpm=56,  beat=0.15,
                      noise=0.05, cut=1800),
    "noisewave": dict(f0=660, nh=2, decay=0.40, bpm=84,  beat=0.50,
                      noise=0.40, cut=None),
}

#: pentatonic steps the per-track melody walks over (semitone ratios)
_SCALE = (1.0, 9 / 8, 5 / 4, 3 / 2, 5 / 3, 2.0)


def synth_track(style, rng, seconds=10.0, rate=22050):
    """One track of the given style: a melodic walk of harmonic notes
    with a beat-gated amplitude envelope over coloured noise."""
    n = int(seconds * rate)
    t = numpy.arange(n) / rate
    # WIDE jitter: neighbouring styles must overlap per-track or the
    # task saturates (a first cut with ±18%/±30% probed at 97% logreg
    # accuracy — nothing like real genres; these ranges landed the
    # probe in the literature band, see the module docstring)
    jit = lambda v, frac: v * rng.uniform(1 - frac, 1 + frac)
    f0 = jit(style["f0"], 0.45)
    decay = min(0.97, jit(style["decay"], 0.30))
    bpm = jit(style["bpm"], 0.30) if style["bpm"] else 0.0
    beat_depth = min(1.0, jit(style["beat"], 0.55)) if style["beat"] \
        else 0.0
    noise_level = jit(style["noise"], 0.75)
    nh = max(1, int(round(jit(style["nh"], 0.4))))

    # melodic walk: a new scale note every ~0.5 s
    note_len = int(0.5 * rate)
    n_notes = n // note_len + 1
    steps = rng.integers(0, len(_SCALE), n_notes)
    freq = numpy.repeat(f0 * numpy.take(_SCALE, steps), note_len)[:n]
    phase = 2 * numpy.pi * numpy.cumsum(freq) / rate

    sig = numpy.zeros(n, numpy.float32)
    for h in range(1, nh + 1):
        sig += (decay ** (h - 1)) * numpy.sin(h * phase).astype(
            numpy.float32)
    sig /= max(1.0, numpy.abs(sig).max())

    if bpm:
        beat_hz = bpm / 60.0
        env = (1 - beat_depth) + beat_depth * numpy.clip(
            numpy.sin(2 * numpy.pi * beat_hz * t
                      + rng.uniform(0, 2 * numpy.pi)) * 4, 0, 1)
        sig = sig * env.astype(numpy.float32)

    noise = rng.normal(0, 1, n).astype(numpy.float32)
    cut = style["cut"]
    if cut:
        # one-pole lowpass colours the noise (shifts ZCR + rolloff)
        alpha = numpy.exp(-2 * numpy.pi * cut / rate)
        from scipy.signal import lfilter
        noise = lfilter([1 - alpha], [1, -alpha], noise).astype(
            numpy.float32)
        noise /= max(1e-6, numpy.abs(noise).max())
    sig = sig + noise_level * noise
    return (0.8 * sig / max(1e-6, numpy.abs(sig).max())).astype(
        numpy.float32)


def default_cache_dir(tracks_per_genre=40, seconds=10.0, rate=22050,
                      seed=4242):
    """Per-user, parameter-hashed cache path: a shared machine's /tmp
    can't collide across users, and changing the generator parameters
    (or the style table) invalidates the cache instead of silently
    reusing a stale tree.  The directory's name is the port's own, so
    the two packages never read each other's generated trees."""
    recipe = hashlib.sha256(repr(
        (sorted(GENRES.items()), _SCALE, tracks_per_genre, seconds,
         rate, seed)).encode()).hexdigest()[:12]
    user = getpass.getuser() or "nouser"
    return os.path.join(tempfile.gettempdir(),
                        "veles_tpu_torch_tones_%s_%s" % (user, recipe))


def generate(dest=None, tracks_per_genre=40, seconds=10.0, rate=22050,
             seed=4242):
    """Write the GTZAN-layout wav tree ``dest/<genre>/<idx>.wav``
    (default: :func:`default_cache_dir`); returns the tree path.
    Idempotent: skips generation when the tree is already complete."""
    if dest is None:
        dest = default_cache_dir(tracks_per_genre, seconds, rate, seed)
    from scipy.io import wavfile
    rng = numpy.random.default_rng(seed)
    complete = all(
        os.path.isfile(os.path.join(
            dest, g, "%05d.wav" % (tracks_per_genre - 1)))
        for g in GENRES)
    if complete:
        return dest
    for genre, style in GENRES.items():
        d = os.path.join(dest, genre)
        os.makedirs(d, exist_ok=True)
        for i in range(tracks_per_genre):
            sig = synth_track(style, rng, seconds, rate)
            wavfile.write(os.path.join(d, "%05d.wav" % i), rate,
                          (sig * 32767).astype(numpy.int16))
    return dest
