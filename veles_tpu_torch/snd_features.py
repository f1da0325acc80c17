"""Sound feature extraction — the GTZAN pipeline (the port of
``veles_tpu/snd_features.py``).

An XML document (the reference's ``genre_recognition.xml`` schema)
describes a tree of ``<transform>`` nodes whose ``<feature name=.../>``
leaves name the outputs.  The DSP is numpy (scipy for the band split),
on the host: feature extraction is preprocessing, and the device sees
only the final feature matrix.

Transforms: Mix, Window, RDFT, ComplexMagnitude, Energy, ZeroCrossings,
Centroid, Rolloff, Flux, Peaks, Merge, Stats, Fork, FrequencyBands,
Rectify, Diff, Beat, PeakAnalysis, PeakDynamicProgramming.  The beat
chain is the JAX package's autocorrelation tempo estimator.
"""

import xml.etree.ElementTree as ET

import numpy


class TransformNode:
    """One ``<transform>`` (or the root ``<features>``) element."""

    def __init__(self, name, params=None, condition=None):
        self.name = name
        self.params = params or {}
        self.condition = condition
        self.children = []
        self.features = []  # leaf output names

    def __repr__(self):
        return "<%s %r>" % (self.name, self.params)


def _parse_params(text):
    out = {}
    if not text:
        return out
    for part in text.split(","):
        key, _, value = part.partition("=")
        out[key.strip()] = value.strip()
    return out


def parse_features_xml(source):
    """Parse a feature-tree XML (path or string) → root TransformNode
    (schema per veles/genre_recognition.xml)."""
    if "<" in source:
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()

    def walk(elem):
        node = TransformNode(
            elem.get("name", elem.tag),
            _parse_params(elem.get("parameters")),
            elem.get("condition"))
        for child in elem:
            if child.tag == "feature":
                node.features.append(child.get("name"))
            else:
                node.children.append(walk(child))
        return node

    top = TransformNode("features")
    for child in root:
        if child.tag == "feature":
            top.features.append(child.get("name"))
        else:
            top.children.append(walk(child))
    return top


# -- signal helpers -----------------------------------------------------------

_WINDOWS = {
    "hanning": numpy.hanning,
    "hamming": numpy.hamming,
    "blackman": numpy.blackman,
    "rectangular": numpy.ones,
}


def _frame(x, length, step):
    n = max(0, (len(x) - length) // step + 1)
    if n == 0:
        pad = numpy.zeros(length, x.dtype)
        pad[:len(x)] = x
        return pad[None, :]
    idx = numpy.arange(length)[None, :] + step * numpy.arange(n)[:, None]
    return x[idx]


class FeatureExtractor:
    """Executes a transform tree over one mono/stereo signal."""

    def __init__(self, tree, sample_rate=22050):
        self.tree = tree
        self.sample_rate = sample_rate

    def extract(self, signal):
        """signal: [n] mono or [n, channels] → {feature name: 1-D
        numpy array}."""
        out = {}
        self._run(self.tree, numpy.asarray(signal, numpy.float32), out)
        return {k: numpy.atleast_1d(numpy.asarray(v, numpy.float32)
                                    .ravel())
                for k, v in out.items()}

    # -- the walk -------------------------------------------------------------

    def _run(self, node, data, out):
        for name in node.features:
            out[name] = data
        for child in node.children:
            if child.condition and not self._condition(child.condition,
                                                       data):
                result = data  # condition false → identity (ref: Mix)
            else:
                result = self._apply(child, data)
            self._run(child, result, out)

    @staticmethod
    def _condition(cond, data):
        channels = data.shape[1] if data.ndim == 2 else 1
        return bool(eval(cond, {"__builtins__": {}},
                         {"channels": channels}))

    def _apply(self, node, data):
        fn = getattr(self, "_t_" + node.name.lower(), None)
        if fn is None:
            raise KeyError("unknown transform %r" % node.name)
        return fn(data, **node.params)

    # -- transforms -----------------------------------------------------------

    def _t_mix(self, data):
        return data.mean(axis=1) if data.ndim == 2 else data

    def _t_window(self, data, type="hanning", length="512", step=None,
                  interleaved=None):
        length = int(length)
        step = int(step) if step else length // 2
        if data.ndim > 1:  # band-split signals window per band
            return numpy.stack([
                self._t_window(band, type, str(length), str(step))
                for band in data])
        frames = _frame(data, length, step)
        return frames * _WINDOWS[type](length)[None, :]

    def _t_rdft(self, frames):
        return numpy.fft.rfft(frames, axis=-1)

    def _t_complexmagnitude(self, spec):
        return numpy.abs(spec)

    def _t_energy(self, frames):
        return numpy.sum(frames * frames, axis=-1)

    def _t_zerocrossings(self, frames):
        signs = numpy.signbit(frames)
        return numpy.sum(signs[..., 1:] != signs[..., :-1],
                         axis=-1).astype(numpy.float32)

    def _t_centroid(self, mag):
        freqs = numpy.arange(mag.shape[-1], dtype=numpy.float32)
        denom = numpy.maximum(mag.sum(axis=-1), 1e-12)
        return (mag * freqs).sum(axis=-1) / denom

    def _t_rolloff(self, mag, ratio="0.85"):
        ratio = float(ratio)
        cum = numpy.cumsum(mag, axis=-1)
        total = numpy.maximum(cum[..., -1:], 1e-12)
        return numpy.argmax(cum >= ratio * total,
                            axis=-1).astype(numpy.float32)

    def _t_flux(self, mag):
        diff = numpy.diff(mag, axis=0)
        flux = numpy.sqrt(numpy.sum(diff * diff, axis=-1))
        return numpy.concatenate([[0.0], flux])

    def _t_peaks(self, mag, number="10"):
        k = int(number)
        idx = numpy.argsort(mag, axis=-1)[..., -k:]
        vals = numpy.take_along_axis(mag, idx, axis=-1)
        return numpy.concatenate(
            [idx.astype(numpy.float32), vals], axis=-1)

    def _t_merge(self, frames):
        return numpy.asarray(frames).ravel()

    def _t_stats(self, series, interval="100", types=None):
        """Per-interval mean/stddev/skew/kurtosis (the reference Stats
        node's moment set)."""
        series = numpy.asarray(series, numpy.float64).ravel()
        interval = int(interval)
        chunks = [series[i:i + interval]
                  for i in range(0, max(len(series), 1), interval)]
        rows = []
        for c in chunks:
            if len(c) == 0:
                continue
            mean = c.mean()
            std = c.std()
            sd = std if std > 1e-12 else 1.0
            z = (c - mean) / sd
            rows.append([mean, std, (z ** 3).mean(), (z ** 4).mean()])
        return numpy.asarray(rows, numpy.float32).ravel()

    def _t_fork(self, data, factor="1"):
        return data  # children each get the same signal (ref Fork)

    def _t_frequencybands(self, data, bands="200 400 800 1600 3200",
                          filter="chebyshevII", lengths=None):
        """Chebyshev-II band-split → [n_bands+1, n] (ref
        FrequencyBands)."""
        from scipy import signal as sps
        edges = [float(b) for b in bands.split()]
        nyq = self.sample_rate / 2.0
        out = []
        lo = 0.0
        for hi in edges + [nyq * 0.99]:
            wl = max(lo / nyq, 1e-4)
            wh = min(hi / nyq, 0.99)
            if wl >= wh:
                continue
            if wl <= 1e-4:
                sos = sps.cheby2(4, 30, wh, "lowpass", output="sos")
            else:
                sos = sps.cheby2(4, 30, [wl, wh], "bandpass",
                                 output="sos")
            out.append(sps.sosfilt(sos, data))
            lo = hi
        return numpy.stack(out)

    def _t_rectify(self, data):
        return numpy.abs(data)

    def _t_diff(self, data, rectify="false", swt=None):
        d = numpy.diff(data, axis=-1)
        if str(rectify).lower() == "true":
            d = numpy.maximum(d, 0)
        return d

    def _t_beat(self, data, bands=None):
        """Onset-strength autocorrelation over summed bands →
        [lags, strength] rows (simplified tempo analysis)."""
        onset = data.sum(axis=tuple(range(data.ndim - 1))) \
            if data.ndim > 1 else data
        onset = onset - onset.mean()
        n = len(onset)
        if n < 4:
            return numpy.zeros((2, 2), numpy.float32)
        # FFT autocorrelation: the direct numpy.correlate is O(n^2)
        # and took 12s of a 15s GTZAN-track extraction; Wiener-
        # Khinchin via rfft is O(n log n) (the reference's C++
        # extractor used FFT convolution here too)
        m = 1 << int(2 * n - 1).bit_length()
        spec = numpy.fft.rfft(onset, m)
        ac = numpy.fft.irfft(spec * numpy.conj(spec), m)[:n]
        ac = ac / max(ac[0], 1e-12)
        return numpy.stack([numpy.arange(len(ac), dtype=numpy.float32),
                            ac.astype(numpy.float32)])

    def _t_peakanalysis(self, ac):
        """Top autocorrelation peaks (lag, strength) pairs."""
        lags, vals = ac[0], ac[1]
        if len(vals) < 3:
            return numpy.zeros(8, numpy.float32)
        interior = (vals[1:-1] > vals[:-2]) & (vals[1:-1] > vals[2:])
        peaks = numpy.where(interior)[0] + 1
        order = peaks[numpy.argsort(vals[peaks])[::-1]][:4]
        out = numpy.zeros(8, numpy.float32)
        for i, p in enumerate(order):
            out[2 * i] = lags[p]
            out[2 * i + 1] = vals[p]
        return out

    def _t_peakdynamicprogramming(self, ac, mind_values=None):
        """Dominant tempo lag (strongest interior peak)."""
        lags, vals = ac[0], ac[1]
        if len(vals) < 3:
            return numpy.zeros(1, numpy.float32)
        interior = (vals[1:-1] > vals[:-2]) & (vals[1:-1] > vals[2:])
        peaks = numpy.where(interior)[0] + 1
        if not len(peaks):
            return numpy.zeros(1, numpy.float32)
        best = peaks[numpy.argmax(vals[peaks])]
        return numpy.asarray([lags[best]], numpy.float32)


def extract_features(tree, signal, sample_rate=22050, flatten=True):
    """One-call API: XML tree (or its source) + signal → feature dict or
    the concatenated flat vector (sorted by feature name — the loader's
    stable MLP input layout)."""
    if isinstance(tree, str):
        tree = parse_features_xml(tree)
    feats = FeatureExtractor(tree, sample_rate).extract(signal)
    if not flatten:
        return feats
    return numpy.concatenate([feats[k] for k in sorted(feats)])
