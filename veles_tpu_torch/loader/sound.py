"""Sound loaders (the port of ``veles_tpu/loader/sound.py``).

Decoding goes through libsndfile via ctypes where the library is
installed, else through ``scipy.io.wavfile`` (scipy is imported when a
file is decoded).  Decoded audio is float32 in [-1, 1], [n] mono or
[n, channels].
"""

import ctypes
import ctypes.util
import os

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader

SOUND_EXTENSIONS = (".wav", ".flac", ".ogg", ".aiff", ".au")


def _decode_scipy(path):
    from scipy.io import wavfile
    rate, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(numpy.float32) / numpy.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        info = numpy.iinfo(data.dtype)
        data = (data.astype(numpy.float32) - info.max / 2) / (info.max / 2)
    else:
        data = data.astype(numpy.float32)
    return data, rate


class _Libsndfile:
    """Minimal ctypes binding (ref: veles/loader/libsndfile.py:42)."""

    class SF_INFO(ctypes.Structure):
        _fields_ = [("frames", ctypes.c_int64),
                    ("samplerate", ctypes.c_int),
                    ("channels", ctypes.c_int),
                    ("format", ctypes.c_int),
                    ("sections", ctypes.c_int),
                    ("seekable", ctypes.c_int)]

    def __init__(self):
        name = ctypes.util.find_library("sndfile")
        if not name:
            raise OSError("libsndfile not found")
        lib = ctypes.CDLL(name)
        lib.sf_open.restype = ctypes.c_void_p
        lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(self.SF_INFO)]
        lib.sf_readf_float.restype = ctypes.c_int64
        lib.sf_readf_float.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.sf_close.argtypes = [ctypes.c_void_p]
        self.lib = lib

    def decode(self, path):
        info = self.SF_INFO()
        handle = self.lib.sf_open(path.encode(), 0x10, info)  # SFM_READ
        if not handle:
            raise OSError("libsndfile cannot open %s" % path)
        try:
            buf = numpy.zeros(info.frames * info.channels, numpy.float32)
            got = self.lib.sf_readf_float(
                handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                info.frames)
            data = buf[:got * info.channels]
            if info.channels > 1:
                data = data.reshape(-1, info.channels)
            return data, info.samplerate
        finally:
            self.lib.sf_close(handle)


_sndfile = None


def decode_sound(path):
    """File → (float32 samples, sample_rate)."""
    global _sndfile
    if _sndfile is None:
        try:
            _sndfile = _Libsndfile()
        except OSError:
            _sndfile = False
    if _sndfile:
        try:
            return _sndfile.decode(path)
        except OSError:
            pass
    return _decode_scipy(path)


class SoundLoader(FullBatchLoader):
    """Directory-scanning audio loader: label = parent directory (the
    GTZAN corpus layout, genres/<genre>/<track>.wav), samples = feature
    vectors from a :mod:`veles_tpu_torch.snd_features` XML pipeline
    (ref: veles/loader/libsndfile_loader.py + genre_recognition.xml)."""

    def __init__(self, workflow=None, features_xml=None, train_paths=(),
                 validation_paths=(), test_paths=(), max_seconds=None,
                 **kwargs):
        super(SoundLoader, self).__init__(workflow, **kwargs)
        self.features_xml = features_xml
        self.class_paths = [list(test_paths), list(validation_paths),
                            list(train_paths)]
        self.max_seconds = max_seconds
        self._tree = None

    def scan(self):
        keys = [[], [], []]
        for ci, paths in enumerate(self.class_paths):
            for p in paths:
                if os.path.isdir(p):
                    for dirpath, _, files in sorted(os.walk(p)):
                        for fn in sorted(files):
                            if fn.lower().endswith(SOUND_EXTENSIONS):
                                keys[ci].append(
                                    os.path.join(dirpath, fn))
                elif os.path.isfile(p):
                    keys[ci].append(p)
        return keys

    def features_of(self, path):
        from veles_tpu_torch.snd_features import (
            FeatureExtractor, parse_features_xml)
        data, rate = decode_sound(path)
        if self.max_seconds:
            data = data[:int(self.max_seconds * rate)]
        if self._tree is None:
            self._tree = parse_features_xml(self.features_xml)
        feats = FeatureExtractor(self._tree, rate).extract(data)
        return numpy.concatenate([feats[k] for k in sorted(feats)])

    def load_data(self):
        keys = self.scan()
        samples, labels = [], []
        lengths = []
        for ci in (0, 1, 2):
            for path in keys[ci]:
                samples.append(self.features_of(path))
                labels.append(os.path.basename(os.path.dirname(path)))
            lengths.append(len(keys[ci]))
        if not samples:
            raise ValueError("%s: no sound files found" % self)
        # tracks of unequal length produce unequal Stats rows: pad to
        # the longest vector (zero-padded tail, the reference padded
        # feature streams the same way)
        width = max(len(s) for s in samples)
        data = numpy.zeros((len(samples), width), numpy.float32)
        for i, s in enumerate(samples):
            data[i, :len(s)] = s
        self.class_lengths[:] = lengths
        self.original_data = data
        mapping = {l: i for i, l in enumerate(sorted(set(labels)))}
        self.labels_mapping = mapping
        # original_labels carries the RAW directory names — fullbatch's
        # _post_load maps them through labels_mapping (pre-mapping here
        # would double-map every label to the -1 sentinel)
        self.original_labels = list(labels)
