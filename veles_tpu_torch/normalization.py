"""Pluggable data normalizers (the port of ``veles_tpu/normalization.py``).

Registry-addressed by ``MAPPING`` name (ref: veles/normalization.py:110),
with the reference's analyze / normalize / denormalize + picklable
``state`` contract.  Analysis and normalization run on the host over
numpy arrays, at a loader's initialize time, as in the reference; the
reference's arithmetic is kept operation for operation, so the port's
state and output equal its own.

Kinds (ref MAPPING classes, normalization.py:260-642): none, linear,
range_linear, mean_disp, external_mean, internal_mean, exp, pointwise.
"""

import numpy

from veles_tpu_torch.unit_registry import MappedUnitRegistry


class UninitializedStateError(Exception):
    pass


class NormalizerBase(metaclass=MappedUnitRegistry):
    """analyze(data) accumulates statistics; normalize(data) -> data
    transformed; denormalize inverts it (ref: normalization.py:124)."""

    mapping_root = True
    hide_from_registry = True

    def __init__(self, state=None, **kwargs):
        self._initialized = False
        if state is not None:
            self.state = state

    # -- state ----------------------------------------------------------------

    @property
    def is_initialized(self):
        return self._initialized

    @property
    def state(self):
        """Picklable dict of accumulated statistics."""
        return {k: v for k, v in self.__dict__.items()
                if not k.endswith("_")}

    @state.setter
    def state(self, value):
        self.__dict__.update(value)

    #: constructor configuration preserved across reset() (statistics
    #: are discarded, configuration is not)
    CONFIG_ATTRS = ()

    def reset(self):
        cfg = {a: getattr(self, a) for a in self.CONFIG_ATTRS}
        fresh = type(self)()
        self.__dict__.clear()
        self.__dict__.update(fresh.__dict__)
        self.__dict__.update(cfg)
        self._post_reset()

    def _post_reset(self):
        pass

    # -- contract -------------------------------------------------------------

    def analyze(self, data):
        """Accumulate statistics over one batch (numpy)."""
        self._initialized = True

    def _assert_initialized(self):
        if not self._initialized:
            raise UninitializedStateError(
                "%s: analyze() never ran" % type(self).__name__)

    def normalize(self, data):
        raise NotImplementedError()

    def denormalize(self, data):
        raise NotImplementedError()

    def analyze_and_normalize(self, data):
        self.analyze(data)
        return self.normalize(data)


class StatelessNormalizer(NormalizerBase):
    """Needs no analysis pass (ref: normalization.py:260)."""

    hide_from_registry = True

    def __init__(self, state=None, **kwargs):
        super(StatelessNormalizer, self).__init__(state, **kwargs)
        self._initialized = True

    def analyze(self, data):
        pass


class NoneNormalizer(StatelessNormalizer):
    """Identity (ref: normalization.py "none")."""

    MAPPING = "none"

    def normalize(self, data):
        return data

    def denormalize(self, data):
        return data


class LinearNormalizer(StatelessNormalizer):
    """Scale each *sample* into [vmin, vmax] by its own extrema
    (ref: normalization.py:347 "linear")."""

    MAPPING = "linear"
    CONFIG_ATTRS = ("interval",)

    def __init__(self, state=None, interval=(-1.0, 1.0), **kwargs):
        self.interval = tuple(interval)
        super(LinearNormalizer, self).__init__(state, **kwargs)

    def normalize(self, data):
        vmin, vmax = self.interval
        flat = data.reshape(data.shape[0], -1)
        lo = flat.min(axis=1, keepdims=True)
        hi = flat.max(axis=1, keepdims=True)
        span = hi - lo
        span = span + (span == 0)
        out = (flat - lo) / span * (vmax - vmin) + vmin
        return out.reshape(data.shape).astype(data.dtype)

    def denormalize(self, data):
        raise NotImplementedError(
            "per-sample linear normalization is not invertible")


class RangeLinearNormalizer(NormalizerBase):
    """Scale by the global extrema of the training set into [vmin, vmax]
    (ref: normalization.py:398 "range_linear")."""

    MAPPING = "range_linear"
    CONFIG_ATTRS = ("interval",)

    def __init__(self, state=None, interval=(-1.0, 1.0), **kwargs):
        self.interval = tuple(interval)
        self.dmin = None
        self.dmax = None
        super(RangeLinearNormalizer, self).__init__(state, **kwargs)

    def analyze(self, data):
        dmin = float(numpy.min(data))
        dmax = float(numpy.max(data))
        self.dmin = dmin if self.dmin is None else min(self.dmin, dmin)
        self.dmax = dmax if self.dmax is None else max(self.dmax, dmax)
        self._initialized = True

    def normalize(self, data):
        self._assert_initialized()
        vmin, vmax = self.interval
        span = (self.dmax - self.dmin) or 1.0
        return ((data - self.dmin) / span * (vmax - vmin) + vmin).astype(
            data.dtype)

    def denormalize(self, data):
        self._assert_initialized()
        vmin, vmax = self.interval
        span = (self.dmax - self.dmin) or 1.0
        return ((data - vmin) / (vmax - vmin) * span + self.dmin).astype(
            data.dtype)


class MeanDispNormalizer(NormalizerBase):
    """Subtract per-feature mean, divide by per-feature peak-to-peak
    dispersion (ref: normalization.py:284 "mean_disp")."""

    MAPPING = "mean_disp"

    def __init__(self, state=None, **kwargs):
        self.sum = None
        self.count = 0
        self.dmin = None
        self.dmax = None
        super(MeanDispNormalizer, self).__init__(state, **kwargs)

    def analyze(self, data):
        arr = numpy.asarray(data, numpy.float64)
        s = arr.sum(axis=0)
        self.sum = s if self.sum is None else self.sum + s
        self.count += arr.shape[0]
        dmin = arr.min(axis=0)
        dmax = arr.max(axis=0)
        self.dmin = dmin if self.dmin is None \
            else numpy.minimum(self.dmin, dmin)
        self.dmax = dmax if self.dmax is None \
            else numpy.maximum(self.dmax, dmax)
        self._initialized = True

    @property
    def mean(self):
        self._assert_initialized()
        return (self.sum / max(self.count, 1)).astype(numpy.float32)

    @property
    def rdisp(self):
        self._assert_initialized()
        disp = (self.dmax - self.dmin)
        disp = disp + (disp == 0)
        return (1.0 / disp).astype(numpy.float32)

    def normalize(self, data):
        dt = data.dtype
        return ((data - self.mean) * self.rdisp).astype(dt)

    def denormalize(self, data):
        return (data / self.rdisp + self.mean).astype(data.dtype)


class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a user-provided mean array
    (ref: normalization.py "external_mean")."""

    MAPPING = "external_mean"
    CONFIG_ATTRS = ("mean_source",)

    def _post_reset(self):
        if self.mean_source is not None:
            self._initialized = True

    def __init__(self, state=None, mean_source=None, **kwargs):
        self.mean_source = None
        if mean_source is not None:
            self.mean_source = numpy.asarray(mean_source)
        super(ExternalMeanNormalizer, self).__init__(state, **kwargs)
        if self.mean_source is not None:
            self._initialized = True

    def analyze(self, data):
        if self.mean_source is None:
            raise ValueError("external_mean requires mean_source")
        self._initialized = True

    def normalize(self, data):
        self._assert_initialized()
        return (data - self.mean_source.astype(data.dtype)).astype(data.dtype)

    def denormalize(self, data):
        self._assert_initialized()
        return (data + self.mean_source.astype(data.dtype)).astype(data.dtype)


class InternalMeanNormalizer(NormalizerBase):
    """Subtract the training-set mean (ref: "internal_mean")."""

    MAPPING = "internal_mean"

    def __init__(self, state=None, **kwargs):
        self.sum = None
        self.count = 0
        super(InternalMeanNormalizer, self).__init__(state, **kwargs)

    def analyze(self, data):
        arr = numpy.asarray(data, numpy.float64)
        s = arr.sum(axis=0)
        self.sum = s if self.sum is None else self.sum + s
        self.count += arr.shape[0]
        self._initialized = True

    @property
    def mean(self):
        self._assert_initialized()
        return (self.sum / max(self.count, 1)).astype(numpy.float32)

    def normalize(self, data):
        return (data - self.mean.astype(data.dtype)).astype(data.dtype)

    def denormalize(self, data):
        return (data + self.mean.astype(data.dtype)).astype(data.dtype)


class ExpNormalizer(StatelessNormalizer):
    """Sigmoid squash (ref: normalization.py "exp")."""

    MAPPING = "exp"

    def normalize(self, data):
        return (1.0 / (1.0 + numpy.exp(-numpy.asarray(
            data, numpy.float32)))).astype(data.dtype)

    def denormalize(self, data):
        arr = numpy.clip(numpy.asarray(data, numpy.float32), 1e-7, 1 - 1e-7)
        return numpy.log(arr / (1.0 - arr)).astype(data.dtype)


class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map into [-1, 1] computed from per-feature
    extrema (ref: normalization.py "pointwise")."""

    MAPPING = "pointwise"

    def __init__(self, state=None, **kwargs):
        self.dmin = None
        self.dmax = None
        super(PointwiseNormalizer, self).__init__(state, **kwargs)

    def analyze(self, data):
        arr = numpy.asarray(data)
        dmin = arr.min(axis=0)
        dmax = arr.max(axis=0)
        self.dmin = dmin if self.dmin is None \
            else numpy.minimum(self.dmin, dmin)
        self.dmax = dmax if self.dmax is None \
            else numpy.maximum(self.dmax, dmax)
        self._initialized = True

    def normalize(self, data):
        self._assert_initialized()
        span = self.dmax - self.dmin
        span = span + (span == 0)
        out = (data - self.dmin.astype(data.dtype)) \
            / span.astype(data.dtype) * 2.0 - 1.0
        return out.astype(data.dtype)

    def denormalize(self, data):
        self._assert_initialized()
        span = self.dmax - self.dmin
        span = span + (span == 0)
        return ((data + 1.0) / 2.0 * span.astype(data.dtype)
                + self.dmin.astype(data.dtype)).astype(data.dtype)


def get_normalizer(name, **kwargs):
    """Factory by MAPPING name (ref: NormalizerRegistry)."""
    cls = MappedUnitRegistry.get_factory("NormalizerBase", name)
    return cls(**kwargs)
