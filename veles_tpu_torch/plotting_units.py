"""The plotting unit family (the port of ``veles_tpu/plotting_units.py``).

Each unit snapshots host-visible training state into a renderer payload
(see :mod:`veles_tpu_torch.plotter`), the reference's payloads key for
key; the matplotlib side lives in :mod:`veles_tpu_torch.graphics_client`.
A watched value may be a number, a numpy array, an
:class:`~veles_tpu_torch.memory.Array` or a torch tensor on any device
(copied to the host once per payload).
"""

import numpy
import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.plotter import Plotter


def host_value(v):
    """``v`` on the host: an Array's host copy, a tensor copied to the
    host as numpy, a 0-d array as its scalar."""
    if isinstance(v, Array):
        v.map_read()
        v = v.mem
    if torch.is_tensor(v):
        v = v.detach().float().cpu().numpy() if v.is_floating_point() \
            else v.detach().cpu().numpy()
    if isinstance(v, numpy.ndarray) and v.ndim == 0:
        v = v.item()
    return v


def _value_of(obj, attr):
    return host_value(getattr(obj, attr))


class AccumulatingPlotter(Plotter):
    """A scalar curve over time: reads ``<obj>.<attr>`` each run and
    appends it to the named series."""

    def __init__(self, workflow, obj=None, attr=None, label=None,
                 ylabel="value", **kwargs):
        super(AccumulatingPlotter, self).__init__(workflow, **kwargs)
        self.obj = obj
        self.attr = attr
        self.label = label or attr
        self.ylabel = ylabel
        self.series = []
        self.demand("obj", "attr")

    def payload(self):
        v = _value_of(self.obj, self.attr)
        if v is None:
            return None
        self.series.append(float(v))
        return {"kind": "curve", "ylabel": self.ylabel,
                "series": {self.label: list(self.series)}}


class MatrixPlotter(Plotter):
    """A confusion-matrix heatmap of an array attribute (e.g. an
    evaluator's ``confusion_matrix``)."""

    def __init__(self, workflow, obj=None, attr="confusion_matrix",
                 **kwargs):
        super(MatrixPlotter, self).__init__(workflow, **kwargs)
        self.obj = obj
        self.attr = attr
        self.demand("obj")

    def payload(self):
        m = _value_of(self.obj, self.attr)
        if m is None:
            return None
        return {"kind": "matrix", "data": numpy.asarray(m).tolist()}


class ImagePlotter(Plotter):
    """An image grid of an array's rows: weight filters or samples."""

    def __init__(self, workflow, obj=None, attr="weights", limit=16,
                 sample_shape=None, **kwargs):
        super(ImagePlotter, self).__init__(workflow, **kwargs)
        self.obj = obj
        self.attr = attr
        self.limit = limit
        self.sample_shape = sample_shape
        self.demand("obj")

    def payload(self):
        w = _value_of(self.obj, self.attr)
        if w is None:
            return None
        w = numpy.asarray(w, numpy.float32)
        if w.ndim == 4:  # HWIO conv kernels → [O, H, W], mean over I
            tiles = numpy.transpose(w.mean(axis=2), (2, 0, 1))
        elif w.ndim == 2:
            side = self.sample_shape
            if side is None:
                n = int(numpy.sqrt(w.shape[0]))
                side = (n, n) if n * n == w.shape[0] else None
            if side is None:
                return None
            tiles = w.T.reshape(-1, *side)
        else:
            tiles = w.reshape((-1,) + w.shape[-2:])
        tiles = tiles[:self.limit]
        return {"kind": "images", "tiles": tiles.tolist()}


class Histogram(Plotter):
    """The value histogram of one array."""

    def __init__(self, workflow, obj=None, attr="weights", bins=30,
                 **kwargs):
        super(Histogram, self).__init__(workflow, **kwargs)
        self.obj = obj
        self.attr = attr
        self.bins = bins
        self.demand("obj")

    def payload(self):
        v = _value_of(self.obj, self.attr)
        if v is None:
            return None
        counts, edges = numpy.histogram(
            numpy.asarray(v).ravel(), bins=self.bins)
        return {"kind": "histogram", "counts": counts.tolist(),
                "edges": edges.tolist()}


class MultiHistogram(Plotter):
    """One histogram of each forward unit's weights (units without
    ``weights`` skipped)."""

    def __init__(self, workflow, forwards=None, bins=20, **kwargs):
        super(MultiHistogram, self).__init__(workflow, **kwargs)
        self.forwards = forwards
        self.bins = bins
        self.demand("forwards")

    def payload(self):
        hists = {}
        for i, u in enumerate(self.forwards):
            w = _weights_of(u)
            if w is None:
                continue
            counts, edges = numpy.histogram(
                numpy.asarray(host_value(w)).ravel(), bins=self.bins)
            hists[getattr(u, "name", None) or "unit%d" % i] = {
                "counts": counts.tolist(), "edges": edges.tolist()}
        if not hists:
            return None
        return {"kind": "multi_histogram", "layers": hists}


def _weights_of(unit):
    """A forward unit's ``weights``: the port's units keep them in
    ``params``, the JAX package's as ``param_arrays()``."""
    params = getattr(unit, "params", None)
    if isinstance(params, dict):
        return params.get("weights")
    return unit.param_arrays().get("weights")


class TableMaxMin(Plotter):
    """A max/min text table over watched arrays."""

    def __init__(self, workflow, **kwargs):
        super(TableMaxMin, self).__init__(workflow, **kwargs)
        self.watched = []  # (label, obj, attr)

    def watch(self, label, obj, attr):
        self.watched.append((label, obj, attr))
        return self

    def payload(self):
        rows = []
        for label, obj, attr in self.watched:
            v = numpy.asarray(_value_of(obj, attr))
            rows.append([label, float(v.max()), float(v.min())])
        if not rows:
            return None
        return {"kind": "table", "header": ["array", "max", "min"],
                "rows": rows}


class SlaveStats(Plotter):
    """The per-worker state table of a master's coordinator."""

    def __init__(self, workflow, coordinator=None, **kwargs):
        super(SlaveStats, self).__init__(workflow, **kwargs)
        self.coordinator = coordinator
        self.demand("coordinator")

    def payload(self):
        rows = [[w.id, w.state, round(w.power, 1), w.jobs_done]
                for w in self.coordinator.workers.values()]
        return {"kind": "table",
                "header": ["worker", "state", "power", "jobs"],
                "rows": rows}
