"""Inference packages — the port of ``veles_tpu/package_export.py``.

An archive (``.tar.gz``) of::

    contents.json     manifest: workflow name and checksum, the unit
                      list (class name, class id, config, parameter
                      files), the input spec
    u<i>_<param>.npy  one npy per parameter

— the JAX package's format, byte for byte in its ``.npy`` files and
key for key in ``contents.json``: each unit carries the class name and
the class id of the JAX package's class of the same name (uuid5 of
``veles_tpu.<module>.<Class>`` in the unit registry's namespace) and
its ``export_config()``, whose keys are that class's, so the C++ runner
in ``runtime/`` (which keys on the class name), the JAX package's
``load_package`` and this module's read each other's archives.
``format_version`` is 1, raised to 2 only when a unit's config holds a
:data:`V2_KEYS` key.

Consumers: :func:`load_package` rebuilds the forward units from their
class (by either package's id, else by name) and
:meth:`PackagedWorkflow.run` runs them in "python" mode on the device
(``cuda`` unless the caller asks for the CPU), where the units launch
their kernels (the LRN and FlashAttention kernels among them).

The JAX package also writes ``forward.shlo``, its chain serialized by
``jax.export``.  The port has no such exporter: it writes ``"stablehlo":
null``, the JAX package's own manifest when ``jax.export`` is
unavailable, and ``run(mode="stablehlo")`` raises, on the port's
archives and on the JAX package's (whose program it does not read).
"""

import io
import json
import tarfile
import uuid

import numpy
import torch

#: the highest format this reader understands; writers stamp the lowest
#: version whose features a package uses (:data:`V2_KEYS`)
FORMAT_VERSION = 2
#: unit-config keys that require a v2 reader
V2_KEYS = ("block_size", "attn_block_size", "space_to_depth")

#: the unit registry's namespace (``unit_registry._NAMESPACE``)
_NAMESPACE = uuid.UUID("6ba7b812-9dad-11d1-80b4-00c04fd430c8")

#: config keys of the JAX package's units that the port's constructors
#: do not take: the port's units always carry a bias and are filled by
#: ``convert``; an int8 checkpoint is told by its ``*_scale`` arrays
_NOT_CONSTRUCTOR_KEYS = ("weights_filling", "include_bias", "weights_int8")

_NO_STABLEHLO = (
    "mode='stablehlo' runs the jax.export program the JAX package "
    "writes as forward.shlo; the port writes none (\"stablehlo\": null) "
    "and reads none from an archive that carries one — run "
    "mode='python'")


def reference_id(cls):
    """The class id the JAX package's class of the same name carries:
    uuid5 over ``veles_tpu.<module>.<Class>``."""
    module = "veles_tpu" + cls.__module__[len("veles_tpu_torch"):]
    return str(uuid.uuid5(_NAMESPACE, module + "." + cls.__name__))


def port_id(cls):
    """The id the port's own registry would give ``cls``."""
    return str(uuid.uuid5(_NAMESPACE, cls.__module__ + "." + cls.__name__))


def _unit_name(i, unit):
    """The unit's name: its own (``make_forwards`` names units as the
    JAX package does, ``<layer type><index>``), else by its class."""
    name = getattr(unit, "name", None)
    if name:
        return name
    from veles_tpu_torch.models.standard import LAYER_TYPES
    for ltype, cls in LAYER_TYPES.items():
        if cls is type(unit):
            return "%s%d" % (ltype, i)
    return "%s%d" % (type(unit).__name__, i)


def _unit_entry(i, unit):
    params, blobs = {}, {}
    for name, t in unit.params.items():
        fname = "u%d_%s.npy" % (i, name)
        params[name] = fname
        blobs[fname] = t.detach().cpu().numpy()
    cls = type(unit)
    return {
        "name": _unit_name(i, unit),
        "class": cls.__name__,
        "uuid": reference_id(cls),
        "config": unit.export_config(),
        "params": params,
    }, blobs


def export_package(forwards, path, input_shape, input_dtype=numpy.float32,
                   name="workflow", checksum=""):
    """Write the package archive of the forward chain ``forwards`` (the
    port's units, holding their parameters) at ``path``.

    ``input_shape[0]`` (the batch) is baked: :meth:`PackagedWorkflow.run`
    and the C++ runner pad a smaller batch to it."""
    manifest = {
        "format": "veles_tpu",
        "format_version": 1,
        "workflow": name,
        "checksum": checksum,
        "input": {"shape": [int(d) for d in input_shape],
                  "dtype": numpy.dtype(input_dtype).name},
        "units": [],
        "stablehlo": None,
    }
    blobs = {}
    for i, u in enumerate(forwards):
        entry, params = _unit_entry(i, u)
        manifest["units"].append(entry)
        blobs.update(params)
        if any(k in entry["config"] for k in V2_KEYS):
            manifest["format_version"] = 2

    # level 1: float32 parameters shrink by about a tenth at any level,
    # and level 9 takes several times as long; every level reads back
    # the same
    with tarfile.open(path, "w:gz", compresslevel=1) as tar:
        def add_bytes(fname, data):
            info = tarfile.TarInfo(fname)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        add_bytes("contents.json",
                  json.dumps(manifest, indent=1).encode())
        for fname, arr in blobs.items():
            buf = io.BytesIO()
            numpy.save(buf, arr)
            add_bytes(fname, buf.getvalue())
    return path


class PackagedWorkflow:
    """A loaded package: its forward units, built on ``device``, run on
    new inputs."""

    def __init__(self, manifest, units, device):
        self.manifest = manifest
        self.units = units
        self.device = device

    @property
    def input_shape(self):
        return tuple(self.manifest["input"]["shape"])

    def _pad_batch(self, x):
        batch = self.input_shape[0]
        if x.shape[0] > batch:
            raise ValueError("batch %d exceeds packaged %d"
                             % (x.shape[0], batch))
        if x.shape[0] < batch:
            pad = numpy.zeros((batch - x.shape[0],) + x.shape[1:],
                              x.dtype)
            return numpy.concatenate([x, pad]), x.shape[0]
        return x, x.shape[0]

    def to_device(self, device):
        from veles_tpu_torch.backends import resolve_device
        self.device = resolve_device(device)
        for u in self.units:
            u.to_device(self.device)
        return self

    def run(self, x, mode="python", device=None):
        """The forward chain's output (numpy) for ``x``: one sample or a
        batch of at most the packaged batch (padded to it, the padding
        cut from the output).  ``mode`` "python" runs the units on the
        package's device (``device`` moves them first); "stablehlo"
        raises (see the module docstring)."""
        if mode == "stablehlo":
            raise RuntimeError(_NO_STABLEHLO)
        if mode != "python":
            raise ValueError("mode must be 'python' or 'stablehlo', not %r"
                             % (mode,))
        if device is not None and torch.device(device) != self.device:
            self.to_device(device)
        x = numpy.asarray(x, self.manifest["input"]["dtype"])
        squeeze = x.ndim == len(self.input_shape) - 1
        if squeeze:
            x = x[None]
        x, n = self._pad_batch(x)
        with torch.no_grad():
            h = torch.as_tensor(x, device=self.device)
            for u in self.units:
                h = u.apply(h)
            y = h.float().cpu().numpy()[:n]
        return y[0] if squeeze else y


def _unit_classes():
    """Every class a package may name, by the JAX package's id, by the
    port's id and by name."""
    from veles_tpu_torch.models.standard import LAYER_TYPES
    by_id, by_name = {}, {}
    for cls in LAYER_TYPES.values():
        by_id[reference_id(cls)] = by_id[port_id(cls)] = cls
        by_name[cls.__name__] = cls
    return by_id, by_name


def load_package(path, device=None):
    """Read an archive (the port's or the JAX package's) into a
    :class:`PackagedWorkflow` whose units sit on ``device`` (default
    ``cuda``) in the compute dtype ``root.common.precision.compute_dtype``
    (bfloat16 unless set), as the JAX package's ``load_package`` reads
    it."""
    from veles_tpu_torch.backends import resolve_device
    from veles_tpu_torch.config import root
    dev = resolve_device(device)
    dtype = root.common.precision.get("compute_dtype", "bfloat16")
    with tarfile.open(path, "r:gz") as tar:
        files = {m.name: tar.extractfile(m).read()
                 for m in tar.getmembers() if m.isfile()}
    manifest = json.loads(files["contents.json"])
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError("package format %s is newer than this runtime"
                         % manifest["format_version"])
    by_id, by_name = _unit_classes()
    units = []
    for entry in manifest["units"]:
        cls = by_id.get(entry["uuid"]) or by_name.get(entry["class"])
        if cls is None:
            raise KeyError("no unit class for %s (%s)"
                           % (entry["class"], entry["uuid"]))
        config = dict(entry["config"])
        if config.get("include_bias", True) is False:
            raise ValueError("%s: the port's units always carry a bias"
                             % entry["name"])
        for k in _NOT_CONSTRUCTOR_KEYS:
            config.pop(k, None)
        unit = cls(device=dev, dtype=dtype, **config)
        unit.name = entry["name"]
        unit.load_params({
            name: numpy.load(io.BytesIO(files[fname]))
            for name, fname in entry["params"].items()})
        units.append(unit)
    return PackagedWorkflow(manifest, units, dev)
