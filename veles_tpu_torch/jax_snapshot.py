"""Reading a snapshot file of the JAX package.

A snapshot of the JAX package pickles its live workflow: classes of
``veles_tpu.*`` (and of the workflow file the command line ran, such as
``mnist``), numpy arrays and builtin containers.  The port never
imports ``jax`` or ``veles_tpu`` to read one.  :class:`JaxUnpickler`,
a :class:`~veles_tpu_torch.safe_pickle.RestrictedUnpickler`, admits

- the numpy and builtin constructors of ``safe_pickle._ALLOWED``;
- each ``veles_tpu.<mod>.<Cls>`` whose counterpart
  ``veles_tpu_torch.<mod>.<Cls>`` exists in the port, and each class of
  a workflow file whose counterpart is a port sample
  (``veles_tpu_torch.samples.<file>``);
- the JAX package's own unpickling helpers (``_reconstruct``,
  ``_rebuild_bool``, ``Device``) and ``logging.getLogger``;
- the plotting units, which the port does not have yet (ROADMAP item
  11): they are dropped.

Anything else raises ``pickle.UnpicklingError`` with its name, before
any object of it is built.  No class's code runs while the file is
read: every object becomes a :class:`JaxObject`, its JAX class name and
its pickled state.

The port's workflow class then builds itself from those records
(``StandardWorkflow.from_jax``): its constructor's keyword arguments
come from the records (each sample class's ``jax_kwargs`` names its
own), and the state that training moves — the forward units'
parameters, the trainer's solver slots, step and key counter, the
loader's position, shuffle order, generator and normalizer state, the
decision's counters and gates, the snapshotter's interval state — is
taken over unit by unit (:func:`take_state`).  The resumed workflow
goes on as the JAX package's resumed workflow goes on.
"""

import copy
import importlib
import inspect
import io
import os
import pickle
import sys

import numpy
import torch

from veles_tpu_torch.safe_pickle import _ALLOWED, RestrictedUnpickler

_PORT_DIR = os.path.dirname(os.path.abspath(__file__))

#: JAX classes a snapshot may hold that the port does not have yet
#: (the plotting units, ROADMAP item 11): read as records, then dropped
DROPPED = {"veles_tpu.plotting_units"}


def names_jax_package(blob):
    """Whether a pickle ``blob`` names classes of the JAX package."""
    return b"veles_tpu." in blob.replace(b"veles_tpu_torch.", b"")


class JaxObject:
    """An object of the JAX package as its pickle holds it: the JAX
    class's name (``jax_name``), the port's counterpart (``port_cls``,
    None for a dropped class) and the pickled ``state``."""

    jax_name = None
    port_cls = None

    def __setstate__(self, state):
        self.state = state

    def get(self, name, default=None):
        return getattr(self, "state", {}).get(name, default)

    def __repr__(self):
        return "<JaxObject %s>" % self.jax_name


class JaxBool:
    """A ``veles_tpu.mutable.Bool`` as pickled: value, op, sources."""

    def __init__(self, state):
        self.state = state

    @property
    def value(self):
        return bool(self.state["value"])


def _reconstruct(cls):
    return cls.__new__(cls)


def _device(backend=None, index=0):
    return None


def _get_logger(name=None):
    return None


_HELPERS = {
    ("veles_tpu.distributable", "_reconstruct"): _reconstruct,
    ("veles_tpu.mutable", "_rebuild_bool"): JaxBool,
    ("veles_tpu.backends", "Device"): _device,
    ("logging", "getLogger"): _get_logger,
}

_record_classes = {}


def _record_class(jax_name, port_cls):
    cls = _record_classes.get((jax_name, port_cls))
    if cls is None:
        cls = _record_classes[jax_name, port_cls] = type(
            "Jax_" + jax_name.replace(".", "_"), (JaxObject,),
            {"jax_name": jax_name, "port_cls": port_cls})
    return cls


def _in_port(obj):
    try:
        path = os.path.abspath(inspect.getfile(obj))
    except TypeError:
        return False
    return path.startswith(_PORT_DIR + os.sep)


def _port_class(module, name):
    """The port's counterpart of the JAX class ``module.name``, or None
    for a dropped one; raises ``UnpicklingError`` when there is none."""
    full = "%s.%s" % (module, name)
    if module in DROPPED:
        return None
    mod = None
    if module.startswith("veles_tpu."):
        try:
            mod = importlib.import_module(
                "veles_tpu_torch." + module[len("veles_tpu."):])
        except ImportError:
            mod = None
    elif "." not in module:
        # a workflow file the command line ran (``mnist``): the port's
        # module of that name when it is one of the port's files, else
        # the port's sample of that name
        mod = sys.modules.get(module)
        if mod is None or not _in_port(mod):
            try:
                mod = importlib.import_module(
                    "veles_tpu_torch.samples." + module)
            except ImportError:
                mod = None
    cls = getattr(mod, name, None) if mod is not None else None
    if not isinstance(cls, type) or not _in_port(cls):
        raise pickle.UnpicklingError(
            "the snapshot references %s, which has no counterpart in "
            "veles_tpu_torch (not read)" % full)
    return cls


class JaxUnpickler(RestrictedUnpickler):
    """Reads a JAX package snapshot into :class:`JaxObject` records."""

    def find_class(self, module, name):
        if name in _ALLOWED.get(module, ()):
            return super(JaxUnpickler, self).find_class(module, name)
        helper = _HELPERS.get((module, name))
        if helper is not None:
            return helper
        return _record_class("%s.%s" % (module, name),
                             _port_class(module, name))


def read_records(blob):
    """The top record of a JAX package snapshot ``blob`` (bytes)."""
    return JaxUnpickler(io.BytesIO(blob)).load()


def load(blob):
    """A live port workflow from a JAX package snapshot ``blob``, on the
    host (``initialize(device=)`` puts it on a device)."""
    rec = read_records(blob)
    cls = getattr(rec, "port_cls", None)
    if cls is None or not hasattr(cls, "from_jax"):
        raise pickle.UnpicklingError(
            "the snapshot holds %s, which the port cannot resume"
            % getattr(rec, "jax_name", type(rec).__name__))
    return cls.from_jax(rec)


# -- constructor arguments ----------------------------------------------------

def filter_kwargs(cls, kwargs):
    """The items of ``kwargs`` that ``cls``'s constructor takes: the
    names it declares, and those of the base constructors its
    ``**kwargs`` reach."""
    from veles_tpu_torch.samples import constructor_names
    names = constructor_names(cls)
    return {k: v for k, v in kwargs.items() if k in names}


def standard_kwargs(rec):
    """The keyword arguments every sample of the StandardWorkflow
    family shares, from a JAX workflow record: the loader's minibatch
    size and normalization, the trainer's solver and hyper-parameters,
    the decision's stopping rule and the snapshotter's settings."""
    from veles_tpu_torch.config import root
    loader, gd = rec.get("loader"), rec.get("gd")
    decision, snap = rec.get("decision"), rec.get("snapshotter")
    kw = {"dtype": root.common.precision.get("compute_dtype", "bfloat16")}
    if loader is not None:
        kw["minibatch_size"] = loader.get("max_minibatch_size")
        kw["normalization"] = loader.get("normalization_type", "none")
        lengths = loader.get("class_lengths")
        if lengths:
            kw["synthetic_valid"] = int(lengths[1])
            kw["synthetic_train"] = int(lengths[2])
    if gd is not None:
        for key in ("learning_rate", "gradient_moment", "weights_decay",
                    "lr_schedule"):
            if gd.get(key) is not None:
                kw[key] = gd.get(key)
        kw["solver"] = gd.get("solver_name", "sgd")
        kw["lr_schedule_params"] = dict(gd.get("lr_schedule_params") or {})
    if decision is not None:
        kw["fail_iterations"] = decision.get("fail_iterations")
        kw["max_epochs"] = decision.get("max_epochs")
    if snap is not None:
        kw["snapshot_prefix"] = snap.get("prefix")
        kw["snapshot_compression"] = snap.get("compression")
        kw["snapshot_time_interval"] = snap.get("time_interval")
        kw["snapshotter_config"] = {
            "interval": snap.get("interval", 1),
            "directory": snap.get("directory") or "snapshots",
            "suffix": snap.get("suffix") or ""}
    else:
        kw["snapshotter_config"] = {"enabled": False}
    return kw


# -- state --------------------------------------------------------------------

def _is_record(v, suffix):
    return isinstance(v, JaxObject) and v.jax_name.endswith(suffix)


def array_of(rec):
    """The numpy content of a ``veles_tpu.memory.Array`` record."""
    return None if rec is None else rec.get("_mem")


def _plain(v):
    if v is None or isinstance(v, (bool, int, float, str, bytes,
                                   numpy.generic, numpy.ndarray)):
        return True
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(_plain(x) for x in v)
    if isinstance(v, dict):
        return all(_plain(k) and _plain(x) for k, x in v.items())
    return False


def take_generator(gen, rec):
    """Give the port's :class:`~veles_tpu_torch.prng.RandomGenerator`
    ``gen`` the seed, key counter and host stream of a JAX generator
    record."""
    gen.seed(int(rec.get("_seed", 42)))
    gen._counter = int(rec.get("_counter", 0))
    state = rec.get("_np_state")
    if state is not None:
        gen.np.bit_generator.state = copy.deepcopy(state)


#: attributes every unit keeps as its own: its lifecycle and identity
_OWN = ("_is_initialized", "_demanded", "_name", "timers", "view_group",
        "links_from", "links_to", "_workflow")


def take_plain(obj, rec, skip=()):
    """Copy the state of record ``rec`` onto the port object ``obj``
    where both name an attribute: plain data (deep copies), the values
    of plain (not derived) Bools — whose identities the graph's gates
    hold —, generator states and ``memory.Array`` contents.  References
    to other units stay the port's own."""
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.mutable import Bool
    from veles_tpu_torch.prng import RandomGenerator
    own = vars(obj)
    for key, v in rec.state.items():
        if key in skip or key in _OWN or key not in own \
                or key.startswith("__"):
            continue
        cur = own[key]
        if isinstance(v, JaxBool):
            if isinstance(cur, Bool) and cur._op is None:
                cur.set(v.value)
        elif _is_record(v, ".RandomGenerator"):
            if isinstance(cur, RandomGenerator):
                take_generator(cur, v)
        elif _is_record(v, "memory.Array"):
            mem = array_of(v)
            if isinstance(cur, Array) and mem is not None:
                cur.reset(numpy.array(mem))
        elif _plain(v) and not isinstance(cur, (Bool, Array)):
            setattr(obj, key, copy.deepcopy(v))


def take_forward(unit, rec):
    """The parameters and input sample shape of a JAX forward unit's
    record, into the port's chain unit (on the host)."""
    arrays = {n: array_of(rec.get(n)) for n in unit.PARAMS}
    missing = [n for n, a in arrays.items() if a is None]
    if missing:
        raise ValueError("%s: the snapshot's %s holds no %s"
                         % (type(unit).__name__, rec.jax_name, missing))
    unit.to_device("cpu")
    unit.load_params(arrays)
    inp = array_of(rec.get("input"))
    if inp is not None:
        unit.in_shape = tuple(inp.shape[1:])
    for h in unit.hyperparams():
        setattr(unit, h, rec.get(h))


def take_trainer(gd, rec):
    """The trainer's step, learning-rate multiplier, key counter, solver
    slots (``{index: {name: {slot: Array}}}`` → ``{(index, name): {slot:
    tensor}}``) and epoch accumulator."""
    gd.global_step = int(rec.get("global_step", 0))
    gd.lr_multiplier = float(rec.get("lr_multiplier", 1.0))
    if rec.get("prng") is not None:
        take_generator(gd.prng, rec.get("prng"))
    opt = rec.get("opt_state") or {}
    gd.opt_state = {
        (int(i), name): {slot: torch.as_tensor(numpy.array(
            array_of(a) if isinstance(a, JaxObject) else a,
            numpy.float32)) for slot, a in slots.items()}
        for i, layer in opt.items() for name, slots in layer.items()}
    acc = array_of(rec.get("epoch_acc"))
    if acc is not None and acc.shape == (3, 3):
        gd.epoch_acc = torch.as_tensor(numpy.array(acc, numpy.float32))
    mesh = rec.get("mesh")
    if isinstance(mesh, dict):
        # the JAX trainer pickles its mesh as {"__mesh_axes__": {...}}:
        # the port rebuilds it over its own positions at initialize
        gd.mesh = {"__mesh_axes__": dict(mesh.get("__mesh_axes__", mesh))}


def take_state(wf, rec):
    """Take the state of JAX workflow record ``rec`` onto the port's
    freshly built StandardWorkflow ``wf``, unit by unit."""
    fwd = rec.get("forwards") or []
    if len(fwd) != len(wf.forwards):
        raise ValueError("the snapshot's chain has %d units, the port's "
                         "%d" % (len(fwd), len(wf.forwards)))
    for unit, r in zip(wf.forwards, fwd):
        take_forward(unit, r)
    loader = rec.get("loader")
    if loader is not None:
        take_plain(wf.loader, loader, skip=("device", "prefetch"))
        norm = loader.get("_normalizer")
        if norm is not None and getattr(wf.loader, "_normalizer", None) \
                is not None:
            take_plain(wf.loader._normalizer, norm)
    if rec.get("gd") is not None:
        take_plain(wf.gd, rec.get("gd"),
                   skip=("device", "opt_state", "epoch_acc", "loss",
                         "n_err", "prng", "mesh", "forwards"))
        take_trainer(wf.gd, rec.get("gd"))
    if rec.get("decision") is not None:
        take_plain(wf.decision, rec.get("decision"))
    if rec.get("snapshotter") is not None and wf.snapshotter is not None:
        take_plain(wf.snapshotter, rec.get("snapshotter"))
    wf._restored_from_snapshot_ = True
    return wf
