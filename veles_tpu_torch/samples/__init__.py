"""Sample workflows of the port.  Each is run by the command line
(``python -m veles_tpu_torch veles_tpu_torch/samples/mnist.py
veles_tpu_torch/samples/mnist_config.py``) through its ``run(load,
main)``, which reads the sample's ``root.<sample>_tpu`` subtree with
the reference's defaults (:func:`config_kwargs`), or built directly
with the same keys as keyword arguments."""

import inspect


def constructor_names(cls):
    """The keyword names ``cls(...)`` takes: its ``__init__``'s, and
    those of the base classes' ``__init__`` that its ``**kwargs``
    reach."""
    names = set()
    for klass in cls.__mro__:
        init = vars(klass).get("__init__")
        if init is None:
            continue
        params = inspect.signature(init).parameters
        names.update(k for k, p in params.items()
                     if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return names


def config_kwargs(workflow_class, cfg):
    """The keyword arguments of ``workflow_class`` that the config
    subtree ``cfg`` sets (keys the class does not take are left to the
    reference's samples, as its ``cfg.get`` calls leave them), plus the
    command line's common settings from ``root.common``: the snapshot
    directory and suffix, ``trace_run``, ``timings``, the compute
    dtype (``precision.compute_dtype``, unless the subtree sets
    ``dtype``) and the first parameters drawn from the process-wide
    generator (``weights_seed=None``) that ``--seed`` seeds."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.standard import StandardWorkflow
    names = constructor_names(workflow_class)
    names.discard("workflow")   # the launcher, given by load()
    kw = {k: v for k, v in cfg.__content__().items() if k in names}
    if issubclass(workflow_class, StandardWorkflow):
        snap = dict(kw.pop("snapshotter_config", None) or {})
        snap.setdefault("directory",
                        root.common.dirs.get("snapshots", "snapshots"))
        suffix = root.common.get("snapshot_suffix", "")
        if suffix:
            snap.setdefault("suffix", suffix)
        kw["snapshotter_config"] = snap
        kw.setdefault("weights_seed", None)
        kw.setdefault("dtype", root.common.precision.get(
            "compute_dtype", "bfloat16"))
        kw["trace_run"] = bool(root.common.trace.get("run", False))
        kw["timings"] = bool(root.common.get("timings", False))
    return kw
