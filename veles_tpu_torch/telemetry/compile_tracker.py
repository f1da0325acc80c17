"""Compile tracking — the port's own copy of
``veles_tpu/telemetry/compile_tracker.py``.

The reference counts XLA compiles per jitted entry point, its Pallas
kernels included.  The port runs eagerly and compiles no XLA program:
what it compiles are its kernel libraries, each built once by ``nvcc``
into ``veles_tpu_torch/_build/`` under a name keyed by the hash of its
sources and flags (:mod:`veles_tpu_torch._build`) — the directory is
its persistent cache.  So the reference's families count those builds:

- ``veles_jit_compiles_total{fn="kernels.<lib>", cache=...}``: one per
  library a process loads — ``cold`` when this process ran its
  ``nvcc``, ``hit`` when the hash-keyed library was already built;
- ``veles_jit_compile_seconds`` / ``veles_jit_first_compile_seconds``:
  the wall seconds of that library's ``nvcc`` (of its load, for a hit);
- ``veles_jit_calls_total{fn="kernels.<lib>"}``: the library's kernel
  launches, read from :func:`veles_tpu_torch.ops.kernel_launches` when
  :func:`compile_summary` runs (the launch path counts nothing more);
  the summary's ``calls`` of a library is that read itself;
- :func:`cost_summary`: one record per built library (gated by
  ``root.common.telemetry.cost_analysis``) with every ``COST_KEYS``
  field ``None`` — nothing reports them — except
  ``generated_code_bytes``, the library file's size.

:func:`track_jit` is the reference's transparent proxy: a callable with
no ``_cache_size`` (every callable of the port) records its calls and
no compile, as the reference's does.  :func:`maybe_profiler_trace` is
the ``torch.profiler`` capture that ``--profile`` (and
``root.common.trace.profiler_dir``) runs a launcher under.
"""

import contextlib
import functools
import os
import threading
import time

from veles_tpu_torch.logger import events
from veles_tpu_torch.telemetry.registry import metrics

#: the entry-point name of a kernel library's build
KERNEL_PREFIX = "kernels."

#: kernel name (``ops.kernel_launches``) → the library it runs from
KERNEL_LIBRARY = {
    "paged_attend": "paged_attend", "int8_gemm": "int8_gemm",
    "matmul": "matmul", "uniform_fill": "uniform",
    "flash_attn_fwd": "flash_attention", "flash_attn_dq":
    "flash_attention", "flash_attn_dkv": "flash_attention",
    "lrn_fwd": "lrn", "lrn_bwd": "lrn",
}


def _compile_metrics():
    return (
        metrics.counter(
            "veles_jit_compiles_total",
            "XLA compilations per jitted entry point (first call + "
            "every recompile on a new shape/dtype); cache=\"hit\" "
            "marks compiles satisfied by the persistent compilation "
            "cache (fast executable loads), cache=\"cold\" real "
            "XLA compiles", ("fn", "cache")),
        metrics.counter(
            "veles_jit_calls_total",
            "calls into tracked jitted entry points", ("fn",)),
        metrics.histogram(
            "veles_jit_compile_seconds",
            "wall time of calls that triggered an XLA compilation "
            "(trace + compile + first dispatch)", ("fn",)),
        metrics.gauge(
            "veles_jit_first_compile_seconds",
            "wall time of the FIRST compiling call per entry point",
            ("fn",)),
    )


# -- cost accounting ---------------------------------------------------------

#: fields every cost record carries; absent backend support → None
COST_KEYS = ("flops", "bytes_accessed", "temp_bytes", "argument_bytes",
             "output_bytes", "generated_code_bytes")

_cost_lock = threading.Lock()
_cost_records = {}   # entry-point name -> {COST_KEYS: float|int|None}
_first_seen = set()  # entry points whose first compile is recorded
_launches_seen = {}  # library -> its kernels' launch count at the last sync


def _cost_gauges():
    return {
        "flops": metrics.gauge(
            "veles_jit_cost_flops",
            "XLA cost_analysis flops of the first compiled executable "
            "per entry point (roofline numerator)", ("fn",)),
        "bytes_accessed": metrics.gauge(
            "veles_jit_cost_bytes_accessed",
            "XLA cost_analysis bytes accessed per executed step "
            "(HBM-roofline denominator)", ("fn",)),
        "temp_bytes": metrics.gauge(
            "veles_jit_memory_temp_bytes",
            "XLA memory_analysis peak temp allocation of the compiled "
            "executable", ("fn",)),
        "argument_bytes": metrics.gauge(
            "veles_jit_memory_argument_bytes",
            "XLA memory_analysis argument bytes of the compiled "
            "executable", ("fn",)),
        "output_bytes": metrics.gauge(
            "veles_jit_memory_output_bytes",
            "XLA memory_analysis output bytes of the compiled "
            "executable", ("fn",)),
        "generated_code_bytes": metrics.gauge(
            "veles_jit_memory_code_bytes",
            "XLA memory_analysis generated-code size of the compiled "
            "executable", ("fn",)),
    }


def _cost_enabled():
    from veles_tpu_torch.config import root
    return bool(root.common.telemetry.get("cost_analysis", True))


def _capture_cost(name, path):
    """The cost record of a built library: its file size as the
    generated code; nothing reports the rest, so they stay None."""
    rec = dict.fromkeys(COST_KEYS)
    try:
        rec["generated_code_bytes"] = os.path.getsize(path)
    except OSError:
        pass
    gauges = _cost_gauges()
    for key, value in rec.items():
        if value is not None:
            gauges[key].labels(name).set(value)
    with _cost_lock:
        _cost_records[name] = rec
    return rec


def cost_summary():
    """Per-entry-point cost digest — ``{name: {flops, bytes_accessed,
    temp_bytes, argument_bytes, output_bytes, generated_code_bytes}}``
    with explicit ``None`` for anything that could not be reported."""
    with _cost_lock:
        return {name: dict(rec) for name, rec in _cost_records.items()}


# -- kernel library builds ---------------------------------------------------

def record_build(library, seconds, cached, path=None):
    """Count one kernel library's build under ``kernels.<library>``:
    ``cached`` True when the hash-keyed file was already there (a
    ``hit``), ``seconds`` the wall of its ``nvcc`` (of its load for a
    hit).  ``path`` (the built file) feeds :func:`cost_summary`."""
    name = KERNEL_PREFIX + library
    compiles, _, hist, first = _compile_metrics()
    compiles.labels(name, "hit" if cached else "cold").inc()
    hist.labels(name).observe(seconds)
    with _cost_lock:  # first-compile latch: one winner
        first_compile = name not in _first_seen
        _first_seen.add(name)
    if first_compile:
        first.labels(name).set(seconds)
    events.record("jit.compile", "single", fn=name, duration=seconds,
                  cache="hit" if cached else "cold")
    if path is not None and _cost_enabled():
        _capture_cost(name, path)


def _sync_kernel_calls():
    """Every recorded library's launches now (the sum of its kernels'
    counts in :func:`~veles_tpu_torch.ops.kernel_launches`, by entry
    point name), with ``veles_jit_calls_total`` moved on by the launches
    since the last sync.  The wrappers count launches and nothing on the
    launch path touches the registry; a count set back to 0 (as a test
    does before it drives a path) restarts the difference, so the
    counter stays monotonic."""
    from veles_tpu_torch.ops import kernel_launches
    per_lib = {}
    for kernel, n in kernel_launches().items():
        lib = KERNEL_LIBRARY.get(kernel)
        if lib is not None:
            per_lib[lib] = per_lib.get(lib, 0) + int(n)
    calls = _compile_metrics()[1]
    out = {}
    with _cost_lock:
        for lib, n in per_lib.items():
            name = KERNEL_PREFIX + lib
            if name not in _first_seen:
                continue
            last = _launches_seen.get(lib, 0)
            calls.labels(name).inc(n - last if n >= last else n)
            _launches_seen[lib] = n
            out[name] = n
    return out


# -- tracked callables -------------------------------------------------------

class _TrackedJit:
    """Callable proxy counting calls, and compiles where the wrapped
    callable exposes an executable cache (``_cache_size()``).

    Transparent: attribute access delegates to the wrapped callable."""

    def __init__(self, name, fn):
        self.name = name
        self.fn = fn
        functools.update_wrapper(self, fn, updated=())
        compiles, calls, hist, first = _compile_metrics()
        self._compiles_family = compiles
        self._calls = calls.labels(name)
        self._hist = hist.labels(name)
        self._first = first.labels(name)
        self._seen_compile = False

    def _cache_len(self):
        probe = getattr(self.fn, "_cache_size", None)
        if probe is None:
            return None
        try:
            return int(probe())
        except Exception:
            return None

    def __call__(self, *args, **kwargs):
        before = self._cache_len()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self._calls.inc()
        if before is not None:
            after = self._cache_len()
            if after is not None and after > before:
                dt = time.perf_counter() - t0
                self._compiles_family.labels(self.name, "cold").inc(
                    after - before)
                self._hist.observe(dt)
                with _cost_lock:  # first-compile latch: one winner
                    first_compile = not self._seen_compile
                    self._seen_compile = True
                if first_compile:
                    self._first.set(dt)
                events.record("jit.compile", "single", fn=self.name,
                              duration=dt)
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)


def track_jit(name, fn):
    """Wrap a callable so its calls (and, where it has an executable
    cache, its compiles) are counted under ``name``.  Same-name
    wrappers share the metric series.  The wrapper holds no global
    reference: its lifetime is the wrapped callable's."""
    return _TrackedJit(name, fn)


def compile_summary():
    """Per-entry-point compile digest — ``{name: {compiles,
    compiles_persistent_hit, calls, first_compile_s,
    compile_seconds_total}}`` plus a ``total`` rollup (the reference's
    shape).  A kernel library's ``compiles`` is its build in this
    process (``compiles_persistent_hit`` 1 when it was already built)
    and its ``calls`` its kernels' launches."""
    out = {}
    total_compiles = 0
    total_hits = 0
    total_seconds = 0.0
    fam_compiles = metrics.get("veles_jit_compiles_total")
    if fam_compiles is None:
        return {"total": {"compiles": 0, "compile_seconds": 0.0}}
    lib_calls = _sync_kernel_calls()
    fam_calls = metrics.get("veles_jit_calls_total")
    fam_hist = metrics.get("veles_jit_compile_seconds")
    fam_first = metrics.get("veles_jit_first_compile_seconds")
    per_fn = {}
    for (name, kind), child in fam_compiles.children().items():
        agg = per_fn.setdefault(name, {"cold": 0, "hit": 0})
        agg[kind] = agg.get(kind, 0) + int(child.value)
    for name, agg in sorted(per_fn.items()):
        compiles = agg["cold"] + agg["hit"]
        hist = fam_hist.labels(name)
        calls = fam_calls.labels(name)
        first = fam_first.labels(name)
        total_compiles += compiles
        total_hits += agg["hit"]
        total_seconds += hist.sum
        out[name] = {
            "compiles": compiles,
            "compiles_persistent_hit": agg["hit"],
            "calls": lib_calls.get(name, int(calls.value)),
            "first_compile_s": round(first.value, 4),
            "compile_seconds_total": round(hist.sum, 4),
        }
    out["total"] = {"compiles": total_compiles,
                    "compiles_persistent_hit": total_hits,
                    "compile_seconds": round(total_seconds, 4)}
    return out


@contextlib.contextmanager
def maybe_profiler_trace(trace_dir=None, device=None):
    """When ``trace_dir`` (default ``root.common.trace.profiler_dir``)
    names a directory, run the block under ``torch.profiler`` (host
    activity, and the card's on a CUDA ``device``) and write its Chrome
    trace to ``<dir>/trace-<pid>.json``; otherwise a no-op.  Yields a
    dict whose ``path`` names the trace once the block has ended (None
    when nothing was captured)."""
    out = {"path": None}
    if trace_dir is None:
        from veles_tpu_torch.config import root
        trace_dir = root.common.trace.get("profiler_dir")
    if not trace_dir:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(trace_dir), exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield out
        if on_card:
            torch.cuda.synchronize(device)
    path = os.path.join(str(trace_dir), "trace-%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    out["path"] = path
