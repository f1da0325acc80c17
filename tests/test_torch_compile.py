"""Compile tracking in the port (``telemetry/compile_tracker.py``) on its
meaning: a kernel library's build is its compile.  The oracles are
``tests/test_telemetry.py``'s compile cases and ``tests/test_health.py``'s
cost cases; here the build is simulated (a stand-in ``nvcc`` that writes
the library file, a stand-in loader), so they run without a card:

- every library is recorded ``cold`` with the wall of its compiler, then
  ``hit`` when a fresh process state finds it built; ``calls`` are the
  kernels' launch counts at summary time;
- ``compile_summary()`` and ``cost_summary()`` have the reference's
  shapes; every cost field is None but the library's size, and
  ``root.common.telemetry.cost_analysis = False`` records none;
- ``track_jit`` is the reference's transparent proxy: a callable without
  an executable cache records calls and no compile, as the JAX
  package's does for the same callable;
- ``maybe_profiler_trace`` writes a Chrome trace where a directory is
  named, and nothing where none is."""

import json
import os
import stat
import sys

import pytest

pytestmark = pytest.mark.torch_port

FAKE_NVCC = """#!%s
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.05)
with open(out, "wb") as f:
    f.write(b"\\0" * 1234)
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` pointed at an empty library directory, a stand-in
    compiler and a stand-in loader; the cost records and the kernels'
    launch counts start empty."""
    from veles_tpu_torch import _build
    from veles_tpu_torch.telemetry import compile_tracker
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC % sys.executable)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "libs"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "ptxas_reports", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(compile_tracker, "_cost_records", {})
    monkeypatch.setattr(compile_tracker, "_first_seen", set())
    monkeypatch.setattr(compile_tracker, "_launches_seen", {})
    from veles_tpu_torch.ops import lrn
    monkeypatch.setattr(lrn, "launches", {"lrn_fwd": 3, "lrn_bwd": 2})
    return _build


def _compiles(name, kind):
    from veles_tpu_torch.telemetry import metrics
    return metrics.counter("veles_jit_compiles_total",
                           labelnames=("fn", "cache")).labels(
                               name, kind).value


def test_kernel_builds_recorded_cold_then_hit(fake_build, monkeypatch):
    from veles_tpu_torch.telemetry import compile_summary, metrics
    names = ["kernels." + n for n in fake_build.SOURCES]
    before = {n: (_compiles(n, "cold"), _compiles(n, "hit"))
              for n in names}
    libs = fake_build.build_all()
    assert sorted(libs) == sorted(fake_build.SOURCES)
    for n in names:
        assert _compiles(n, "cold") == before[n][0] + 1
        assert _compiles(n, "hit") == before[n][1]
    first = metrics.gauge("veles_jit_first_compile_seconds",
                          labelnames=("fn",))
    assert all(first.labels(n).value >= 0.05 for n in names)
    # a new process finds every library built: each load is a hit
    monkeypatch.setattr(fake_build, "_libs", {})
    fake_build.build_all()
    for n in names:
        assert _compiles(n, "cold") == before[n][0] + 1
        assert _compiles(n, "hit") == before[n][1] + 1
    calls = metrics.counter("veles_jit_calls_total",
                            labelnames=("fn",)).labels("kernels.lrn")
    c0 = calls.value
    summ = compile_summary()
    assert summ["kernels.lrn"]["calls"] == 5 and calls.value == c0 + 5
    # counts set back to 0 (as a test does before it drives a path) and
    # 2 launches since: the summary reads 2, the counter moves on by 2
    from veles_tpu_torch.ops import lrn
    monkeypatch.setattr(lrn, "launches", {"lrn_fwd": 2, "lrn_bwd": 0})
    summ = compile_summary()
    assert summ["kernels.lrn"]["calls"] == 2 and calls.value == c0 + 7
    assert summ["kernels.lrn"]["compiles"] >= 2
    assert summ["kernels.lrn"]["compiles_persistent_hit"] >= 1
    assert summ["kernels.lrn"]["first_compile_s"] >= 0.05
    assert 'veles_jit_compiles_total{fn="kernels.lrn",cache="hit"}' \
        in metrics.render_prometheus()


def test_compile_summary_shape_matches_reference(fake_build):
    """The digest's shape is the JAX package's: the same keys per entry
    and in the rollup."""
    import jax
    from veles_tpu.telemetry import compile_summary as jax_summary
    from veles_tpu.telemetry import track_jit as jax_track
    from veles_tpu_torch.telemetry import compile_summary
    f = jax_track("test.port_shape", jax.jit(lambda x: x + 1))
    f(1)
    fake_build.build_all()
    want, got = jax_summary(), compile_summary()
    assert set(got["total"]) == set(want["total"])
    assert set(got["kernels.matmul"]) == set(want["test.port_shape"])
    assert got["total"]["compiles"] >= len(fake_build.SOURCES)
    assert got["kernels.matmul"]["compile_seconds_total"] > 0


def test_track_jit_counts_calls_and_no_compiles():
    """A callable without ``_cache_size`` (every callable of the port)
    records its calls and no compile — the JAX package's proxy does the
    same for it; one with an executable cache that grows is counted."""
    from veles_tpu.telemetry import metrics as jmetrics
    from veles_tpu.telemetry import track_jit as jax_track
    from veles_tpu_torch.telemetry import metrics, track_jit

    def double(x):
        return x * 2

    deltas = []
    for reg, track in ((metrics, track_jit), (jmetrics, jax_track)):
        calls = reg.counter("veles_jit_calls_total",
                            labelnames=("fn",)).labels("test.plain")
        compiles = reg.counter("veles_jit_compiles_total",
                               labelnames=("fn", "cache"))
        c0, k0 = calls.value, compiles.labels("test.plain", "cold").value
        f = track("test.plain", double)
        assert [f(1), f(2), f(3)] == [2, 4, 6]
        assert f.__name__ == "double"   # the proxy stays transparent
        deltas.append((calls.value - c0,
                       compiles.labels("test.plain", "cold").value - k0))
    assert deltas == [(3, 0), (3, 0)]

    class Cached:
        size = 0

        def __call__(self, x):
            self.size += x
            return x

        def _cache_size(self):
            return self.size

    g = track_jit("test.cached", Cached())
    cold = metrics.counter("veles_jit_compiles_total",
                           labelnames=("fn", "cache")).labels(
                               "test.cached", "cold")
    k0 = cold.value
    g(0)
    g(2)
    assert cold.value - k0 == 2 and g._cache_size() == 2


def test_cost_summary_fields_or_nulls(fake_build):
    """One record per built library with the reference's fields: each
    None (nothing reports it) but the library file's size."""
    from veles_tpu.telemetry.compile_tracker import COST_KEYS as JAX_KEYS
    from veles_tpu_torch.telemetry import cost_summary
    from veles_tpu_torch.telemetry.compile_tracker import COST_KEYS
    assert COST_KEYS == JAX_KEYS
    fake_build.build_all()
    costs = cost_summary()
    assert sorted(costs) == sorted("kernels." + n
                                   for n in fake_build.SOURCES)
    for rec in costs.values():
        assert set(rec) == set(COST_KEYS)
        assert rec["generated_code_bytes"] == 1234
        assert all(v is None for k, v in rec.items()
                   if k != "generated_code_bytes")


def test_cost_analysis_toggle_off(fake_build, cli_env):
    from veles_tpu_torch.config import root
    from veles_tpu_torch.telemetry import cost_summary
    root.common.telemetry.cost_analysis = False
    fake_build.build_all()
    assert cost_summary() == {}


@pytest.mark.parametrize("named", [True, False])
def test_maybe_profiler_trace(named, tmp_path, cli_env):
    """A named directory gets ``trace-<pid>.json`` (a Chrome trace of
    the block); ``root.common.trace.profiler_dir`` names it when the
    caller does not; without either, nothing is captured."""
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.telemetry import maybe_profiler_trace
    if named:
        root.common.trace.profiler_dir = str(tmp_path / "prof")
    with maybe_profiler_trace(device="cpu") as out:
        torch.ones(4).sum()
    if not named:
        assert out["path"] is None
        return
    assert out["path"] == str(tmp_path / "prof" /
                              ("trace-%d.json" % os.getpid()))
    with open(out["path"]) as f:
        assert "traceEvents" in json.load(f)


from tests.test_torch_cli import cli_env  # noqa: E402,F401 (fixture)
