"""veles-lint over the port (``veles_tpu_torch/analysis``), held against
the JAX package's analyzer (``veles_tpu/analysis``; the oracle is
``tests/test_analysis.py``, whose cases are ported here one for one).

- Every fixture tree is scanned by both packages' passes with the same
  ``root``, and the two lists of findings are equal — code, path, line,
  column, context, detail and message — before the case's own checks
  (every D/T/L/C/M/F code fires on its seeded violation and stays quiet
  on the clean twin).
- T204 fires on a fixture and asserts nothing over the port's own
  serving modules (the port compiles no entry point).
- ``--strict`` over ``veles_tpu_torch/`` exits 0 with no stale baseline
  entry and without importing ``jax``; both analyzers over the port with
  no baseline agree on everything but T204, and every C402 the JAX
  package's analyzer reports there is a reasoned entry of the port's
  baseline.  No case here times the scan."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from veles_tpu.analysis import ALL_PASSES as JAX_PASSES
from veles_tpu.analysis import analyze as jax_analyze
from veles_tpu.analysis import collect_modules as jax_collect
from veles_tpu.analysis import run_passes as jax_run
from veles_tpu_torch.analysis import (
    ALL_CODES, ALL_PASSES, analyze, collect_modules, run_passes)
from veles_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE, format_entry, load_baseline)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "veles_tpu_torch"

pytestmark = [pytest.mark.analysis, pytest.mark.torch_port]


def _tuples(findings):
    return [(f.code, f.path, f.line, f.col, f.context, f.detail,
             f.message, f.baselined, f.reason) for f in findings]


def scan(tmp_path, files):
    """Write a fixture tree and run every pass of both packages over
    it; the findings must be equal.  Returns the port's."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    modules, errors = collect_modules([str(tmp_path)], root=tmp_path)
    assert not errors, errors
    findings, _ = run_passes(ALL_PASSES, modules)
    jmodules, jerrors = jax_collect([str(tmp_path)], root=tmp_path)
    jfindings, _ = jax_run(JAX_PASSES, jmodules)
    assert _tuples(findings) == _tuples(jfindings)
    return findings


def both_analyze(paths, root, baseline):
    """``analyze`` of both packages; every part of the result equal."""
    got = analyze(paths, root=root, baseline=baseline)
    want = jax_analyze(paths, root=root, baseline=baseline)
    assert _tuples(got[0]) == _tuples(want[0])
    assert _tuples(got[1]) == _tuples(want[1])
    assert got[2] == want[2] and got[3] == want[3]
    return got


def codes_of(findings):
    return sorted({f.code for f in findings})


# -- D-series ----------------------------------------------------------------

def test_d101_read_after_donate_fires_and_clean_is_quiet(tmp_path):
    bad = """\
import jax

def build():
    def step(w, x):
        return w + x
    return jax.jit(step, donate_argnums=(0,))

class T:
    def setup(self):
        self._step_ = build()

    def run(self, w, x):
        out = self._step_(w, x)
        return w.sum(), out
"""
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "D101"]
    assert f and f[0].detail == "self._step_->w"
    good = bad.replace("return w.sum(), out", "return out")
    assert "D101" not in codes_of(scan(tmp_path, {"m.py": good}))


def test_d101_builder_method_resolution(tmp_path):
    """The gd.py idiom: self._step_ = self._build() where _build
    returns track_jit(jax.jit(..., donate_argnums))."""
    src = """\
import jax
from veles_tpu.telemetry import track_jit

class T:
    def _build(self):
        def step(params, x):
            return params
        return track_jit("t.step", jax.jit(step, donate_argnums=(0,)))

    def run(self, x):
        if self._step_ is None:
            self._step_ = self._build()
        params = self.gather()
        new = self._step_(params, x)
        self.scatter(params)   # read after donation!
        return new
"""
    f = [x for x in scan(tmp_path, {"m.py": src}) if x.code == "D101"]
    assert f and "params" in f[0].detail


def test_d102_retained_host_view(tmp_path):
    bad = """\
import numpy

class A:
    def keep(self, devmem):
        self.view = numpy.asarray(devmem)

    def fetch(self, devmem):
        return numpy.asarray(devmem)
"""
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "D102"]
    assert len(f) == 2
    # transient consumption is the safe idiom — quiet
    good = """\
import numpy

class A:
    def read_scalar(self, devmem):
        v = int(numpy.asarray(devmem)[0])
        return v
"""
    assert "D102" not in codes_of(scan(tmp_path, {"m.py": good}))


def test_d103_module_level_jit_ref(tmp_path):
    bad = "import jax\n_step = jax.jit(lambda x: x + 1)\n"
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "D103"]
    assert f and f[0].detail == "_step"
    good = """\
import jax

def build():
    return jax.jit(lambda x: x + 1)
"""
    assert "D103" not in codes_of(scan(tmp_path, {"m.py": good}))


# -- T-series ----------------------------------------------------------------

def test_t201_side_effects_inside_jit(tmp_path):
    bad = """\
import jax, time, random

@jax.jit
def step(x):
    print("tracing")
    t = time.time()
    r = random.random()
    return x + t + r
"""
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "T201"]
    assert {x.detail for x in f} == {"print", "time.time",
                                     "random.random"}
    good = """\
import jax

@jax.jit
def step(x, key):
    return x + jax.random.uniform(key)
"""
    fg = scan(tmp_path, {"m.py": good})
    assert "T201" not in codes_of(fg)


def test_t202_concretization_inside_jit(tmp_path):
    bad = """\
import jax

def make(f):
    def step(x):
        if bool(x[0] > 0):
            return float(x.sum())
        return x.item()
    return jax.jit(step)
"""
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "T202"]
    assert {x.detail for x in f} == {"bool", "float", ".item"}
    # static-shape reads are fine
    good = """\
import jax

def make():
    def step(x):
        n = int(x.shape[0])
        return x.reshape(n, -1)
    return jax.jit(step)
"""
    assert "T202" not in codes_of(scan(tmp_path, {"m.py": good}))


def test_t203_untracked_jit_and_the_escapes(tmp_path):
    bad = """\
import jax

def build(f):
    return jax.jit(f)

@jax.jit
def decorated(x):
    return x
"""
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "T203"]
    assert len(f) == 2  # the call site AND the bare decorator
    good = """\
import functools, jax
from veles_tpu.telemetry import track_jit

def build(f):
    return track_jit("m.f", jax.jit(f))

@functools.partial(jax.jit, static_argnames=("n",))
def rebound(x, n):
    return x * n

rebound = track_jit("m.rebound", rebound)
"""
    assert "T203" not in codes_of(scan(tmp_path, {"m.py": good}))


def test_t204_missing_stable_registration(tmp_path):
    src = "def apply_step_slots():\n    pass\n"
    f = [x for x in scan(tmp_path, {"serving/engine.py": src})
         if x.code == "T204"]
    assert f and any(x.detail == "serving.slot_step" for x in f)


# -- L-series ----------------------------------------------------------------

_L301_BAD = """\
import threading

class W:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
        self._t = threading.Thread(target=self._loop)

    def _loop(self):
        self._items.append(1)        # thread side, no lock

    def push(self, x):
        with self._lock:
            self._items = [x]        # main side, locked
"""


def test_l301_unlocked_shared_write(tmp_path):
    f = [x for x in scan(tmp_path, {"m.py": _L301_BAD})
         if x.code == "L301"]
    assert f and f[0].detail == "_items"
    good = _L301_BAD.replace(
        "        self._items.append(1)        # thread side, no lock",
        "        with self._lock:\n"
        "            self._items.append(1)")
    assert "L301" not in codes_of(scan(tmp_path, {"m.py": good}))


def test_l302_check_then_act(tmp_path):
    bad = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}
        self._thread = None

    def put(self, k, v):
        if k in self._cache:
            return
        self._cache[k] = v           # membership race

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self.put)  # early-return race
"""
    f = [x for x in scan(tmp_path, {"m.py": bad}) if x.code == "L302"]
    assert {x.detail for x in f} == {"_cache", "_thread"}
    good = bad.replace("        if k in self._cache:\n"
                       "            return\n"
                       "        self._cache[k] = v           "
                       "# membership race",
                       "        with self._lock:\n"
                       "            if k not in self._cache:\n"
                       "                self._cache[k] = v") \
              .replace("        if self._thread is not None:\n"
                       "            return\n"
                       "        self._thread = threading.Thread("
                       "target=self.put)  # early-return race",
                       "        with self._lock:\n"
                       "            if self._thread is None:\n"
                       "                self._thread = "
                       "threading.Thread(target=self.put)")
    assert "L302" not in codes_of(scan(tmp_path, {"m.py": good}))


def test_l_series_ignores_unthreaded_modules(tmp_path):
    src = """\
class C:
    def get(self, k, v):
        if k in self._cache:
            return self._cache[k]
        self._cache[k] = v
"""
    assert not [x for x in scan(tmp_path, {"m.py": src})
                if x.code.startswith("L")]


# -- C-series ----------------------------------------------------------------

_CONFIG = """\
root.common.update({
    "engine": {"backend": "auto"},
    "timings": False,
    "open": {},
    "dead": {"never_read": 1},
})
"""


def test_c401_unknown_key(tmp_path):
    files = {
        "config.py": _CONFIG,
        "use.py": """\
from veles_tpu.config import root

def f():
    backend = root.common.engine.get("backend", "auto")
    typo = root.common.engine.get("backnd")
    missing = root.common.timing
    ok_open = root.common.open.get("anything")
    return backend, typo, missing, ok_open
""",
    }
    f = [x for x in scan(tmp_path, files) if x.code == "C401"]
    assert {x.detail for x in f} == {"engine.backnd", "timing"}


def test_c401_alias_and_forwarder(tmp_path):
    files = {
        "config.py": _CONFIG,
        "use.py": """\
from veles_tpu.config import root

def conf(name, default):
    return root.common.engine.get(name, default)

def g():
    cfg = root.common.engine
    a = cfg.get("backend")
    b = cfg.get("oops")
    c = conf("also_oops", 1)
    return a, b, c
""",
    }
    f = [x for x in scan(tmp_path, files) if x.code == "C401"]
    assert {x.detail for x in f} == {"engine.oops", "engine.also_oops"}


def test_c402_dead_default(tmp_path):
    files = {
        "config.py": _CONFIG,
        "use.py": """\
from veles_tpu.config import root

def f():
    return (root.common.engine.get("backend"),
            root.common.get("timings"))
""",
    }
    f = [x for x in scan(tmp_path, files) if x.code == "C402"]
    assert {x.detail for x in f} == {"dead.never_read"}
    # a dynamic read of the subtree suppresses the dead-key claim
    files["use.py"] += """\

def g(name):
    return root.common.dead.get(name)
"""
    assert "C402" not in codes_of(scan(tmp_path, files))


# -- M-series ----------------------------------------------------------------

def test_m501_off_convention_family_name(tmp_path):
    bad = """\
from veles_tpu.telemetry import metrics

a = metrics.counter("BadName_total", "x")
b = metrics.gauge("veles_camelCase", "x")
ok = metrics.histogram("veles_good_ms", "x")
"""
    f = [x for x in scan(tmp_path, {"m.py": bad})
         if x.code == "M501"]
    assert {x.detail for x in f} == {"BadName_total",
                                     "veles_camelCase"}
    # instance-local constructions and non-registry receivers are
    # out of scope
    clean = """\
import numpy
from veles_tpu.telemetry import Histogram

h = Histogram("ttft_ms")
c, e = numpy.histogram([1, 2])
"""
    assert "M501" not in codes_of(scan(tmp_path, {"m.py": clean}))


def test_m502_inconsistent_label_sets(tmp_path):
    bad = """\
from veles_tpu.telemetry import metrics

a = metrics.counter("veles_x_total", "x",
                    labelnames=("replica", "to"))
b = metrics.counter("veles_x_total", "x", labelnames=("replica",))
"""
    f = [x for x in scan(tmp_path, {"m.py": bad})
         if x.code == "M502"]
    assert len(f) == 2 and all(x.detail == "veles_x_total"
                               for x in f)
    # agreeing sites (order-insensitive) are quiet
    ok = """\
from veles_tpu.telemetry import metrics

a = metrics.counter("veles_x_total", "x",
                    labelnames=("to", "replica"))
b = metrics.counter("veles_x_total", "x",
                    labelnames=("replica", "to"))
"""
    assert "M502" not in codes_of(scan(tmp_path, {"m.py": ok}))


def test_m503_unbounded_tenant_label(tmp_path):
    """A tenant-labeled family in a module with no `.label(...)` call
    fires M503; the twin that routes ids through the bounder is
    quiet."""
    bad = """\
from veles_tpu.telemetry import metrics

c = metrics.counter("veles_tenant_x_total", "x",
                    labelnames=("tenant",))

def record(tenant, n):
    c.labels(tenant=tenant).inc(n)
"""
    f = [x for x in scan(tmp_path, {"m.py": bad})
         if x.code == "M503"]
    assert {x.detail for x in f} == {"veles_tenant_x_total"}
    # the clean twin: same family, but ids fold through the
    # admission-layer cardinality bounder before becoming labels
    ok = """\
from veles_tpu.telemetry import metrics
from veles_tpu.tenant.admission import TenantAdmission

_bounder = TenantAdmission()
c = metrics.counter("veles_tenant_x_total", "x",
                    labelnames=("tenant",))

def record(tenant, n):
    c.labels(tenant=_bounder.label(tenant)).inc(n)
"""
    assert "M503" not in codes_of(scan(tmp_path, {"m.py": ok}))
    # families without a tenant label never trigger, bounder or not
    other = """\
from veles_tpu.telemetry import metrics

c = metrics.counter("veles_x_total", "x", labelnames=("replica",))
"""
    assert "M503" not in codes_of(scan(tmp_path, {"m.py": other}))


# -- F-series ----------------------------------------------------------------

def test_f601_undocumented_fire_point(tmp_path):
    """A literal fire point missing from the docs/robustness.md
    fault-point table fires F601 (both the direct call and the
    run_in_executor indirection); documented points are quiet."""
    src = """\
import asyncio
from veles_tpu import faults

def tick(loop):
    faults.fire("serving.widget.step", key="w0")
    loop.run_in_executor(None, faults.fire,
                         "router.widget.health", "r1")
    faults.fire("documented.point")
"""
    doc = "| `documented.point` | somewhere |\n"
    f = [x for x in scan(tmp_path, {"m.py": src,
                                    "docs/robustness.md": doc})
         if x.code == "F601"]
    assert {x.detail for x in f} == {"serving.widget.step",
                                     "router.widget.health"}
    # a fully documented tree is quiet
    doc_all = doc + "| `serving.widget.step` | x |\n" \
        "| `router.widget.health` | y |\n"
    assert "F601" not in codes_of(scan(
        tmp_path, {"m.py": src, "docs/robustness.md": doc_all}))


def test_f602_dynamic_fire_point(tmp_path):
    """A computed point name (f-string, %-format, variable) fires
    F602 — the dynamic part belongs in key=, the point must stay a
    greppable fnmatch-stable literal."""
    bad = """\
from veles_tpu import faults

def hit(rid):
    faults.fire(f"router.forward.{rid}")
    faults.fire("router.%s" % rid)
    name = "router.forward"
    faults.fire(name)
"""
    f = [x for x in scan(tmp_path, {"m.py": bad})
         if x.code == "F602"]
    assert len(f) == 3
    ok = """\
from veles_tpu import faults

def hit(rid):
    faults.fire("router.forward", key=rid)
"""
    doc = "`router.forward`\n"
    assert "F602" not in codes_of(scan(
        tmp_path, {"m.py": ok, "docs/robustness.md": doc}))


# -- baseline ----------------------------------------------------------------

def test_baseline_suppresses_and_goes_stale(tmp_path):
    src = ("import jax\nfrom veles_tpu.telemetry import track_jit\n"
           "_step = track_jit('m.step', jax.jit(lambda x: x))\n")
    (tmp_path / "m.py").write_text(src)
    findings, fresh, stale, _ = both_analyze([str(tmp_path)],
                                             tmp_path, False)
    assert [f.code for f in fresh] == ["D103"]
    bl = tmp_path / "bl.txt"
    bl.write_text(format_entry(fresh[0], "fixture: deliberate") + "\n")
    _, fresh2, stale2, _ = both_analyze([str(tmp_path)], tmp_path, bl)
    assert not fresh2 and not stale2
    # fix the finding -> the entry is stale and --strict must say so
    (tmp_path / "m.py").write_text("import jax\n")
    _, fresh3, stale3, _ = both_analyze([str(tmp_path)], tmp_path, bl)
    assert not fresh3 and len(stale3) == 1


def test_baseline_entries_require_reasons(tmp_path):
    from veles_tpu.analysis.baseline import load_baseline as jax_load
    bl = tmp_path / "bl.txt"
    bl.write_text("D103 m.py::<module>::_step\n")
    for load in (load_baseline, jax_load):
        with pytest.raises(ValueError):
            load(bl)


# -- the port's own tree -------------------------------------------------------

def test_package_scans_clean_under_strict():
    """`python -m veles_tpu_torch.analysis --strict` == exit 0: zero
    unbaselined findings, zero stale baseline entries, and every
    baseline entry carries a reason (the loader refuses one without)."""
    findings, fresh, stale, errors = analyze([str(PKG)], root=REPO)
    assert not errors, errors
    assert not fresh, "unbaselined findings:\n" + "\n".join(
        str(f) for f in fresh)
    assert not stale, "stale baseline entries:\n" + "\n".join(stale)
    entries = load_baseline(DEFAULT_BASELINE)
    assert sum(1 for f in findings if f.baselined) == len(entries) >= 10
    assert all(reason for reason in entries.values())


def test_t204_is_silent_over_the_port_and_fires_elsewhere(tmp_path):
    """The port's serving modules compile nothing: T204 asserts nothing
    over them, while the same module text outside the port (a fixture
    tree) fires as the reference's does."""
    findings, _, _, _ = analyze([str(PKG / "serving")], root=REPO,
                                baseline=False)
    assert "T204" not in codes_of(findings)
    text = (PKG / "serving" / "engine.py").read_text()
    copied = scan(tmp_path, {"serving/engine.py": text})
    assert {f.detail for f in copied if f.code == "T204"} >= {
        "serving.slot_step", "serving.paged_step"}


def test_both_analyzers_agree_over_the_port_but_t204():
    """Both analyzers over ``veles_tpu_torch/`` without a baseline: the
    same findings once T204 is set aside, and every C402 the JAX
    package's analyzer reports is a reasoned entry of the port's
    baseline."""
    ours, _, _, _ = analyze([str(PKG)], root=REPO, baseline=False)
    theirs, _, _, _ = jax_analyze([str(PKG)], root=REPO, baseline=False)
    assert _tuples(ours) == _tuples(
        [f for f in theirs if f.code != "T204"])
    assert "T204" in codes_of(theirs)
    entries = load_baseline(DEFAULT_BASELINE)
    for f in theirs:
        if f.code == "C402":
            assert entries.get(f.key), f.key


def test_every_code_has_a_registered_pass():
    from veles_tpu.analysis import ALL_CODES as JAX_CODES
    assert {"D101", "D102", "D103", "T201", "T202", "T203", "T204",
            "L301", "L302", "C401", "C402",
            "M501", "M502", "M503", "F601", "F602"} == set(ALL_CODES)
    assert ALL_CODES == JAX_CODES


def test_cli_json_smoke_and_no_jax_import():
    """The module CLI emits machine-consumable JSON and imports neither
    jax nor the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys, io\n"
         "from contextlib import redirect_stdout\n"
         "import veles_tpu_torch.analysis.__main__ as m\n"
         "buf = io.StringIO()\n"
         "with redirect_stdout(buf):\n"
         "    rc = m.main(['--strict', '--format', 'json'])\n"
         "bad = [n for n in sys.modules\n"
         "       if n == 'jax' or n.split('.')[0] == 'veles_tpu']\n"
         "assert not bad, bad\n"
         "payload = json.loads(buf.getvalue())\n"
         "print(json.dumps({'rc': rc,\n"
         "                  'unbaselined': payload['unbaselined'],\n"
         "                  'baselined': payload['baselined'],\n"
         "                  'stale': payload['stale_baseline']}))\n"],
        capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    digest = json.loads(out.stdout.strip().splitlines()[-1])
    assert digest["rc"] == 0
    assert digest["unbaselined"] == 0
    assert digest["stale"] == []
    assert digest["baselined"] >= 10
