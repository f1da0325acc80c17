"""Training health and the flight recorder of the PyTorch port
(``veles_tpu_torch/telemetry/{health,flight_recorder}.py``, the
trainer's report to ``monitor``, ``/healthz`` and ``/debug/state``)
held against the JAX package on the CPU.

Oracles: ``tests/test_health.py::test_monitor_nonfinite_policies``,
``::test_monitor_divergence_ema_patience``,
``::test_flight_recorder_sigusr1_dump``,
``::test_flight_recorder_excepthook_and_manual_dump`` and
``::test_rest_healthz_and_debug_state``.

The monitors are compared exactly: the same readings under the same
knobs give the same actions and the same ``state()``."""

import json
import math
import os
import signal
import sys
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.config import root
from veles_tpu.telemetry import health as ref_health
from veles_tpu_torch.logger import events
from veles_tpu_torch.telemetry import health, metrics
from veles_tpu_torch.telemetry.flight_recorder import FlightRecorder

pytestmark = pytest.mark.torch_port

KNOBS = ("policy", "divergence_patience", "divergence_tolerance",
         "ema_beta", "grad_norm_max")


@pytest.fixture
def knobs():
    """Set the same health knobs in both packages; restore both (and the
    port's process-wide monitor) after."""
    saved = {k: root.common.health.get(k) for k in KNOBS}
    health.configure(**health.DEFAULTS)
    health.monitor.reset()

    def set_knobs(**kw):
        health.configure(**kw)
        for k, v in kw.items():
            setattr(root.common.health, k, v)

    yield set_knobs
    for k, v in saved.items():
        setattr(root.common.health, k, v)
    health.configure(**health.DEFAULTS)
    health.monitor.reset()


#: (grad_norm, weight_norm, update_ratio, nonfinite, loss) readings: clean
#: steps, non-finite ones (one a span of 2), a grad-norm explosion, and a
#: clean step after them
READINGS = [(1.0, 2.0, 0.01, 0.0, 0.5), (1.0, 2.0, 0.01, 1.0, 0.5),
            (3.0, 2.5, 0.02, 2.0, float("nan")), (50.0, 3.0, 0.1, 0.0, 0.4),
            (1.0, 2.0, 0.01, 0.0, None)]


def _run_readings(mon):
    return [mon.on_train_step(g, w, u, nonfinite=n, loss=loss, unit="t")
            for g, w, u, n, loss in READINGS]


def _same_state(got, want):
    """Equal states, NaN equal to NaN."""
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("policy", health.POLICIES)
@pytest.mark.parametrize("grad_norm_max", [None, 10.0])
def test_monitor_policies_match_reference(knobs, policy, grad_norm_max):
    knobs(policy=policy, grad_norm_max=grad_norm_max)
    port, ref = health.HealthMonitor(), ref_health.HealthMonitor()
    assert _run_readings(port) == _run_readings(ref)
    _same_state(port.state(), ref.state())
    assert port.halted == ref.halted == (policy == "halt")
    assert port.status_name == ref.status_name
    assert port.summary_line() == ref.summary_line()


@pytest.mark.parametrize("policy", health.POLICIES)
@pytest.mark.parametrize("losses,patience", [
    ((1.0, 1.01, 5.0, 50.0, 500.0), 3),
    ((1.0, float("nan"), float("nan"), 0.9, 2.0, 3.0), 2),
    ((float("nan"), 1.0, 1.2, 1.6, 1.7, 4.0, 0.5), 1)])
def test_divergence_matches_reference(knobs, policy, losses, patience):
    knobs(policy=policy, divergence_patience=patience,
          divergence_tolerance=1.5, ema_beta=0.9)
    port, ref = health.HealthMonitor(), ref_health.HealthMonitor()
    assert [port.observe_loss(x) for x in losses] \
        == [ref.observe_loss(x) for x in losses]
    _same_state(port.state(), ref.state())
    assert port.loss_ema is None or math.isfinite(port.loss_ema)


def test_monitor_series_and_latch(knobs):
    """The process-wide monitor counts into the port's registry, and a
    clean step does not un-latch halt (the reference's test order)."""
    base = metrics.get("veles_health_nonfinite_total")
    base = base.value if base is not None else 0.0
    knobs(policy="warn")
    assert health.monitor.on_train_step(1.0, 2.0, 0.01, nonfinite=1.0,
                                        loss=0.5, unit="t") == "warn"
    knobs(policy="skip_step")
    assert health.monitor.on_train_step(1.0, 2.0, 0.01, nonfinite=2.0,
                                        loss=0.5, unit="t") == "skip_step"
    knobs(policy="halt")
    assert health.monitor.on_train_step(1.0, 2.0, 0.01, nonfinite=1.0,
                                        loss=0.5, unit="t") == "halt"
    assert metrics.get("veles_health_nonfinite_total").value - base == 4
    health.monitor.on_train_step(1.0, 2.0, 0.01, nonfinite=0.0, unit="t")
    assert health.monitor.halted
    assert metrics.get("veles_health_status").value == health.HALTED
    assert "veles_health_halts_total" in metrics.render_prometheus()


@pytest.mark.parametrize("knob,value", [
    ("policy", "stop"), ("sync_every", 0), ("sync_every", 1.5),
    ("divergence_patience", 0), ("ema_beta", 1.0),
    ("divergence_tolerance", 0), ("grad_norm_max", -1), ("nope", 1)])
def test_configure_checks_its_knobs(knobs, knob, value):
    before = health.health_config()
    with pytest.raises(ValueError):
        health.configure(**{knob: value})
    assert health.health_config() == before == health.DEFAULTS


# -- the trainer's report -----------------------------------------------------

def _nan_trainer(policy, **gd):
    """A tiny LM chain whose embedding row 0 is NaN, trained on
    sequences that hold token 0: its first train step is non-finite."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.samples.lm import lm_spec
    chain = init_params(lm_spec(12, 8, 1, 2), 0, 8, device="cpu",
                        dtype="float32")
    with torch.no_grad():
        chain[0].params["weights"][0] = float("nan")
    tokens = numpy.random.default_rng(0).integers(0, 12, (8, 8))
    tokens[:, 3] = 0
    loader = FullBatchLoader(tokens.astype(numpy.int32), None, [0, 0, 8],
                             minibatch_size=4, seed=0, device="cpu")
    return chain, loader, GradientDescent(
        chain, EvaluatorNextToken(), solver="sgd", learning_rate=0.01,
        health_policy=policy, **gd)


def _get(url):
    try:
        body = urllib.request.urlopen(url, timeout=30)
        return body.status, json.load(body)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_trainer_reports_nan_and_healthz_halts(knobs):
    """The port's trainer reports a planted NaN step to ``monitor``; under
    ``halt`` the trainer stops and ``/healthz`` answers 503 "halted"."""
    from veles_tpu_torch.restful_api import RESTfulAPI
    api = RESTfulAPI(device="cpu")
    api.initialize()
    try:
        url = "http://127.0.0.1:%d/healthz" % api.port
        code, payload = _get(url)
        assert code == 200 and payload["status"] == "ok"
        assert payload["health"]["policy"] == "warn"
        _, loader, gd = _nan_trainer("halt")
        assert health.health_config()["policy"] == gd.health_policy == "halt"
        loader.serve_span()
        gd.run_span(loader)
        state = health.monitor.state()
        assert gd.halted and health.monitor.halted
        assert state["nonfinite_total"] == gd.nonfinite_steps >= 1
        assert state["steps_observed"] == 1 and state["last"]["unit"]
        code, payload = _get(url)
        assert code == 503
        assert payload["status"] == "halted"
        assert payload["health"]["policy"] == "halt"
        code, payload = _get(url + "?probe=1")
        assert code == 503 and payload["health"]["halts_total"] == 1
    finally:
        api.stop()


@pytest.mark.parametrize("policy", ["warn", "skip_step"])
def test_trainer_acts_on_the_monitors_policy(knobs, policy):
    """The trainer's ``health_policy`` is the configured one: a policy
    configured after the trainer was built is the one it acts on, and
    the monitor's verdict sets its counters."""
    chain, loader, gd = _nan_trainer(None)
    assert gd.health_policy == "warn"
    knobs(policy=policy)
    assert gd.health_policy == policy
    before = chain[1].params["wq"].detach().clone()
    loader.serve_span()
    gd.run_span(loader)
    state = health.monitor.state()
    assert state["policy"] == policy and not gd.halted
    assert gd.nonfinite_steps == state["nonfinite_total"] >= 1
    assert gd.skipped_steps == state["skipped_total"] \
        == (gd.nonfinite_steps if policy == "skip_step" else 0)
    assert state["status"] == "degraded"
    # every minibatch holds token 0: skip_step keeps every weight, warn
    # lets the NaN in
    after = chain[1].params["wq"].detach()
    if policy == "skip_step":
        assert torch.equal(after, before)
    else:
        assert not torch.isfinite(after).all()


def test_trainer_sync_every_and_disable(knobs):
    """``sync_every`` decimates the per-minibatch reports; ``enabled``
    off stops them."""
    from veles_tpu_torch.loader import TRAIN
    knobs(policy="warn")
    health.configure(sync_every=2)
    _, loader, gd = _nan_trainer(None)
    x = loader.dataset_dev[:4]
    for _ in range(4):
        gd.run_minibatch(x, None, 4, TRAIN)
    assert health.monitor.state()["steps_observed"] == 2
    health.configure(enabled=False)
    gd.run_minibatch(x, None, 4, TRAIN)
    gd.run_minibatch(x, None, 4, TRAIN)
    assert health.monitor.state()["steps_observed"] == 2


# -- the flight recorder ------------------------------------------------------

def _check_bundle(path, reason_prefix):
    with open(path) as f:
        bundle = json.load(f)
    assert bundle["reason"].startswith(reason_prefix)
    assert bundle["pid"] == os.getpid()
    for key in ("events", "metrics", "config", "threads", "logs",
                "requests"):
        assert key in bundle, "bundle missing %r" % key
    assert "health" in bundle and "status" in bundle["health"]
    # the live engines' sections: firing rows of every engine, tier-0
    # tails of every store (empty with none running)
    assert isinstance(bundle["alerts"], list)
    assert isinstance(bundle["history"], dict)
    assert bundle["config"]["health"]["policy"] in health.POLICIES
    assert "jax" not in bundle
    return bundle


def test_flight_recorder_sigusr1_dump(tmp_path):
    rec = FlightRecorder(max_events=64)
    rec.install(directory=str(tmp_path))
    try:
        events.record("pre-crash-breadcrumb", "single", detail=42)
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 10
        while not rec.dumps and time.time() < deadline:
            time.sleep(0.02)
        assert rec.dumps, "SIGUSR1 produced no flight-recorder bundle"
        bundle = _check_bundle(rec.dumps[-1], "signal:SIGUSR1")
        assert any(ev.get("name") == "pre-crash-breadcrumb"
                   for ev in bundle["events"])
        assert len(bundle["events"]) <= 64
    finally:
        rec.uninstall()


def test_flight_recorder_excepthook_and_manual_dump(tmp_path):
    import logging
    rec = FlightRecorder()
    prev = sys.excepthook
    rec.install(directory=str(tmp_path), signals=())
    try:
        assert sys.excepthook == rec._excepthook
        logging.getLogger("some.module").warning("logged before the crash")
        try:
            raise RuntimeError("boom for the recorder")
        except RuntimeError:
            rec._excepthook(*sys.exc_info())
        bundle = _check_bundle(rec.dumps[-1], "exception:RuntimeError")
        assert "boom for the recorder" in bundle["exception"]
        assert any(r["message"] == "logged before the crash"
                   for r in bundle["logs"])
        path = rec.dump("manual")
        assert path and os.path.exists(path)
        state = rec.state()
        assert state["installed"] and len(state["dumps"]) == 2
        assert state["dir"] == str(tmp_path)
    finally:
        rec.uninstall()
    assert not rec.state()["installed"]
    assert sys.excepthook == prev


def test_debug_state_carries_a_breadcrumb(knobs):
    from veles_tpu_torch.restful_api import RESTfulAPI
    api = RESTfulAPI(device="cpu")
    api.initialize()
    try:
        events.record("debug-state-breadcrumb", "single")
        code, payload = _get("http://127.0.0.1:%d/debug/state" % api.port)
        assert code == 200
        assert payload["health"] == health.monitor.state()
        assert set(payload["flightrec"]) == {
            "installed", "dir", "dumps", "uptime_s", "events_buffered",
            "logs_buffered"}
        assert any(ev.get("name") == "debug-state-breadcrumb"
                   for ev in payload["events"])
        assert isinstance(payload["logs"], list)
    finally:
        api.stop()
