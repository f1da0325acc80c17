"""Training-health monitoring — the port's own copy of
``veles_tpu/telemetry/health.py``.

The trainer (:mod:`veles_tpu_torch.models.gd`) computes a health vector
``[grad_norm, weight_norm, update_ratio, nonfinite, loss]`` on the
device at every step and reports each reading to the process-wide
:data:`monitor`, which exports it as ``veles_health_*`` series in the
port's registry, applies the policy and answers ``/healthz``.

Policy (:func:`configure` ``policy=``):

- ``warn`` (default) — count and log, training continues;
- ``skip_step`` — the trainer drops the anomalous update on the device
  (parameters and optimizer slots keep their pre-step values); counted,
  logged;
- ``halt`` — the monitor latches ``halted`` and the trainer stops
  (``GET /healthz`` then answers 503; the process stays up).

The reference reads these knobs from ``root.common.health`` per step;
the port keeps them in this module (the reference's defaults), where
:func:`configure` changes them after checking them — the command line
hands it ``root.common.health`` (``--health-policy`` among it) before a
run.  The trainer reads the same :func:`health_config` per step, so
the policy it acts on is the one :meth:`HealthMonitor.state` reports.

Loss-history divergence (EMA + patience) is fed through
:meth:`HealthMonitor.observe_loss`.
"""

import logging
import math
import threading

POLICIES = ("warn", "skip_step", "halt")

#: status levels for the ``veles_health_status`` gauge / ``/healthz``
OK, DEGRADED, HALTED = 0, 1, 2
STATUS_NAMES = {OK: "ok", DEGRADED: "degraded", HALTED: "halted"}

log = logging.getLogger("health")

#: the reference's ``root.common.health`` defaults
DEFAULTS = {
    "enabled": True,
    "policy": "warn",
    #: host-side explosion warning threshold (None = off)
    "grad_norm_max": None,
    #: report health every N train dispatches (a span always reports)
    "sync_every": 1,
    "ema_beta": 0.9,
    "divergence_tolerance": 1.5,
    "divergence_patience": 3,
}

_config = dict(DEFAULTS)
_config_lock = threading.Lock()


def _checked(name, value):
    if name == "enabled":
        return bool(value)
    if name == "policy":
        if value not in POLICIES:
            raise ValueError("health policy must be one of %s, not %r"
                             % (POLICIES, value))
        return value
    if name == "grad_norm_max":
        if value is None:
            return None
        value = float(value)
        if not value > 0:
            raise ValueError("grad_norm_max must be > 0 or None")
        return value
    if name in ("sync_every", "divergence_patience"):
        if isinstance(value, bool) or int(value) != value or value < 1:
            raise ValueError("%s must be an int >= 1" % name)
        return int(value)
    if name == "ema_beta":
        value = float(value)
        if not 0.0 <= value < 1.0:
            raise ValueError("ema_beta must be in [0, 1)")
        return value
    value = float(value)        # divergence_tolerance
    if not value > 0:
        raise ValueError("divergence_tolerance must be > 0")
    return value


def configure(**knobs):
    """Set health knobs (names of :data:`DEFAULTS`); every value is
    checked before any is set.  Returns the new :func:`health_config`."""
    unknown = set(knobs) - set(DEFAULTS)
    if unknown:
        raise ValueError("unknown health knobs %s (known: %s)"
                         % (sorted(unknown), sorted(DEFAULTS)))
    checked = {k: _checked(k, v) for k, v in knobs.items()}
    with _config_lock:
        _config.update(checked)
        return dict(_config)


def health_config():
    """The effective knobs (a copy, read per call as the reference reads
    ``root.common.health``)."""
    with _config_lock:
        return dict(_config)


def _series():
    from veles_tpu_torch.telemetry import metrics as registry
    return {
        "nonfinite": registry.counter(
            "veles_health_nonfinite_total",
            "train steps whose loss or gradients were NaN/Inf"),
        "skipped": registry.counter(
            "veles_health_steps_skipped_total",
            "anomalous updates dropped in-graph by the skip_step "
            "policy"),
        "halts": registry.counter(
            "veles_health_halts_total",
            "times the halt policy latched (non-finite step or loss "
            "divergence)"),
        "divergence": registry.counter(
            "veles_health_divergence_events_total",
            "loss-divergence events (loss above EMA*tolerance for "
            "'patience' consecutive observations)"),
        "explosions": registry.counter(
            "veles_health_grad_explosions_total",
            "finite steps whose global grad-norm exceeded "
            "root.common.health.grad_norm_max"),
        "grad_norm": registry.gauge(
            "veles_health_grad_norm",
            "last observed global gradient L2 norm"),
        "weight_norm": registry.gauge(
            "veles_health_weight_norm",
            "last observed global parameter L2 norm"),
        "update_ratio": registry.gauge(
            "veles_health_update_ratio",
            "last observed |param update| / |param| ratio"),
        "loss": registry.gauge(
            "veles_health_loss", "last observed training loss"),
        "loss_ema": registry.gauge(
            "veles_health_loss_ema",
            "EMA of the per-epoch loss fed to divergence detection"),
        "status": registry.gauge(
            "veles_health_status",
            "health policy state: 0 ok, 1 degraded, 2 halted"),
    }


class HealthMonitor:
    """Aggregates health readings, applies the policy, answers
    ``/healthz``.  Thread-safe; one process-wide instance
    (:data:`monitor`) mirrors the registry convention."""

    #: log the first few anomalies verbosely, then every Nth
    WARN_HEAD, WARN_EVERY = 5, 100

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = None
        self.reset()

    def reset(self):
        """Forget observation state (counters in the registry stay —
        they are monotonic; tests assert on deltas)."""
        with self._lock:
            self.status = OK
            self.steps = 0
            self.nonfinite_total = 0
            self.skipped_total = 0
            self.halts_total = 0
            self.divergence_events = 0
            self.last = {}
            self.loss_ema = None
            self.divergence_streak = 0
            self._warned = 0

    def _m(self):
        if self._metrics is None:
            self._metrics = _series()
        return self._metrics

    @property
    def halted(self):
        with self._lock:
            return self.status == HALTED

    @property
    def status_name(self):
        with self._lock:
            return STATUS_NAMES[self.status]

    def _warn(self, msg, *args):
        self._warned += 1
        if self._warned <= self.WARN_HEAD \
                or self._warned % self.WARN_EVERY == 0:
            log.warning(msg + " (occurrence %d)", *(args + (self._warned,)))

    def on_train_step(self, grad_norm, weight_norm, update_ratio,
                      nonfinite, loss=None, unit=None):
        """One (or one span of) train step(s) observed.  ``nonfinite``
        is the count of anomalous steps in the reading.  Returns the
        action taken: ``ok`` / ``warn`` / ``skip_step`` / ``halt``."""
        cfg = health_config()
        m = self._m()
        action = "ok"
        with self._lock:
            self.steps += 1
            self.last = {"grad_norm": grad_norm,
                         "weight_norm": weight_norm,
                         "update_ratio": update_ratio,
                         "loss": loss, "unit": unit}
            m["grad_norm"].set(grad_norm)
            m["weight_norm"].set(weight_norm)
            m["update_ratio"].set(update_ratio)
            if loss is not None:
                m["loss"].set(loss)
            if nonfinite and nonfinite > 0:
                n = int(nonfinite)
                self.nonfinite_total += n
                m["nonfinite"].inc(n)
                if cfg["policy"] == "halt":
                    self.status = HALTED
                    self.halts_total += 1
                    m["halts"].inc()
                    action = "halt"
                elif cfg["policy"] == "skip_step":
                    self.skipped_total += n
                    m["skipped"].inc(n)
                    self.status = max(self.status, DEGRADED)
                    action = "skip_step"
                else:
                    self.status = max(self.status, DEGRADED)
                    action = "warn"
                self._warn(
                    "non-finite training step (x%d) in %s - policy %s",
                    n, unit or "?", cfg["policy"])
            elif cfg["grad_norm_max"] is not None \
                    and math.isfinite(grad_norm) \
                    and grad_norm > float(cfg["grad_norm_max"]):
                m["explosions"].inc()
                self.status = max(self.status, DEGRADED)
                action = "warn"
                self._warn(
                    "gradient explosion: |g|=%.3g > %.3g in %s",
                    grad_norm, float(cfg["grad_norm_max"]), unit or "?")
            m["status"].set(self.status)
        return action

    def observe_loss(self, loss):
        """Epoch-level loss for divergence detection (EMA + patience).
        Returns ``ok`` / ``diverging`` / ``halt``."""
        cfg = health_config()
        m = self._m()
        action = "ok"
        with self._lock:
            loss = float(loss)
            finite = math.isfinite(loss)
            if self.loss_ema is None:
                if finite:
                    self.loss_ema = loss
                    m["loss_ema"].set(loss)
                return "ok"
            threshold = self.loss_ema * cfg["divergence_tolerance"] + 1e-12
            if not finite or loss > threshold:
                self.divergence_streak += 1
            else:
                self.divergence_streak = 0
            if finite:
                beta = cfg["ema_beta"]
                self.loss_ema = beta * self.loss_ema + (1.0 - beta) * loss
                m["loss_ema"].set(self.loss_ema)
            if self.divergence_streak >= cfg["divergence_patience"]:
                self.divergence_streak = 0  # re-arm
                self.divergence_events += 1
                m["divergence"].inc()
                self.status = max(self.status, DEGRADED)
                action = "diverging"
                if cfg["policy"] == "halt":
                    self.status = HALTED
                    self.halts_total += 1
                    m["halts"].inc()
                    action = "halt"
                self._warn(
                    "loss divergence: %.4g above EMA %.4g for %d "
                    "epochs - policy %s", loss, self.loss_ema,
                    cfg["divergence_patience"], cfg["policy"])
            m["status"].set(self.status)
        return action

    def state(self):
        """Plain-dict state for ``/healthz`` and the flight recorder."""
        with self._lock:
            return {
                "status": STATUS_NAMES[self.status],
                "policy": health_config()["policy"],
                "steps_observed": self.steps,
                "nonfinite_total": self.nonfinite_total,
                "skipped_total": self.skipped_total,
                "halts_total": self.halts_total,
                "divergence_events": self.divergence_events,
                "loss_ema": self.loss_ema,
                "divergence_streak": self.divergence_streak,
                "last": dict(self.last),
            }

    def summary_line(self):
        """One-line digest (None when no training was observed)."""
        with self._lock:
            if not self.steps:
                return None
            last = self.last
            return ("health: %s  steps %d  nonfinite %d  skipped %d  "
                    "divergence %d  |g| %.3g  |w| %.3g  du/u %.3g"
                    % (STATUS_NAMES[self.status], self.steps,
                       self.nonfinite_total, self.skipped_total,
                       self.divergence_events,
                       last.get("grad_norm") or 0.0,
                       last.get("weight_norm") or 0.0,
                       last.get("update_ratio") or 0.0))


#: process-wide monitor (the ``/healthz`` surface)
monitor = HealthMonitor()
