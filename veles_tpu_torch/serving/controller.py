"""The fleet control plane — a decision loop over the router, the fleet
and the observability plane; the port's own copy of
``veles_tpu/serving/controller.py``.

The router gives the fleet eyes (federated metrics, the multi-window
SLO burn pair) and the fleet reflexes (respawn, re-role for coverage),
but replica count, the prefill:decode specialist ratio and the KV-pressure
knobs all stayed static while load is not.  :class:`FleetController`
runs beside the router (same host, its own ticker thread — the
:class:`~veles_tpu_torch.telemetry.alerts.AlertEngine` shape) and closes
three loops, every decision an auditable JSONL event plus
``veles_controller_*`` series:

- **replica autoscaling** — scale UP when the fast+slow SLO-burn
  pair fires (``slo_burn_*`` rules on the router's alert engine —
  the multi-window pair is precisely an autoscaler's up signal: fast
  enough to matter, slow enough to be real) or the mean per-replica
  queue depth crosses ``queue_high``; scale DOWN through the
  existing ``router.drain_replica`` → drained poll →
  :meth:`Fleet.retire` path (never a hard kill) only after
  ``quiet_ticks`` consecutive calm ticks with slot occupancy under
  ``occupancy_low``.  Hysteresis everywhere: each direction has its
  own cooldown, bounds are ``[min_replicas, max_replicas]``, and the
  ``controller_flapping`` alert rule watches the transition counter
  in case the thresholds are mis-tuned anyway.
- **role-proportion sizing** — :meth:`Fleet.rebalance`
  restores role COVERAGE only (a pool must never be empty); this
  loop moves the RATIO: when decode slot occupancy outruns prefill
  queue pressure by more than ``role_deadband`` (or vice versa), the
  least-loaded surplus specialist restarts into the starved role via
  :meth:`Fleet.restart_as` — the same ``spawn(index, role)``
  machinery a coverage rebalance uses, and never the last member of
  a pool.
- **KV knob tuning** — sustained KV pressure over
  ``kv_pressure_high`` tightens every replica's admission shedding
  (``shed_block_factor`` down one ``shed_step`` through the
  admin-gated ``POST /serving/tune``, clamped to
  ``[shed_min, shed_max]``; pressure under ``kv_pressure_low``
  relaxes it back) and emits a ``recommend_kv_blocks`` audit event
  sizing the pool a restart should provision — recommendations are
  decisions an operator replays from the audit trail, never a live
  repool.

The controller has a memory: when the router carries a
history store (:mod:`veles_tpu_torch.telemetry.tsdb`), every tick reads a
smoothed ``history_window`` of fleet-merged KV pressure and goodput
instead of trusting one instantaneous sample — KV tuning acts on the
windowed average, ``recommend_kv_blocks`` sizes the pool from the
observed pressure *p95* (the percentile a provisioning decision
should survive, not the moment the tick happened to land on), and
every audit record carries the ``window`` stats it decided from.
With no store (or an empty window) each consumer falls back to the
instantaneous observation, so the controller never stalls on its own
telemetry.

Config ``root.common.controller.*``, default OFF — :meth:`start`
refuses to arm unless ``enabled`` is set, so a fleet never drives
itself without an operator's say-so.  The loop consumes only
thread-safe router surfaces (:meth:`Router.replica_state`, the alert
engine's ``firing()``) and actuates only through public fleet/router
methods, so every decision path is unit-testable by stubbing the
observation and actuation seams.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque

from veles_tpu_torch.logger import Logger, events
from veles_tpu_torch.telemetry import metrics

__all__ = ("FleetController",)


def _controller_conf(name, default):
    from veles_tpu_torch.config import root
    return root.common.controller.get(name, default)


def _controller_series():
    return {
        "decisions": metrics.counter(
            "veles_controller_decisions_total",
            "control-plane decisions taken, by action (scale_up / "
            "scale_down / rerole / tune_shed / recommend_kv_blocks)",
            labelnames=("action",)),
        "transitions": metrics.counter(
            "veles_controller_scale_transitions_total",
            "replica-count scale transitions (up or down) — the "
            "controller_flapping alert rule watches increase() here"),
        "replicas": metrics.gauge(
            "veles_controller_replicas",
            "live replicas the controller observed on its last tick"),
        "ticks": metrics.counter(
            "veles_controller_ticks_total",
            "control-loop evaluation passes"),
    }


class FleetController(Logger):
    """The autoscaling / role-ratio / KV-tuning loop over one
    ``(router, fleet)`` pair (module docstring has the contract).
    ``start()`` arms the ticker thread only when
    ``root.common.controller.enabled``; ``tick()`` is one evaluation
    pass and is how tests drive the state machine directly."""

    def __init__(self, router, fleet, interval=None, tsdb=None):
        super(FleetController, self).__init__()
        self.router = router
        self.fleet = fleet
        #: explicit history store; None resolves the router's
        #: (lazily, per tick — the router builds its store at
        #: start(), usually after this constructor ran)
        self.tsdb = tsdb
        self.interval = float(
            _controller_conf("interval", 2.0)
            if interval is None else interval)
        #: bounded audit ring: the in-process "why did it scale?"
        #: record (every entry is ALSO a controller.decision JSONL
        #: event — the ring is the live view, the sink the archive)
        self.decisions = deque(
            maxlen=int(_controller_conf("audit_keep", 256)))
        self.ticks = 0
        self._quiet = 0              # consecutive calm ticks
        self._last_up = 0.0          # monotonic cooldown anchors
        self._last_down = 0.0
        self._last_rerole = 0.0
        self._last_tune = 0.0
        self._shed_factor = None     # last factor this loop pushed
        self._global = _controller_series()
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._thread = None

    @staticmethod
    def enabled():
        """The arming knob (``root.common.controller.enabled``,
        default False): an unarmed controller observes nothing and
        acts never."""
        return bool(_controller_conf("enabled", False))

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if not self.enabled():
            self.info("controller not armed "
                      "(root.common.controller.enabled is off)")
            return self
        with self._lifecycle:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="fleet-controller")
                self._thread.start()
                self.info("fleet controller armed: tick %.2fs, "
                          "replicas [%d, %d]", self.interval,
                          int(_controller_conf("min_replicas", 1)),
                          int(_controller_conf("max_replicas", 4)))
        return self

    def stop(self):
        self._stop.set()
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(10)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:   # the loop must outlive any bug
                self.warning("controller tick failed: %r", e)

    # -- observation -------------------------------------------------------

    def _observe(self):
        """One thread-safe fleet observation: the live (healthy,
        non-draining) replica views plus the aggregates every
        decision reads."""
        state = self.router.replica_state()
        live = [r for r in state["replicas"]
                if r.get("healthy") and not r.get("draining")]
        queues = [float(r.get("queue_depth") or 0) for r in live]
        active = sum(int(r.get("active_slots") or 0) for r in live)
        cap = sum(int(r.get("max_slots") or 0) for r in live)
        used = sum(int(r.get("kv_blocks_used") or 0) for r in live)
        free = sum(int(r.get("kv_blocks_free") or 0) for r in live)
        return {
            "live": live,
            "queue_mean": sum(queues) / len(queues) if queues
            else 0.0,
            "occupancy": active / cap if cap else 0.0,
            "kv_pressure": used / (used + free) if used + free
            else 0.0,
            "kv_blocks_total": used + free,
            "window": self._window_stats(),
        }

    def _window_stats(self):
        """Smoothed history over the router's fleet-merged store:
        ``history_window`` seconds of KV pressure (avg + p95) and
        goodput.  None when there is no store or no data yet — every
        consumer then falls back to the instantaneous sample, so the
        controller keeps working while its memory warms up."""
        store = self.tsdb if self.tsdb is not None \
            else getattr(self.router, "tsdb", None)
        if store is None:
            return None
        window = float(_controller_conf("history_window", 30.0))
        try:
            kv_avg = store.range("veles_serving_kv_pressure",
                                 window=window, agg="avg")
            kv_p95 = store.range("veles_serving_kv_pressure",
                                 window=window, agg="p95")
            goodput = store.range(
                "veles_serving_goodput_tokens_per_sec",
                window=window, agg="avg")
        except Exception as e:
            self.warning("history window read failed: %r", e)
            return None
        if kv_avg is None and kv_p95 is None and goodput is None:
            return None
        out = {"window_s": window}
        if kv_avg is not None:
            out["kv_pressure_avg"] = round(kv_avg, 4)
        if kv_p95 is not None:
            out["kv_pressure_p95"] = round(kv_p95, 4)
        if goodput is not None:
            out["goodput_avg"] = round(goodput, 3)
        return out

    def _burn_firing(self):
        """The firing SLO-burn rules on the router's alert engine —
        the ``slo_burn`` kind already requires BOTH its fast and
        slow windows over threshold, so one firing rule IS the
        multi-window pair agreeing."""
        engine = getattr(self.router, "alerts", None)
        if engine is None:
            return ()
        try:
            return tuple(sorted({str(row["rule"])
                                 for row in engine.firing()
                                 if str(row["rule"])
                                 .startswith("slo_burn")}))
        except Exception:
            return ()

    # -- the loop ----------------------------------------------------------

    def tick(self, now=None):
        """One evaluation pass; returns the structural decision it
        took (a dict from the audit ring) or None.  At most one
        structural action (scale or re-role) per tick — KV tuning
        rides along independently."""
        now = time.monotonic() if now is None else now
        self.ticks += 1
        self._global["ticks"].inc()
        try:
            obs = self._observe()
        except Exception as e:
            self.warning("controller observation failed: %r", e)
            return None
        self._global["replicas"].set(len(obs["live"]))
        burn = self._burn_firing()
        calm = not burn \
            and obs["queue_mean"] < float(
                _controller_conf("queue_high", 4.0)) \
            and obs["occupancy"] <= float(
                _controller_conf("occupancy_low", 0.3))
        self._quiet = self._quiet + 1 if calm else 0
        action = self._maybe_scale_up(obs, burn, now)
        if action is None:
            action = self._maybe_scale_down(obs, burn, now)
        if action is None:
            action = self._maybe_rerole(obs, now)
        self._maybe_tune(obs, now)
        return action

    # -- loop (a): replica autoscaling -------------------------------------

    def _maybe_scale_up(self, obs, burn, now):
        queue_high = float(_controller_conf("queue_high", 4.0))
        if not burn and obs["queue_mean"] < queue_high:
            return None
        if len(obs["live"]) >= int(
                _controller_conf("max_replicas", 4)):
            return None
        if now - self._last_up < float(
                _controller_conf("scale_up_cooldown", 10.0)):
            return None
        role = self._grow_role(obs)
        try:
            index = self.fleet.grow(role=role)
        except Exception as e:
            self.warning("scale-up spawn failed: %r", e)
            return None
        self._last_up = now
        self._quiet = 0
        return self._decide(
            "scale_up", index=index, role=role,
            reason="slo_burn" if burn else "queue_depth",
            burn_rules=list(burn),
            queue_mean=round(obs["queue_mean"], 3),
            replicas=len(obs["live"]) + 1,
            window=obs.get("window"))

    def _grow_role(self, obs):
        """The role a scale-up spawns with: None for homogeneous
        fleets; for specialist fleets, the phase under more pressure
        (decode slot occupancy vs prefill queueing)."""
        if not self.fleet.roles:
            return None
        pf_p, dc_p = self._role_pressures(obs)
        return "decode" if dc_p >= pf_p else "prefill"

    def _maybe_scale_down(self, obs, burn, now):
        if burn or self._quiet < int(
                _controller_conf("quiet_ticks", 5)):
            return None
        live = obs["live"]
        if len(live) <= int(_controller_conf("min_replicas", 1)):
            return None
        if now - self._last_down < float(
                _controller_conf("scale_down_cooldown", 30.0)):
            return None
        victim = self._drain_victim(live)
        if victim is None:
            return None
        index = self.fleet.index_of(victim["id"])
        if index is None:
            return None
        if not self._retire(victim, index):
            return None
        self._last_down = now
        self._quiet = 0
        return self._decide(
            "scale_down", index=index, replica=victim["id"],
            reason="quiet", occupancy=round(obs["occupancy"], 3),
            queue_mean=round(obs["queue_mean"], 3),
            replicas=len(live) - 1,
            window=obs.get("window"))

    def _drain_victim(self, live):
        """The replica a scale-down drains: least outstanding work,
        never the last live member of a specialist pool."""
        pools = {}
        for r in live:
            pools[r.get("role")] = pools.get(r.get("role"), 0) + 1
        candidates = [r for r in live
                      if not self.fleet.roles
                      or pools.get(r.get("role"), 0) >= 2]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda r: (int(r.get("outstanding") or 0),
                                  int(r.get("queue_depth") or 0),
                                  r["id"]))

    def _retire(self, victim, index, timeout=30.0, poll=0.05):
        """The graceful half of scale-down: drain through the router
        (routing stops immediately), poll the replica's /healthz
        until in-flight work finished, then retire the fleet index —
        never a hard kill under live requests."""
        rid = victim["id"]
        try:
            self.router.drain_replica(rid)
        except Exception as e:
            self.warning("scale-down drain of %s failed: %r", rid, e)
            return False
        deadline = time.monotonic() + timeout
        url = "http://%s:%s/healthz" % (victim["host"],
                                        victim["port"])
        while time.monotonic() < deadline:
            try:
                health = self._get_json(url)
            except Exception:
                break            # replica already gone: retire it
            if health.get("drained") or not health.get("in_flight"):
                break
            time.sleep(poll)
        try:
            self.fleet.retire(index)
        except Exception as e:
            self.warning("retire of replica %d failed: %r", index, e)
            return False
        return True

    # -- loop (b): role-proportion sizing ----------------------------------

    def _role_pressures(self, obs):
        """Normalized (prefill, decode) pressure pair: prefill
        queue depth against ``queue_high`` vs decode slot occupancy
        (both ~[0, 1]; the deadband compares them directly)."""
        queue_high = max(1.0, float(
            _controller_conf("queue_high", 4.0)))
        pf = [r for r in obs["live"] if r.get("role") == "prefill"]
        dc = [r for r in obs["live"] if r.get("role") == "decode"]
        pf_q = [float(r.get("queue_depth") or 0) for r in pf]
        pf_p = (sum(pf_q) / len(pf_q) / queue_high) if pf_q else 0.0
        act = sum(int(r.get("active_slots") or 0) for r in dc)
        cap = sum(int(r.get("max_slots") or 0) for r in dc)
        dc_p = act / cap if cap else 0.0
        return pf_p, dc_p

    def _maybe_rerole(self, obs, now):
        if not self.fleet.roles:
            return None
        if now - self._last_rerole < float(
                _controller_conf("scale_up_cooldown", 10.0)):
            return None
        pf = [r for r in obs["live"] if r.get("role") == "prefill"]
        dc = [r for r in obs["live"] if r.get("role") == "decode"]
        if not pf or not dc:
            return None      # coverage is Fleet.rebalance()'s job
        pf_p, dc_p = self._role_pressures(obs)
        deadband = float(_controller_conf("role_deadband", 0.25))
        if dc_p - pf_p > deadband and len(pf) >= 2:
            donors, role = pf, "decode"
        elif pf_p - dc_p > deadband and len(dc) >= 2:
            donors, role = dc, "prefill"
        else:
            return None
        victim = min(donors,
                     key=lambda r: (int(r.get("outstanding") or 0),
                                    int(r.get("queue_depth") or 0),
                                    r["id"]))
        index = self.fleet.index_of(victim["id"])
        if index is None:
            return None
        try:
            self.fleet.restart_as(index, role)
        except Exception as e:
            self.warning("re-role of replica %d failed: %r",
                         index, e)
            return None
        self._last_rerole = now
        return self._decide(
            "rerole", index=index, replica=victim["id"], role=role,
            prefill_pressure=round(pf_p, 3),
            decode_pressure=round(dc_p, 3))

    # -- loop (c): KV knob tuning ------------------------------------------

    def _maybe_tune(self, obs, now):
        if not obs["live"] or now - self._last_tune < float(
                _controller_conf("scale_up_cooldown", 10.0)):
            return None
        high = float(_controller_conf("kv_pressure_high", 0.85))
        low = float(_controller_conf("kv_pressure_low", 0.5))
        step = float(_controller_conf("shed_step", 0.5))
        lo = float(_controller_conf("shed_min", 1.0))
        hi = float(_controller_conf("shed_max", 8.0))
        window = obs.get("window")
        # the smoothed window (when the history store has one) beats
        # the instantaneous sample: one tick landing on a transient
        # spike/trough must not whipsaw admission shedding
        pressure = window["kv_pressure_avg"] \
            if window and "kv_pressure_avg" in window \
            else obs["kv_pressure"]
        if pressure >= high:
            base = hi / 2.0 if self._shed_factor is None \
                else self._shed_factor
            target = max(lo, base - step)
        elif pressure <= low and self._shed_factor is not None:
            # only relax a knob this loop previously tightened — an
            # idle fleet is NOT a signal to loosen admission shedding
            target = min(hi, self._shed_factor + step)
        else:
            return None
        if pressure >= high:
            # sizing recommendation rides the audit trail only — a
            # pool repool needs a restart, which is the operator's
            # (or a future rolling-restart policy's) call.  Sized
            # from the OBSERVED pressure percentile when history is
            # available: a pool provisioned so the window's p95
            # lands at kv_pressure_high, not a flat fudge factor
            p95 = (window or {}).get("kv_pressure_p95")
            if p95 is not None and high > 0:
                blocks = int(-(-obs["kv_blocks_total"] * p95 // high))
            else:
                blocks = int(obs["kv_blocks_total"] * 1.25)
            self._decide(
                "recommend_kv_blocks", kv_blocks=blocks or None,
                kv_pressure=round(pressure, 3), window=window)
        if target == self._shed_factor:
            return None
        applied = [r["id"] for r in obs["live"]
                   if self._tune_replica(r, target)]
        self._last_tune = now
        if not applied:
            return None
        self._shed_factor = target
        return self._decide(
            "tune_shed", shed_block_factor=target,
            kv_pressure=round(pressure, 3), replicas=applied,
            window=window)

    def _tune_replica(self, view, factor):
        """POST /serving/tune to one replica (admin bearer when
        configured — the same trust path /drain uses)."""
        url = "http://%s:%s/serving/tune" % (view["host"],
                                             view["port"])
        headers = {"Content-Type": "application/json"}
        from veles_tpu_torch.config import root
        token = root.common.api.get("admin_token", None)
        if token:
            headers["Authorization"] = "Bearer %s" % token
        try:
            req = urllib.request.Request(
                url, data=json.dumps(
                    {"shed_block_factor": factor}).encode(),
                headers=headers)
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return resp.status == 200
        except Exception as e:
            self.warning("tune of %s failed: %r", view["id"], e)
            return False

    @staticmethod
    def _get_json(url, timeout=5.0):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read().decode())
            except Exception:
                return {}

    # -- audit -------------------------------------------------------------

    def _decide(self, action, **detail):
        """One auditable decision: the bounded ring (the live "why
        did it scale?" view), the controller.decision JSONL event
        (the archive) and the veles_controller_* series (the
        dashboard) all record it."""
        rec = {"t": round(time.time(), 3), "tick": self.ticks,
               "action": action}
        rec.update({k: v for k, v in detail.items()
                    if v is not None})
        self.decisions.append(rec)
        self._global["decisions"].labels(action=action).inc()
        if action in ("scale_up", "scale_down"):
            self._global["transitions"].inc()
        events.record("controller.decision", "single",
                      cls="FleetController", **rec)
        self.info("controller decision: %s", rec)
        return rec

    def audit(self):
        """The decision ring, oldest first — the object half of the
        docs/fleet.md audit walkthrough."""
        return list(self.decisions)
