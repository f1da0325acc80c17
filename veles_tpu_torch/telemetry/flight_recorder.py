"""Crash flight recorder — the port's own copy of
``veles_tpu/telemetry/flight_recorder.py``.

:class:`FlightRecorder` keeps post-mortem forensics inside the process,
ready to dump at the moment of death:

- a bounded tail of recent log records (a root-logger handler feeding
  :attr:`FlightRecorder.log_ring`) beside the event ring that
  :data:`veles_tpu_torch.logger.events` keeps;
- :meth:`FlightRecorder.install` registers the crash paths —
  ``faulthandler`` for native faults (stacks to stderr), a ``SIGUSR1``
  handler for on-demand dumps of a live process and a chained
  ``sys.excepthook`` for unhandled exceptions;
- :meth:`FlightRecorder.dump` writes the bundle to
  ``<dir>/flightrec-<pid>.json`` (``dir``: :meth:`~FlightRecorder.
  install`'s, else the working directory): the recent events, the
  registry's snapshot, the port's configuration (the health knobs), the
  platform and torch, every thread's stack, the
  health monitor's state, the log tail, the live in-flight request
  table of every registered scheduler and router, the firing alerts of
  every live :class:`~veles_tpu_torch.telemetry.alerts.AlertEngine`
  (``alerts``) and the recent history of the key serving series from
  every live :class:`~veles_tpu_torch.telemetry.tsdb.TimeSeriesStore`
  (``history``).

``GET /debug/state`` (:mod:`veles_tpu_torch.restful_api`) serves the
same ingredients from the live process.  :meth:`FlightRecorder.install`
registers an ``atexit`` hook that dumps (reason ``atexit``) when
``root.common.flightrec.dump_on_exit`` is set, as the reference's does.
"""

import atexit
import faulthandler
import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque

log = logging.getLogger("flightrec")



class _LogTail(logging.Handler):
    """Root-logger handler appending compact records to a ring."""

    def __init__(self, ring):
        super(_LogTail, self).__init__(level=logging.INFO)
        self.ring = ring

    def emit(self, record):
        try:
            self.ring.append({
                "time": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
            })
        except Exception:  # a broken record must never break logging
            pass


class FlightRecorder:
    """Bounded event/log tail + crash hooks + bundle dumper."""

    def __init__(self, max_events=256, max_logs=256):
        self.max_events = int(max_events)
        self.log_ring = deque(maxlen=int(max_logs))
        self._lock = threading.Lock()
        self._installed = False
        self._handler = None
        self._dir = None
        self._prev_excepthook = None
        self._prev_signals = {}
        self._start = time.time()
        self.dumps = []

    # -- installation ------------------------------------------------------

    def _resolve_dir(self):
        return self._dir or "."

    def install(self, directory=None, signals=(signal.SIGUSR1,),
                excepthook=True, enable_faulthandler=True):
        """Idempotent; safe off the main thread (signal hooks are then
        skipped with a debug note — everything else still installs)."""
        with self._lock:
            if self._installed:
                return self
            self._installed = True
            self._dir = directory
            self._handler = _LogTail(self.log_ring)
            logging.getLogger().addHandler(self._handler)
            if enable_faulthandler and not faulthandler.is_enabled():
                faulthandler.enable()
            for sig in signals:
                try:
                    self._prev_signals[sig] = signal.signal(
                        sig, self._on_signal)
                except (ValueError, OSError) as e:
                    log.debug("cannot hook signal %s: %s", sig, e)
            if excepthook:
                self._prev_excepthook = sys.excepthook
                sys.excepthook = self._excepthook
            atexit.register(self._on_exit)
        return self

    def uninstall(self):
        with self._lock:
            if not self._installed:
                return
            self._installed = False
            if self._handler is not None:
                logging.getLogger().removeHandler(self._handler)
                self._handler = None
            for sig, prev in self._prev_signals.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._prev_signals = {}
            if self._prev_excepthook is not None:
                sys.excepthook = self._prev_excepthook
                self._prev_excepthook = None
            atexit.unregister(self._on_exit)

    # -- crash paths -------------------------------------------------------

    def _on_signal(self, signum, frame):
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        self.dump("signal:%s" % name)

    def _excepthook(self, exc_type, exc, tb):
        try:
            self.dump("exception:%s" % exc_type.__name__,
                      extra={"exception": "".join(
                          traceback.format_exception(exc_type, exc,
                                                     tb))[-4000:]})
        except Exception:
            pass
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _on_exit(self):
        try:
            from veles_tpu_torch.config import root
            if root.common.flightrec.get("dump_on_exit"):
                self.dump("atexit")
        except Exception:
            pass

    # -- the bundle --------------------------------------------------------

    def bundle(self, reason, extra=None):
        """The debug bundle as a plain dict.  Every section guards
        itself: a dump fired from a crash path must produce whatever it
        still can, never raise."""
        info = {"reason": reason, "time": time.time(),
                "pid": os.getpid(), "argv": list(sys.argv),
                "uptime_s": round(time.time() - self._start, 3)}
        if extra:
            info.update(extra)
        try:
            import platform
            info["platform"] = {"python": sys.version.split()[0],
                                "system": platform.platform()}
        except Exception:
            pass
        info["env"] = {k: v for k, v in os.environ.items()
                       if k.startswith(("VELES", "CUDA", "TORCH",
                                        "PYTORCH", "NCCL"))}
        # never initialize CUDA from a crash handler — describe the
        # card only when the process already did
        torch = sys.modules.get("torch")
        if torch is not None:
            try:
                info["torch"] = {"version": torch.__version__,
                                 "cuda": torch.version.cuda}
                if torch.cuda.is_initialized():
                    info["torch"]["devices"] = [
                        torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
            except Exception as e:
                info["torch"] = {"error": repr(e)}
        try:
            # the port's configuration: its health knobs (the reference
            # dumps its whole config tree)
            from veles_tpu_torch.telemetry.health import health_config
            info["config"] = {"health": health_config()}
        except Exception:
            pass
        try:
            from veles_tpu_torch.telemetry.health import monitor
            info["health"] = monitor.state()
        except Exception:
            pass
        try:
            from veles_tpu_torch.telemetry import metrics
            info["metrics"] = metrics.snapshot()
        except Exception:
            pass
        try:
            from veles_tpu_torch.telemetry import reqtrace
            info["requests"] = reqtrace.inflight_table()
        except Exception:
            pass
        try:
            # firing alerts from every live engine: the bundle says
            # what was already wrong before the crash or hang
            from veles_tpu_torch.telemetry import alerts
            info["alerts"] = alerts.firing_table()
        except Exception:
            pass
        try:
            # the last minutes of tier-0 history of the key serving
            # series from every live store: the lead-up to the hang
            from veles_tpu_torch.telemetry import tsdb
            info["history"] = tsdb.bundle_history()
        except Exception:
            pass
        try:
            from veles_tpu_torch.logger import events
            info["events"] = list(events.ring)[-self.max_events:]
        except Exception:
            pass
        info["logs"] = list(self.log_ring)
        try:
            names = {t.ident: t.name for t in threading.enumerate()}
            info["threads"] = {
                "%s-%d" % (names.get(tid, "?"), tid):
                    traceback.format_stack(frame)
                for tid, frame in sys._current_frames().items()}
        except Exception:
            pass
        return info

    def dump(self, reason="manual", extra=None):
        """Write the bundle to ``<dir>/flightrec-<pid>.json``; returns
        the path (None when even the write failed)."""
        try:
            directory = self._resolve_dir()
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, "flightrec-%d.json" % os.getpid())
            with open(path, "w") as f:
                json.dump(self.bundle(reason, extra=extra), f, default=str,
                          indent=1)
                f.write("\n")
        except Exception as e:
            try:
                log.error("flight-recorder dump failed: %s", e)
            except Exception:
                pass
            return None
        self.dumps.append(path)
        try:
            log.warning("flight-recorder bundle (%s) -> %s", reason, path)
        except Exception:
            pass
        return path

    def state(self):
        """Live-process view for ``GET /debug/state``."""
        from veles_tpu_torch.logger import events
        return {
            "installed": self._installed,
            "dir": self._resolve_dir() if self._installed else None,
            "dumps": list(self.dumps),
            "uptime_s": round(time.time() - self._start, 3),
            "events_buffered": len(events.ring),
            "logs_buffered": len(self.log_ring),
        }


#: process-wide recorder
recorder = FlightRecorder()
