"""The event sink and the logging mixin — the port of
``veles_tpu/logger.py``: :class:`EventSink` and its process-wide
:data:`events`, and :class:`Logger`, which every workflow object mixes
in for ``self.info/debug/...`` under a class-named logger and for
``event()``/``timed_event()`` spans into :data:`events`.

Events go to a bounded in-memory ring and, when a path is opened, to a
JSONL file, one object per line with the JAX package's keys (``name``,
``kind``, ``time``, ``pid``, ``tid`` and the event's attributes), so
the JAX package's ``telemetry.trace_export`` reads the port's log as
it reads its own.
"""

import json
import logging
import os
import threading
import time
from collections import deque


class EventSink:
    """Process-wide event recorder: a bounded ring, plus a JSONL file
    once :meth:`open` is called."""

    def __init__(self, maxlen=65536):
        self.ring = deque(maxlen=maxlen)
        self.path = None
        self._lock = threading.Lock()
        self._file = None
        self._warned = False

    def open(self, path):
        """Append events to ``path`` from now on (the new file is opened
        first, so a failure leaves the previous sink as it was)."""
        f = open(path, "a")
        with self._lock:
            if self._file:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = f
            self.path = path
            self._warned = False

    def close(self):
        with self._lock:
            if self._file:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def record(self, name, kind, **attrs):
        """Record one event; returns its dict.  A file that fails to
        write is dropped (once, with a warning) and the ring records on:
        a hot path never raises for its log."""
        ev = {"name": name, "kind": kind, "time": time.time(),
              "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF,
              **attrs}
        with self._lock:
            self.ring.append(ev)
            if self._file:
                try:
                    self._file.write(json.dumps(ev, default=str) + "\n")
                    self._file.flush()
                except (OSError, ValueError):
                    try:
                        self._file.close()
                    except Exception:
                        pass
                    self._file = None
                    if not self._warned:
                        self._warned = True
                        logging.getLogger("EventSink").warning(
                            "event file sink %s failed — file recording "
                            "disabled (in-memory ring still active)",
                            self.path)
        return ev


#: the process-wide sink
events = EventSink()


class Logger:
    """Mixin granting named logging and event spans to any class."""

    def __init__(self, **kwargs):
        super().__init__()

    @property
    def logger(self):
        lg = getattr(self, "_logger_", None)
        if lg is None:
            lg = logging.getLogger(type(self).__name__)
            self._logger_ = lg
        return lg

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def exception(self, msg="", *args):
        self.logger.exception(msg, *args)

    def event(self, name, kind="single", **attrs):
        """Record an event: ``kind`` is "begin", "end" or "single"."""
        return events.record(name, kind, cls=type(self).__name__, **attrs)

    def timed_event(self, name):
        """Context manager emitting begin/end events around a block."""
        return _TimedEvent(self, name)


class _TimedEvent:
    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.owner.event(self.name, "begin")
        return self

    def __exit__(self, *exc):
        self.owner.event(self.name, "end")
        return False

