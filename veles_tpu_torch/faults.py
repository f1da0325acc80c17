"""Deterministic fault injection — the port's own copy of the JAX
package's ``veles_tpu/faults`` registry, which the serving scheduler's
lifecycle paths (deadlines, cancel, preemption, the watchdog) are
driven through in tests.

Named **injection points** are planted through the scheduler
(``serving.scheduler.loop``, ``.prefill``, ``.step``, ``.aux``) and the
REST server (``restful.generate``, on every client request route of
:mod:`veles_tpu_torch.restful_api`, where ``http_error`` answers the
injected status as a structured error); each
point is a no-op until a matching :class:`FaultSpec` is armed, at which
moment it deterministically misbehaves:

=============  =========================================================
action         behavior at the injection point
=============  =========================================================
``delay``      sleep ``arg`` seconds (default 0.05) — a slow step
``exception``  raise :class:`InjectedFault` — a crashing step
``hang``       sleep ``arg`` seconds (default 3600) — a stuck step the
               watchdog must detect; tests arm finite hangs so the
               victim recovers and cleanup can be asserted
``drop``       :func:`fire` returns True — the caller discards its unit
               of work
``http_error`` raise :class:`InjectedHTTPError` carrying status code
               ``arg`` (default 500)
``kill``       ``os._exit(17)`` — sudden process death
=============  =========================================================

Specs carry three modifiers: ``after=N`` skips the first N hits,
``times=M`` disarms after M firings, and ``key=PATTERN`` scopes the
spec to one caller.  Points and keys match with :mod:`fnmatch`
wildcards; a keyless :func:`fire` never matches a keyed spec.

Arming happens through :func:`inject`, :func:`load` (a spec string) or
the ``VELES_FAULTS`` environment variable (else
``root.common.faults.spec``), read once on the first :func:`fire`.  The variable is the reference registry's too, so this
one parses every action the reference knows.  Spec-string grammar, clauses separated by ``;``::

    point=action[:arg][@after][xtimes][~key]
    VELES_FAULTS="serving.scheduler.step=hang:1.5@3x1"

:func:`fire` is safe from any thread; an unarmed registry costs one
uncontended lock acquisition per call.
"""

import fnmatch
import os
import threading
import time

__all__ = ("InjectedFault", "InjectedHTTPError", "FaultSpec",
           "inject", "load", "clear", "active", "fire")

ACTIONS = ("delay", "exception", "hang", "drop", "http_error", "kill")


class InjectedFault(Exception):
    """Raised at an ``exception``-armed injection point."""


class InjectedHTTPError(InjectedFault):
    """Raised at an ``http_error``-armed point, carrying
    :attr:`status`."""

    def __init__(self, status=500):
        self.status = int(status)
        super(InjectedHTTPError, self).__init__(
            "injected HTTP %d" % self.status)


class FaultSpec:
    """One armed fault: where (``point``/``key`` patterns), what
    (``action`` + ``arg``), and when (``after``/``times``)."""

    __slots__ = ("point", "action", "arg", "after", "times", "key",
                 "hits", "fired")

    def __init__(self, point, action, arg=None, after=0, times=None,
                 key=None):
        if action not in ACTIONS:
            raise ValueError("unknown fault action %r (one of %s)"
                             % (action, ", ".join(ACTIONS)))
        self.point = str(point)
        self.action = action
        self.arg = arg
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.key = key
        self.hits = 0
        self.fired = 0

    def matches(self, point, key):
        if not fnmatch.fnmatchcase(point, self.point):
            return False
        if self.key is None:
            return True
        return key is not None and fnmatch.fnmatchcase(str(key),
                                                       self.key)

    def __repr__(self):
        return "<fault %s=%s arg=%r after=%d times=%r key=%r " \
            "fired=%d>" % (self.point, self.action, self.arg,
                           self.after, self.times, self.key,
                           self.fired)


_lock = threading.Lock()
_specs = []
_env_loaded = False


def _parse_clause(clause):
    """``point=action[:arg][@after][xtimes][~key]`` → FaultSpec."""
    point, sep, rest = clause.partition("=")
    if not sep or not point.strip():
        raise ValueError("fault clause %r is not point=action[...]"
                         % clause)
    rest, _, key = rest.partition("~")
    key = key.strip() or None
    times = None
    if "x" in rest:
        rest, _, t = rest.rpartition("x")
        times = int(t)
    after = 0
    if "@" in rest:
        rest, _, a = rest.rpartition("@")
        after = int(a)
    action, _, arg = rest.partition(":")
    return FaultSpec(point.strip(), action.strip(),
                     arg=float(arg) if arg else None,
                     after=after, times=times, key=key)


def _parse(spec):
    return [_parse_clause(c.strip()) for c in (spec or "").split(";")
            if c.strip()]


def load(spec):
    """Arm every ``;``-separated clause of a spec string (the
    ``VELES_FAULTS`` grammar); returns the armed specs."""
    armed = _parse(spec)
    with _lock:
        _specs.extend(armed)
    return armed


def _load_env_locked():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True  # latch FIRST: a bad spec must not re-raise per fire
    spec = os.environ.get("VELES_FAULTS", "")
    if not spec:
        # the tree's spec when the environment has none, as the
        # reference's registry reads it (``-c "root.common.faults.spec
        # = '...'"``)
        try:
            from veles_tpu_torch.config import root
            spec = root.common.faults.get("spec", "") or ""
        except Exception:
            spec = ""
    _specs.extend(_parse(spec))


def inject(point, action, arg=None, after=0, times=None, key=None):
    """Arm one fault programmatically; returns the spec handle."""
    spec = FaultSpec(point, action, arg=arg, after=after, times=times,
                     key=key)
    with _lock:
        _specs.append(spec)
    return spec


def clear(point=None):
    """Disarm everything (or only specs whose point pattern equals
    ``point``)."""
    with _lock:
        if point is None:
            del _specs[:]
        else:
            _specs[:] = [s for s in _specs if s.point != point]


def active():
    """Snapshot of armed specs."""
    with _lock:
        _load_env_locked()
        return list(_specs)


def fire(point, key=None):
    """The injection point: call at a hazard site; returns True when
    an armed ``drop`` spec says to discard this unit of work.  May
    sleep (``delay``/``hang``), raise :class:`InjectedFault`
    (``exception``, ``http_error``) or end the process (``kill``)."""
    with _lock:
        _load_env_locked()
        if not _specs:
            return False
        due = []
        for s in _specs:
            if not s.matches(point, key):
                continue
            s.hits += 1
            if s.hits <= s.after:
                continue
            if s.times is not None and s.fired >= s.times:
                continue
            s.fired += 1
            due.append(s)
    drop = False
    for s in due:  # sleeps/raises happen OUTSIDE the registry lock
        if s.action == "delay":
            time.sleep(float(s.arg if s.arg is not None else 0.05))
        elif s.action == "hang":
            time.sleep(float(s.arg if s.arg is not None else 3600.0))
        elif s.action == "exception":
            raise InjectedFault("injected fault at %s" % point)
        elif s.action == "http_error":
            raise InjectedHTTPError(int(s.arg) if s.arg else 500)
        elif s.action == "drop":
            drop = True
        elif s.action == "kill":
            os._exit(17)
    return drop
