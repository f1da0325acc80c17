"""Per-tenant admission economics at the router edge — the port's own
copy of ``veles_tpu/tenant/admission.py``.

A fleet that serves more than one client needs a *tenant* notion
before any fairness story can exist: one flooding client must not be
able to starve everyone behind the shared queue.  This module gives
the router three layers, each independently cheap:

- **identity** — :func:`resolve_tenant` derives a stable tenant id
  from the request: an explicit ``X-Veles-Tenant`` header when the
  peer is loopback (the trusted-proxy / test shape), else a short
  hash of the ``Authorization: Bearer`` token (the credential IS the
  tenant; the raw secret never appears in logs or labels), else
  ``"anon"``.
- **tagging** — :meth:`TenantAdmission.tag` maps the raw id onto a
  cardinality-bounded metrics label (the first
  ``root.common.tenant.label_cardinality`` distinct tenants keep
  their own label, later arrivals share ``"other"``) and injects it
  as the forwarded ``X-Veles-Tenant`` header, so router metrics,
  trace spans and replica-side queue spans all agree on one value.
  Tagging is ALWAYS on — observability precedes enforcement.
- **enforcement** (``root.common.tenant.enabled``, default off) — a
  per-tenant token bucket (``rate`` tokens/sec, ``burst`` capacity;
  an over-rate submit is a structured 429 + ``Retry-After``) and a
  weighted-fair concurrency lane: at most ``max_concurrent``
  requests of one tenant proxy at once, later ones WAIT on their own
  tenant's asyncio semaphore (equal weights — fairness by equal
  concurrency shares) while other tenants' traffic flows untouched.

Buckets and lanes are keyed by the RAW tenant id — a flooder that
falls into the ``"other"`` label bucket still gets its own private
rate limit, so label-cardinality bounding never lets tenants share
(or exhaust) each other's budgets.  The bucket map is LRU-capped so
an id-spraying client cannot grow router memory without bound.
"""

import asyncio
import hashlib
import re
import threading
import time

from veles_tpu_torch.logger import events
from veles_tpu_torch.telemetry import metrics

__all__ = ("resolve_tenant", "TenantAdmission")


def _tenant_conf(name, default):
    from veles_tpu_torch.config import root
    return root.common.tenant.get(name, default)


#: characters allowed through from an explicit X-Veles-Tenant header
#: (everything else flattens to "_" — the id becomes a label value)
_UNSAFE = re.compile(r"[^A-Za-z0-9._-]")

#: explicit tenant ids are clipped — a label value, not a payload
_MAX_ID = 32

#: token-bucket map cap: beyond this many distinct raw ids the
#: stalest bucket is evicted (an evicted flooder re-enters with a
#: FULL bucket, which only helps it once per eviction)
_MAX_BUCKETS = 1024


def resolve_tenant(headers, loopback=False):
    """The request's raw tenant id from its (lowercase-keyed)
    headers: an explicit ``X-Veles-Tenant`` when the peer is trusted
    (loopback — the router itself forwards the resolved label this
    way), else ``t-<8 hex>`` from the bearer token's SHA-256 (the
    credential identifies the tenant; the secret never leaves the
    hash), else ``"anon"``."""
    if loopback:
        explicit = headers.get("x-veles-tenant")
        if explicit:
            return _UNSAFE.sub("_", str(explicit))[:_MAX_ID]
    auth = headers.get("authorization", "")
    if auth[:7].lower() == "bearer " and auth[7:].strip():
        digest = hashlib.sha256(auth[7:].strip().encode()).hexdigest()
        return "t-%s" % digest[:8]
    return "anon"


def _throttled_series():
    return metrics.counter(
        "veles_router_tenant_throttled_total",
        "requests answered 429 at the tenant admission lane (token "
        "bucket over rate, or the tenant's concurrency lane never "
        "freed a seat), by bounded tenant label — the "
        "tenant_throttled alert rule watches its rate",
        labelnames=("tenant",))


class TenantAdmission:
    """Router-edge tenant tagging + (optionally) enforcement.

    Thread-safe for the sync surface (``tag``/``throttle``/label
    bookkeeping); :meth:`acquire`/:meth:`release` touch asyncio
    primitives and belong on the router's event loop."""

    def __init__(self):
        self._lock = threading.Lock()
        self._labels = {}     # raw id -> bounded label (stable)
        self._buckets = {}    # raw id -> [tokens, last_refill]
        self._lanes = {}      # raw id -> asyncio.Semaphore (loop only)
        self.throttled = 0
        self._global = _throttled_series()

    # -- config (read live so tests/operators can flip knobs) -----------

    @property
    def enabled(self):
        return bool(_tenant_conf("enabled", False))

    @property
    def rate(self):
        return float(_tenant_conf("rate", 0.0))

    @property
    def burst(self):
        return float(_tenant_conf("burst", 0.0))

    @property
    def max_concurrent(self):
        return int(_tenant_conf("max_concurrent", 0))

    @property
    def label_cardinality(self):
        return int(_tenant_conf("label_cardinality", 8))

    # -- identity + label -------------------------------------------------

    def label(self, tenant):
        """The bounded metrics label for a raw id: first-N distinct
        tenants keep their own (stable across the process — no top-N
        churn re-labeling a tenant mid-flight), the rest share
        ``"other"``."""
        tenant = str(tenant)
        with self._lock:
            lbl = self._labels.get(tenant)
            if lbl is None:
                lbl = tenant if len(self._labels) \
                    < self.label_cardinality else "other"
                self._labels[tenant] = lbl
            return lbl

    def tag(self, headers, loopback=False):
        """Resolve the raw tenant id and inject its bounded label as
        the forwarded ``x-veles-tenant`` header (replica spans and
        metrics then agree with the router's).  Returns the RAW id —
        the key buckets and lanes use."""
        raw = resolve_tenant(headers, loopback=loopback)
        headers["x-veles-tenant"] = self.label(raw)
        return raw

    # -- token bucket -----------------------------------------------------

    def throttle(self, tenant, now=None):
        """One admission through the tenant's token bucket: None to
        admit, else the ``Retry-After`` seconds for a structured 429
        (already counted in the throttle metric).  Disabled (or
        rate <= 0) admits everything."""
        if not self.enabled:
            return None
        rate = self.rate
        if rate <= 0:
            return None
        cap = max(1.0, self.burst or rate)
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= _MAX_BUCKETS:
                    stale = min(self._buckets,
                                key=lambda t: self._buckets[t][1])
                    del self._buckets[stale]
                bucket = self._buckets[tenant] = [cap, now]
            tokens, last = bucket
            tokens = min(cap, tokens + (now - last) * rate)
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                bucket[1] = now
                return None
            bucket[0] = tokens
            bucket[1] = now
        self.record_throttled(tenant)
        return (1.0 - tokens) / rate

    # -- weighted-fair concurrency lane (router loop only) ----------------

    def _lane(self, tenant):
        sem = self._lanes.get(tenant)
        if sem is None:
            sem = self._lanes[tenant] = asyncio.Semaphore(
                self.max_concurrent)
        return sem

    async def acquire(self, tenant, timeout):
        """Take one of the tenant's concurrency seats, waiting (in
        the tenant's OWN queue — other tenants never wait here) up to
        ``timeout``.  Returns ``"seat"`` when a seat was taken
        (:meth:`release` is then owed), ``"free"`` when the lane is
        not enforcing, or None (counted as throttled) when the lane
        stayed full."""
        if not self.enabled or self.max_concurrent <= 0:
            return "free"
        try:
            await asyncio.wait_for(self._lane(tenant).acquire(),
                                   timeout)
            return "seat"
        except asyncio.TimeoutError:
            self.record_throttled(tenant)
            return None

    def release(self, tenant):
        sem = self._lanes.get(tenant)
        if sem is not None:
            sem.release()

    # -- accounting -------------------------------------------------------

    def record_throttled(self, tenant):
        lbl = self.label(tenant)
        with self._lock:
            self.throttled += 1
        self._global.labels(tenant=lbl).inc()
        events.record("tenant.throttled", "single",
                      cls="TenantAdmission", tenant=lbl)

    def snapshot(self):
        with self._lock:
            return {"enabled": self.enabled,
                    "tenants_seen": len(self._labels),
                    "throttled": self.throttled}
