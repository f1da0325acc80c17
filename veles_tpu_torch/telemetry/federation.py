"""Fleet metrics federation — merge N replica scrapes into one view;
the port's own copy of ``veles_tpu/telemetry/federation.py``.

Every serving replica already exports the process-wide registry as
Prometheus text at ``GET /metrics``, but a fleet of N replicas means
N scrapes an operator has to diff by hand.  This module is the rollup
tier (the Prometheus-federation analogue, in-process): the router's
health-poll task stores each replica's latest ``/metrics`` text, and
``GET /metrics/fleet`` serves the merge —

- **counters** sum across replicas per label set (cumulative bucket
  counts of histograms sum the same way, so ``_bucket``/``_sum``/
  ``_count`` merge without un-cumulating);
- **gauges** are instantaneous per-process facts (queue depth, KV
  blocks free) — summing them would lie, so every gauge series is
  re-labeled with ``replica="<id>"`` and kept per replica;
- ``veles_fleet_*`` rollup families ride along: replica/scrape
  counts and a per-replica ``up`` gauge, so "how many replicas did
  this merge actually see" is part of the scrape itself.

Scrape payloads are either raw exposition text (the wire path,
:func:`parse_prometheus`) or the structured family list
:meth:`~veles_tpu_torch.telemetry.registry.MetricsRegistry.collect_families`
returns (the in-process path — dashboard and alert consumers never
round-trip through text).
"""

import re

from veles_tpu_torch.telemetry.registry import render_families_text

__all__ = ("parse_prometheus", "merge_scrapes", "fleet_families",
           "render_families_text")

#: one exposition sample: name, optional {labels}, value
_SAMPLE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)\s*(?:\{(.*)\})?\s+(\S+)$')
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SUFFIXES = ("_bucket", "_sum", "_count")


def _unescape(v):
    return v.replace("\\n", "\n").replace('\\"', '"') \
        .replace("\\\\", "\\")


def _parse_value(raw):
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


def parse_prometheus(text):
    """Parse exposition text v0.0.4 into the structured family list
    (same shape as ``MetricsRegistry.collect_families()``).  Unknown
    lines are skipped — a scrape is operator input, not a trusted
    peer, and a malformed line must cost one family at most."""
    families = {}   # name -> family dict
    types = {}      # name -> type
    helps = {}

    def family(name):
        fam = families.get(name)
        if fam is None:
            fam = families[name] = {
                "name": name, "type": types.get(name, "untyped"),
                "help": helps.get(name, ""), "samples": []}
        return fam

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 \
                    else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE.match(line)
        if m is None:
            continue
        name, labelblob, raw = m.groups()
        try:
            value = _parse_value(raw)
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL.findall(labelblob or "")}
        base, suffix = name, ""
        for s in _SUFFIXES:
            if name.endswith(s) and types.get(name[:-len(s)]) \
                    in ("histogram", "summary"):
                base, suffix = name[:-len(s)], s
                break
        family(base)["samples"].append((suffix, labels, value))
    return sorted(families.values(), key=lambda f: f["name"])


def _labels_key(labels):
    return tuple(sorted(labels.items()))


def merge_scrapes(scrapes):
    """Merge per-replica scrapes into one family list.

    ``scrapes`` is ``[(replica_id, families), ...]`` where each
    ``families`` is a parsed/collected family list.  Counter and
    histogram samples SUM across replicas per label set (cumulative
    bucket counts sum to cumulative counts, so histogram merge needs
    no un-cumulating); gauge samples are per-process facts and are
    kept per replica, re-labeled with ``replica="<id>"``."""
    merged = {}     # name -> {"type","help","samples": {key: [s,labels,v]}}
    for replica, families in scrapes:
        for fam in families:
            name = fam["name"]
            rec = merged.get(name)
            if rec is None:
                rec = merged[name] = {"type": fam["type"],
                                      "help": fam.get("help", ""),
                                      "samples": {}}
            summing = rec["type"] in ("counter", "histogram")
            for suffix, labels, value in fam["samples"]:
                labels = dict(labels)
                if not summing:
                    # re-label by scrape origin; a gauge already
                    # carrying a finer replica label keeps it
                    labels.setdefault("replica", str(replica))
                key = (suffix, _labels_key(labels))
                slot = rec["samples"].get(key)
                if slot is None:
                    rec["samples"][key] = [suffix, labels, value]
                elif summing:
                    slot[2] += value
                else:   # duplicate gauge series from one replica:
                    slot[2] = value       # last write wins, like prom
    def _sample_key(kv):
        suffix, labels_key = kv[0]
        ordered = []
        for k, v in labels_key:
            if k == "le":   # buckets sort numerically, +Inf last
                try:
                    v = (float("inf"), "") if v == "+Inf" \
                        else (float(v), "")
                except ValueError:
                    v = (float("inf"), v)
            else:
                v = (0.0, v)
            ordered.append((k, v))
        return (suffix, ordered)

    out = []
    for name in sorted(merged):
        rec = merged[name]
        samples = [tuple(s) for _, s in sorted(
            rec["samples"].items(), key=_sample_key)]
        out.append({"name": name, "type": rec["type"],
                    "help": rec["help"], "samples": samples})
    return out


def fleet_families(scrapes, errors=()):
    """The full ``GET /metrics/fleet`` payload: the merged replica
    families plus the ``veles_fleet_*`` rollups.  ``errors`` names
    the replicas whose scrape failed this cycle (they export
    ``up=0`` and count into ``veles_fleet_scrape_errors``)."""
    families = merge_scrapes(scrapes)
    up = [("", {"replica": str(r)}, 1.0) for r, _ in scrapes]
    up += [("", {"replica": str(r)}, 0.0) for r in errors]
    rollups = [
        {"name": "veles_fleet_replicas", "type": "gauge",
         "help": "replicas merged into this fleet scrape",
         "samples": [("", {}, float(len(scrapes)))]},
        {"name": "veles_fleet_scrape_errors", "type": "gauge",
         "help": "replicas whose /metrics scrape failed this cycle",
         "samples": [("", {}, float(len(errors)))]},
        {"name": "veles_fleet_up", "type": "gauge",
         "help": "1 per replica whose scrape merged, 0 when its "
                 "last scrape failed",
         "samples": sorted(up, key=lambda s: s[1]["replica"])},
    ]
    return sorted(families + rollups, key=lambda f: f["name"])
