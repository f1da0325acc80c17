"""Accepted-findings baseline.

A finding the team has looked at and deliberately accepts lives in
``baseline.txt`` next to this module, one per line::

    CODE path::context::detail  -- reason the pattern is deliberate

The key carries no line numbers, so unrelated edits don't churn the
file; the ``--`` separated reason is REQUIRED — a baseline entry
without a why is just a suppressed bug.  ``--strict`` additionally
fails on *stale* entries (keys matching no current finding): a stale
entry means the exception it documented is gone, and keeping it could
mask a future regression at the same site (the old
test_jit_guard.py allowlist-pruning rule, generalized).
"""

from pathlib import Path

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.txt"


class BaselineError(ValueError):
    pass


def load_baseline(path=None):
    """{key: reason} from a baseline file (missing file = empty)."""
    path = Path(path) if path else DEFAULT_BASELINE
    entries = {}
    if not path.is_file():
        return entries
    for n, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "--" not in line:
            raise BaselineError(
                "%s:%d: baseline entry without a `-- reason`: %r"
                % (path, n, raw))
        key, reason = line.split("--", 1)
        key = " ".join(key.split())
        reason = reason.strip()
        if not reason:
            raise BaselineError(
                "%s:%d: empty reason for %r" % (path, n, key))
        entries[key] = reason
    return entries


def apply_baseline(findings, entries):
    """Mark baselined findings in place; returns (unbaselined
    findings, stale keys)."""
    used = set()
    for f in findings:
        reason = entries.get(f.key)
        if reason is not None:
            f.baselined = True
            f.reason = reason
            used.add(f.key)
    stale = sorted(set(entries) - used)
    fresh = [f for f in findings if not f.baselined]
    return fresh, stale


def format_entry(finding, reason="TODO: why is this deliberate?"):
    """The line to paste into baseline.txt for ``finding``."""
    return "%s  -- %s" % (finding.key, reason)
