"""veles-lint — AST hazard analysis, the port's own copy of
``veles_tpu/analysis`` retargeted at ``veles_tpu_torch``: it scans the
port by default, reads the scanned tree's ``config.py`` and the repo's
``docs/robustness.md``, and keeps its baseline in this package.

Over any tree the passes give the reference's findings, with one
exception: T204 (the serving entry points' ``track_jit``
registrations) asserts nothing over modules of ``veles_tpu_torch``,
which compiles no entry point (``passes/purity.py``).

The pass families, over pure ``ast`` (nothing here imports torch or
jax):

- **D-series** (``passes/donation.py``) — donated-buffer/host-view
  aliasing, the XLA:CPU heap-corruption family (ROUND6_NOTES.md);
- **T-series** (``passes/purity.py``) — side effects and tracer
  concretization inside jitted functions, untracked ``jax.jit``
  sites (subsumes the old tests/test_jit_guard.py);
- **L-series** (``passes/locks.py``) — unlocked shared writes and
  check-then-act races in the threaded modules;
- **C-series** (``passes/config_keys.py``) — every ``root.common.*``
  access must resolve to a key declared in ``config.py``; dead
  defaults are flagged too.

Run it::

    python -m veles_tpu_torch.analysis [--strict] [--format json] [paths...]

Accepted findings live in ``baseline.txt`` (see ``baseline.py`` for
the format — every entry carries a reason).  ``docs/static_analysis.md``
documents the tool for operators (written for the reference; the flags,
codes and exit codes are the same here).
"""

from veles_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE, apply_baseline, format_entry, load_baseline)
from veles_tpu_torch.analysis.core import (
    Finding, Module, Pass, Project, collect_modules, run_passes)
from veles_tpu_torch.analysis.passes import ALL_CODES, ALL_PASSES
from veles_tpu_torch.analysis.report import render_json, render_text

__all__ = [
    "ALL_CODES", "ALL_PASSES", "DEFAULT_BASELINE", "Finding",
    "Module", "Pass", "Project", "analyze", "apply_baseline",
    "collect_modules", "format_entry", "load_baseline", "render_json",
    "render_text", "run_passes",
]


def analyze(paths, root=None, baseline=None, passes=None):
    """One-call API: scan ``paths``, apply the baseline, and return
    ``(findings, fresh, stale, errors)`` where ``fresh`` are the
    unbaselined findings and ``stale`` the baseline keys matching
    nothing."""
    modules, errors = collect_modules(paths, root=root)
    findings, _ = run_passes(passes or ALL_PASSES, modules)
    entries = load_baseline(baseline) if baseline is not False \
        else {}
    fresh, stale = apply_baseline(findings, entries)
    return findings, fresh, stale, errors
