"""CLI runner: ``python -m veles_tpu_torch.analysis [options] [paths...]``.

Exit codes: 0 clean (every finding fixed or baselined), 1 unbaselined
findings (or, under ``--strict``, stale baseline entries / parse
errors), 2 usage errors.  Default scan target is the ``veles_tpu_torch``
package itself; the default baseline is ``analysis/baseline.txt``.
"""

import argparse
import sys
import time
from pathlib import Path

from veles_tpu_torch.analysis import (
    ALL_CODES, ALL_PASSES, DEFAULT_BASELINE, analyze, format_entry,
    render_json, render_text)

PKG_ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.analysis",
        description="veles-lint: AST hazard analysis (donation "
                    "aliasing, jit purity, lock discipline, config "
                    "keys)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to scan (default: the "
                         "veles_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries and "
                         "file parse errors (the tier-1 gate mode)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="baseline file (default: %s)"
                         % DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baselined or not")
    ap.add_argument("--emit-baseline", action="store_true",
                    help="print ready-to-paste baseline lines for "
                         "the unbaselined findings and exit 0")
    ap.add_argument("--codes", default=None, metavar="PREFIXES",
                    help="comma-separated code/prefix filter "
                         "(e.g. 'L,T203')")
    ap.add_argument("--list-codes", action="store_true")
    args = ap.parse_args(argv)

    if args.list_codes:
        for code in sorted(ALL_CODES):
            print("%s  %s" % (code, ALL_CODES[code]))
        return 0

    paths = args.paths or [str(PKG_ROOT)]
    t0 = time.perf_counter()
    findings, fresh, stale, errors = analyze(
        paths, root=PKG_ROOT.parent,
        baseline=False if args.no_baseline else args.baseline)
    if args.codes:
        prefixes = tuple(p.strip() for p in args.codes.split(",")
                         if p.strip())
        findings = [f for f in findings
                    if f.code.startswith(prefixes)]
        fresh = [f for f in fresh if f.code.startswith(prefixes)]

    if args.emit_baseline:
        for f in fresh:
            print(format_entry(f))
        return 0

    if args.format == "json":
        print(render_json(findings, stale=stale, errors=errors))
    else:
        print(render_text(findings, stale=stale,
                          show_baselined=args.no_baseline))
        for path, err in errors:
            print("parse error: %s: %s" % (path, err),
                  file=sys.stderr)
        print("scanned in %.2fs" % (time.perf_counter() - t0),
              file=sys.stderr)

    if fresh:
        return 1
    if args.strict and (stale or errors):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
