"""Text and JSON reporters for veles-lint findings."""

import json


def render_text(findings, stale=(), show_baselined=False):
    lines = []
    fresh = [f for f in findings if not f.baselined]
    for f in fresh:
        lines.append(str(f))
    if show_baselined:
        for f in findings:
            if f.baselined:
                lines.append(str(f))
    if stale:
        lines.append("")
        lines.append("stale baseline entries (match no finding — "
                     "prune them):")
        for key in stale:
            lines.append("  " + key)
    by_code = {}
    for f in fresh:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    summary = ", ".join("%s: %d" % kv for kv in sorted(by_code.items()))
    n_base = sum(1 for f in findings if f.baselined)
    lines.append("")
    lines.append("%d finding(s) (%s)%s%s" % (
        len(fresh), summary or "clean",
        ", %d baselined" % n_base if n_base else "",
        ", %d stale baseline entr(ies)" % len(stale) if stale else ""))
    return "\n".join(lines)


def render_json(findings, stale=(), errors=()):
    return json.dumps({
        "findings": [f.as_dict() for f in findings],
        "unbaselined": sum(1 for f in findings if not f.baselined),
        "baselined": sum(1 for f in findings if f.baselined),
        "stale_baseline": list(stale),
        "parse_errors": [{"path": p, "error": e} for p, e in errors],
    }, indent=2, sort_keys=True)
