"""``python -m sparkdl_tpu_torch.observe.trend``: the perf ledger's
trend viewer.

Counterpart of ``sparkdl_tpu/observe/trend.py``: a ledger
(:func:`~sparkdl_tpu_torch.observe.perf.read_history`) as one
trajectory table a metric, each record's git sha, p50 / p99 (or value)
and its direction-aware delta against the metric's previous record, with
the baselines the caller names (``--baseline``) beside it. The ledger is
``--history`` or ``perf.HISTORY_PATH``; the baselines come only from the
paths given: the JAX module defaults to its repo's ``BASELINE.json`` and
``benchmarks/results/serve_baseline.json``, which hold TPU figures.
``--format json`` is the machine contract. Artifact-only.
"""

import argparse
import json
import os
import sys

from sparkdl_tpu_torch.observe.compare import _higher_is_better
from sparkdl_tpu_torch.observe.perf import default_history_path, read_history

TREND_SCHEMA = "sparkdl_tpu.observe.trend/1"


def load_baselines(paths):
    """``{metric: {"value": v, "source": basename}}`` from committed
    baseline docs. Two committed shapes exist: ``BASELINE.json``'s
    ``published`` map (private ``_``-prefixed and non-numeric entries
    skipped) and ``serve_baseline.json``'s history-record shape (a
    ``metrics`` map of name → ``{"value": ...}`` — the ledger line
    that was promoted to baseline). Missing/unreadable files are
    silently absent — baselines decorate the trajectory, they don't
    gate it."""
    out = {}
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict):
            continue
        flat = {}
        for name, v in (doc.get("published") or {}).items():
            if not name.startswith("_"):
                flat[name] = v
        for name, m in (doc.get("metrics") or {}).items():
            flat[name] = m.get("value") if isinstance(m, dict) else m
        for name, v in flat.items():
            if not isinstance(v, (int, float)):
                continue
            out.setdefault(name, {
                "value": float(v),
                "source": os.path.basename(path),
            })
    return out


def build_trend(entries, baselines=None, only=None, last=None):
    """The trend document: per-metric rows (oldest first), each row
    carrying ts/git_sha/bench/value/p50/p99/unit and
    ``delta_vs_prev`` (relative, direction-adjusted so positive =
    improvement), plus the committed baseline when one names the
    metric."""
    by_metric = {}
    for idx, entry in enumerate(entries):
        for name, m in (entry.get("metrics") or {}).items():
            if only and not any(s in name for s in only):
                continue
            if not isinstance(m, dict):
                m = {"value": m}
            value = m.get("value")
            if not isinstance(value, (int, float)):
                continue
            by_metric.setdefault(name, []).append({
                "index": idx,
                "ts": entry.get("ts"),
                "git_sha": entry.get("git_sha"),
                "bench": entry.get("bench"),
                "host": entry.get("host"),
                "device_kind": entry.get("device_kind"),
                "value": float(value),
                "p50": m.get("p50"),
                "p99": m.get("p99"),
                "unit": m.get("unit"),
                "higher_is_better": m.get("higher_is_better"),
            })
    metrics = {}
    baselines = baselines or {}
    for name in sorted(by_metric):
        rows = by_metric[name]
        if last:
            rows = rows[-last:]
        hib = _higher_is_better(
            name, next((r["higher_is_better"] for r in rows
                        if r["higher_is_better"] is not None), None))
        prev = None
        for row in rows:
            if prev not in (None, 0):
                delta = (row["value"] - prev) / abs(prev)
                row["delta_vs_prev"] = delta if hib else -delta
            else:
                row["delta_vs_prev"] = None
            prev = row["value"]
        entry = {"higher_is_better": hib, "records": rows}
        if name in baselines:
            entry["baseline"] = baselines[name]
            newest = rows[-1]["value"]
            base = baselines[name]["value"]
            if base:
                d = (newest - base) / abs(base)
                entry["newest_vs_baseline"] = d if hib else -d
        metrics[name] = entry
    return {"schema": TREND_SCHEMA, "metrics": metrics,
            "records_total": len(entries)}


def _fmt_delta(d):
    if d is None:
        return "      -"
    return f"{d * 100:+6.1f}%"


def render_text(trend):
    lines = []
    if not trend["metrics"]:
        lines.append("trend: no ledger records"
                     + (f" (of {trend['records_total']} entries, none "
                        "matched)" if trend["records_total"] else ""))
        return "\n".join(lines)
    for name, entry in trend["metrics"].items():
        direction = ("higher is better" if entry["higher_is_better"]
                     else "lower is better")
        unit = next((r["unit"] for r in entry["records"]
                     if r.get("unit")), None)
        lines.append(f"{name} ({direction}"
                     + (f", {unit}" if unit else "") + ")")
        lines.append(f"  {'ts':<20} {'git sha':<10} {'value':>14} "
                     f"{'p50':>12} {'p99':>12} {'vs prev':>8}")
        for r in entry["records"]:
            lines.append(
                f"  {str(r.get('ts') or '-'):<20} "
                f"{str(r.get('git_sha') or '-'):<10} "
                f"{r['value']:>14.4g} "
                f"{(('%12.4g' % r['p50']) if isinstance(r.get('p50'), (int, float)) else '           -')} "
                f"{(('%12.4g' % r['p99']) if isinstance(r.get('p99'), (int, float)) else '           -')} "
                f"{_fmt_delta(r.get('delta_vs_prev'))}")
        base = entry.get("baseline")
        if base:
            line = (f"  committed baseline [{base['source']}]: "
                    f"{base['value']:.4g}")
            nvb = entry.get("newest_vs_baseline")
            if nvb is not None:
                line += f" (newest {_fmt_delta(nvb).strip()} vs it)"
            lines.append(line)
        lines.append("")
    return "\n".join(lines).rstrip()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.observe.trend",
        description="Render the perf ledger (history.jsonl) as "
                    "per-metric trajectory tables with deltas and "
                    "committed baselines.",
    )
    parser.add_argument("--history", default=None,
                        help="ledger path (default: perf.HISTORY_PATH)")
    parser.add_argument("--baseline", action="append", default=None,
                        help="baseline JSON to render beside the "
                        "trajectory (repeatable; default: none)")
    parser.add_argument("--metric", action="append", default=None,
                        help="restrict to metrics containing this "
                        "substring (repeatable; e.g. --metric serve "
                        "matches every serving series)")
    parser.add_argument("--last", type=int, default=None,
                        help="only the newest N records per metric")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    args = parser.parse_args(argv)

    history_path = args.history or default_history_path()
    entries = read_history(history_path)
    baselines = load_baselines(args.baseline or ())
    trend = build_trend(
        entries, baselines=baselines,
        only=set(args.metric) if args.metric else None,
        last=args.last)
    trend["history_path"] = history_path
    if args.format == "json":
        print(json.dumps(trend, indent=2, sort_keys=True))
    else:
        print(render_text(trend))
    # 2 = nothing to show (CI treats an empty trend as a wiring bug).
    return 0 if trend["metrics"] else 2


if __name__ == "__main__":
    sys.exit(main())
