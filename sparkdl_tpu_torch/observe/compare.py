"""``python -m sparkdl_tpu_torch.observe.compare BASE CAND``: the
noise-aware perf comparison and its regression gate.

Counterpart of ``sparkdl_tpu/observe/compare.py``, the same code: it
exits 1 when the candidate regressed, 2 when nothing was comparable.
Either side is a path: a bench JSON document (``{"metric", "value"}``),
a baseline document (its ``published`` map), a history ledger
(:func:`~sparkdl_tpu_torch.observe.perf.history_record` lines; the
newest entry, or ``ledger.jsonl@IDX``), or a telemetry run dir (each
rank's ``train_step_per_second`` gauge and mean execute-phase
``train_step_seconds``). Nothing is read that the caller does not name.

A metric with rep ``samples`` is compared by its samples' medians, and
regresses only past ``max(--floor, --iqr-k x rel-IQR)``; lower-is-better
metrics (``*_seconds``, ``*_ms``, latency shapes) invert. Records of two
hosts make a regression advisory (exit 0) unless ``--strict-host``.
``--format json`` is the machine contract (``decision`` and
``exit_code``). ``--explain`` adds, between two run dirs whose verdict is
not ``ok``, the per-rank
:func:`~sparkdl_tpu_torch.observe.perf.diff_attribution`, the core the
alert-triggered forensics report uses.
"""

import argparse
import json
import os
import sys


def _quantile(samples, p):
    xs = sorted(float(s) for s in samples)
    i = p * (len(xs) - 1)
    lo = int(i)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (i - lo)


def _rel_iqr(samples):
    if not samples or len(samples) < 4:
        return 0.0
    med = _quantile(samples, 0.5)
    if med == 0:
        return 0.0
    return abs((_quantile(samples, 0.75) - _quantile(samples, 0.25))
               / med)


def _effective_value(m):
    """The number a side is compared BY: the median of its rep
    samples when it has enough of them, else the raw value. A bench's
    headline ``value`` is often one timed invocation — on a shared
    CPU two back-to-back runs of identical code differ by >10% on
    that number while their medians agree to <1%, so the gate
    compares the robust center the IQR threshold already describes.
    """
    samples = m.get("samples")
    if isinstance(samples, (list, tuple)) and len(samples) >= 3:
        return _quantile(samples, 0.5), f"median[{len(samples)}]"
    return m["value"], "value"


_LOWER_IS_BETTER_HINTS = ("_seconds", "_ms", "latency", "ttft",
                          "_wait", "_s_mean")


def _higher_is_better(name, explicit=None):
    if explicit is not None:
        return bool(explicit)
    n = name.lower()
    return not any(h in n for h in _LOWER_IS_BETTER_HINTS)


# -- record loading ----------------------------------------------------------


def _from_bench_json(doc):
    metrics = {}
    if not isinstance(doc, dict):
        return {"kind": "bench", "host": None, "metrics": metrics}
    name = doc.get("metric")
    if name and isinstance(doc.get("value"), (int, float)):
        metrics[name] = {
            "value": float(doc["value"]),
            "unit": doc.get("unit"),
            "samples": doc.get("rate_samples") or doc.get("samples"),
        }
    # steps_per_sec_p50/p99 are NOT extracted as their own metrics:
    # they are the same throughput the headline value + rate_samples
    # already compare (scaled by batch*seq), but as bare numbers they
    # would bypass the median/IQR protection and make the gate flaky
    # on a noisy runner.
    return {"kind": "bench", "host": doc.get("host"), "metrics": metrics}


def _from_baseline(doc):
    metrics = {}
    for name, v in (doc.get("published") or {}).items():
        if name.startswith("_") or not isinstance(v, (int, float)):
            continue
        metrics[name] = {"value": float(v)}
    # the committed baseline records WHO measured it so the gate
    # enforces on that machine and degrades to advisory anywhere else
    return {"kind": "baseline", "host": doc.get("host_fingerprint"),
            "metrics": metrics}


def _from_history_entry(entry):
    metrics = {}
    for name, m in (entry.get("metrics") or {}).items():
        if not isinstance(m, dict):
            m = {"value": m}
        if isinstance(m.get("value"), (int, float)):
            metrics[name] = dict(m)
    return {
        "kind": "history",
        "host": entry.get("host"),
        "git_sha": entry.get("git_sha"),
        "ts": entry.get("ts"),
        "metrics": metrics,
    }


def _from_run_dir(path):
    try:
        with open(os.path.join(path, "metrics.json")) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(
            f"compare: {path} has no readable metrics.json ({e})")
    metrics = {}
    for series in doc.get("series", ()):
        rank = series.get("labels", {}).get("rank")
        if rank is None or rank == "driver":
            continue
        for g in series.get("gauges", ()):
            if g.get("name") == "train_step_per_second" and isinstance(
                    g.get("value"), (int, float)):
                metrics[f"train_step_per_second[rank={rank}]"] = {
                    "value": float(g["value"])}
        for h in series.get("histograms", ()):
            if (h.get("name") == "train_step_seconds"
                    and h.get("labels", {}).get("phase") == "execute"
                    and h.get("count")):
                metrics[f"train_step_seconds_mean[rank={rank}]"] = {
                    "value": h["sum"] / h["count"],
                    "higher_is_better": False,
                }
    return {"kind": "run-dir", "host": None, "metrics": metrics}


def load_record(spec):
    """Load one comparison side from a path spec (file, ``file@IDX``
    for history ledgers, or a run dir)."""
    path, idx = spec, None
    if "@" in spec and not os.path.exists(spec):
        path, _, idx_s = spec.rpartition("@")
        try:
            idx = int(idx_s)
        except ValueError:
            path, idx = spec, None
    if os.path.isdir(path):
        return _from_run_dir(path)
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise SystemExit(f"compare: cannot read {path}: {e}")
    doc = None
    if not path.endswith(".jsonl"):
        # A pretty-printed single document also contains newlines, so
        # "one JSON value" is decided by the parser, not a heuristic.
        try:
            doc = json.loads(text)
        except ValueError:
            doc = None
    if doc is None:
        entries = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except ValueError:
                continue
        if not entries:
            raise SystemExit(f"compare: no parsable entries in {path}")
        try:
            entry = entries[idx if idx is not None else -1]
        except IndexError:
            raise SystemExit(
                f"compare: index {idx} out of range for {path} "
                f"({len(entries)} entries)")
        if isinstance(entry, dict) and "metrics" in entry:
            return _from_history_entry(entry)
        return _from_bench_json(entry)
    if "published" in doc:
        return _from_baseline(doc)
    if "metrics" in doc and "schema" in doc:
        return _from_history_entry(doc)
    return _from_bench_json(doc)


# -- the --explain diff ------------------------------------------------------


def _explain_windows(path):
    """rank -> diffable window for one run-dir side: the raw timeline
    events by lane when ``timeline.json`` survived (lane ``rank + 1``
    is rank ``r``, span names available — full-fidelity diff), else
    the capped per-step rows out of ``perf.json`` (component deltas
    still work; grown spans cannot be named)."""
    try:
        with open(os.path.join(path, "timeline.json")) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = None
    out = {}
    for e in (doc or {}).get("traceEvents", ()):
        pid = e.get("pid") if isinstance(e, dict) else None
        if isinstance(pid, int) and pid >= 1 and e.get("ph") != "M":
            out.setdefault(str(pid - 1), []).append(e)
    if out:
        return out
    try:
        with open(os.path.join(path, "perf.json")) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    for rank_s, rep in ((doc or {}).get("ranks") or {}).items():
        rows = (rep or {}).get("per_step")
        if rows:
            out[str(rank_s)] = list(rows)
    return out


def explain_run_dirs(base_path, cand_path):
    """The ``--explain`` core: per-rank
    :func:`~sparkdl_tpu_torch.observe.perf.diff_attribution` between two run
    dirs (base = the healthy run, candidate = the regressed one) —
    the SAME differential the alert-triggered forensics report writes,
    so the gate's "why" and the live incident's "why" read alike.
    Ranks with no attributable window on either side are skipped."""
    from sparkdl_tpu_torch.observe import perf

    base_w = _explain_windows(base_path)
    cand_w = _explain_windows(cand_path)
    out = {}
    for rank_s in sorted(set(base_w) & set(cand_w),
                         key=lambda r: (len(r), r)):
        diff = perf.diff_attribution(base_w[rank_s], cand_w[rank_s])
        if diff is not None:
            out[rank_s] = diff
    return out


# -- comparison --------------------------------------------------------------


def compare_records(base, cand, *, floor=0.05, iqr_k=1.0, only=None):
    """Metric-by-metric verdicts over the intersection of the two
    sides. Returns ``{"metrics": [...], "regressions": n,
    "improvements": n, "cross_host": bool}``."""
    bm, cm = base["metrics"], cand["metrics"]
    names = sorted(set(bm) & set(cm))
    if only:
        names = [n for n in names if n in only]
    rows = []
    regressions = improvements = 0
    for name in names:
        b, c = bm[name], cm[name]
        bv, basis_b = _effective_value(b)
        cv, basis_c = _effective_value(c)
        hib = _higher_is_better(
            name, b.get("higher_is_better", c.get("higher_is_better")))
        if bv == 0:
            continue
        delta = (cv - bv) / abs(bv)
        if not hib:
            delta = -delta
        noise = max(_rel_iqr(b.get("samples")), _rel_iqr(c.get("samples")))
        thr = max(floor, iqr_k * noise)
        status = ("regression" if delta < -thr
                  else "improved" if delta > thr else "ok")
        if status == "regression":
            regressions += 1
        elif status == "improved":
            improvements += 1
        rows.append({
            "metric": name,
            "base": bv,
            "candidate": cv,
            "basis": (basis_b if basis_b == basis_c
                      else f"{basis_b}/{basis_c}"),
            "delta": delta,
            "threshold": thr,
            "noise": noise,
            "higher_is_better": hib,
            "status": status,
        })
    cross = bool(base.get("host") and cand.get("host")
                 and base["host"] != cand["host"])
    return {
        "metrics": rows,
        "regressions": regressions,
        "improvements": improvements,
        "cross_host": cross,
        "base_host": base.get("host"),
        "candidate_host": cand.get("host"),
    }


def render_text(report):
    lines = []
    for r in report["metrics"]:
        arrow = {"regression": "REGRESSION", "improved": "improved",
                 "ok": "ok"}[r["status"]]
        noise_note = (", rel-IQR %.1f%%" % (r["noise"] * 100)
                      if r["noise"] > 0 else "")
        lines.append(
            "%-52s %14.4g -> %-14.4g %+7.2f%% (thr %.1f%%%s) %s"
            % (r["metric"], r["base"], r["candidate"],
               r["delta"] * 100, r["threshold"] * 100, noise_note,
               arrow))
    if not report["metrics"]:
        lines.append("compare: no common metrics between the two records")
    if report["cross_host"]:
        lines.append(
            f"NOTE: cross-host comparison ({report['base_host']} vs "
            f"{report['candidate_host']}) — verdicts are advisory "
            "unless --strict-host")
    lines.append(
        f"summary: {len(report['metrics'])} compared, "
        f"{report['regressions']} regression(s), "
        f"{report['improvements']} improvement(s)")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.observe.compare",
        description="Noise-aware perf comparison; exits 1 on "
                    "regression, 2 when nothing was comparable.",
    )
    parser.add_argument("base", help="baseline: bench JSON, "
                        "BASELINE.json, history.jsonl[@IDX], or run dir")
    parser.add_argument("candidate", help="candidate record (same forms)")
    parser.add_argument("--metric", action="append", default=None,
                        help="restrict to this metric (repeatable)")
    parser.add_argument("--floor", type=float, default=0.05,
                        help="minimum relative regression threshold "
                        "(default 0.05 = 5%%)")
    parser.add_argument("--iqr-k", type=float, default=1.0,
                        help="noise multiplier over rel-IQR of rep "
                        "samples (default 1.0)")
    parser.add_argument("--strict-host", action="store_true",
                        help="enforce regressions even across "
                        "different host fingerprints")
    parser.add_argument("--explain", action="store_true",
                        help="on a failing verdict between two run "
                        "dirs, append the per-rank differential step "
                        "attribution (why the candidate is slower)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    args = parser.parse_args(argv)

    base = load_record(args.base)
    cand = load_record(args.candidate)
    report = compare_records(
        base, cand, floor=args.floor, iqr_k=args.iqr_k,
        only=set(args.metric) if args.metric else None,
    )
    # ONE machine-readable verdict (the autotuner and CI consume the
    # same judge the humans read): per-metric rows already carry
    # base/candidate medians, delta, threshold, direction and status;
    # the top level names the gate's own decision and the exit code it
    # implies, so a JSON consumer never re-derives the cross-host /
    # no-overlap rules from the numbers.
    if not report["metrics"]:
        decision, rc = "no-overlap", 2
    elif report["regressions"] == 0:
        decision, rc = "ok", 0
    elif report["cross_host"] and not args.strict_host:
        decision, rc = "regression-advisory", 0
    else:
        decision, rc = "regression", 1
    report.update({"decision": decision, "exit_code": rc,
                   "floor": args.floor, "iqr_k": args.iqr_k,
                   "strict_host": bool(args.strict_host)})
    explain = None
    if (args.explain and decision != "ok"
            and os.path.isdir(args.base)
            and os.path.isdir(args.candidate)):
        explain = explain_run_dirs(args.base, args.candidate)
        report["explain"] = explain
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        text = render_text(report)
        if explain:
            from sparkdl_tpu_torch.observe.perf import render_diff_lines

            lines = ["why (differential step attribution, base -> "
                     "candidate):"]
            for rank_s, diff in explain.items():
                lines.append(f"  rank {rank_s}:")
                lines.extend(render_diff_lines(diff, indent="    "))
            text += "\n" + "\n".join(lines)
        elif explain is not None:
            text += ("\nwhy: no attributable step windows on both "
                     "sides — nothing to diff")
        print(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
