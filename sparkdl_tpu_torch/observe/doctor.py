"""``python -m sparkdl_tpu_torch.observe.doctor RUN_DIR``: one
post-mortem over a merged run dir.

Counterpart of ``sparkdl_tpu/observe/doctor.py``, the same code over the
same artifacts, which the port's gangs and servers write under the JAX
package's names: the verdict instants of ``timeline.json``, the per-rank
gauges of ``metrics.json``, ``health.json``, the ``stack-rank-*.txt``
dumps and the ``flightrec-rank-*`` tails, and the sections' own files:
``perf.json`` (step attribution and MFU), ``comms_report.json``,
``fixit_report.json``, ``alerts.json``, ``regression_report.json`` with
the captures' ``profile_report-rank-*.json`` and traces (the port's
``trace-rank-*.json`` files beside the JAX package's ``xprof-rank-*``
directories), ``elastic.json`` when it is there, the serving spans and
``server_*`` series, and the memory samples and ``oom_report*.json``.
``--format json`` emits the diagnosis as one document. Exit code:
nonzero on a hang verdict, 0 for a clean run, 2 for a directory with no
readable artifact. Artifact-only: no card, no control plane, no gang.
"""

import argparse
import glob
import json
import os
import re
import sys


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fmt_bytes(n):
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.1f} {unit}" if unit != "B"
                    else f"{int(n)} {unit}")
        n /= 1024.0
    return f"{n:.1f} TiB"


def _series_by_rank(metrics_doc):
    """rank-label -> {counters: {(name, label-items): v},
    gauges: {...}, histograms: {...: {"sum", "count"}}} from
    metrics.json."""
    out = {}
    for series in (metrics_doc or {}).get("series", ()):
        rank = series.get("labels", {}).get("rank")
        if rank is None:
            continue
        ranks = out.setdefault(
            rank, {"counters": {}, "gauges": {}, "histograms": {}})
        for kind in ("counters", "gauges"):
            for s in series.get(kind, ()):
                labels = {k: v for k, v in s.get("labels", {}).items()
                          if k != "rank"}
                key = (s.get("name"),
                       tuple(sorted(labels.items())))
                ranks[kind][key] = s.get("value")
        for s in series.get("histograms", ()):
            labels = {k: v for k, v in s.get("labels", {}).items()
                      if k != "rank"}
            key = (s.get("name"), tuple(sorted(labels.items())))
            ranks["histograms"][key] = {
                "sum": s.get("sum"), "count": s.get("count")}
    return out


def _gauge(rank_series, name, **labels):
    return rank_series.get("gauges", {}).get(
        (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    )


def _diagnose_perf(run_dir, events, by_rank):
    """"Where the time went" (or None): per-rank step-time attribution
    — compute / collective / host-callback / data-wait / checkpoint
    fractions plus overlap efficiency — from ``perf.json`` when the
    aggregator wrote one, else recomputed from the merged timeline
    (events grouped by lane; lane ``rank + 1`` is rank ``r``), plus
    whatever MFU / achieved-FLOPs gauges the ranks exported. Pure
    artifact math (:mod:`sparkdl_tpu_torch.observe.perf` reads no card) so
    a copied run dir diagnoses anywhere."""
    from sparkdl_tpu_torch.observe import perf as _perf

    ranks = {}
    doc = _load_json(os.path.join(run_dir, "perf.json"))
    if doc and isinstance(doc.get("ranks"), dict):
        ranks = {str(r): rep for r, rep in doc["ranks"].items()
                 if isinstance(rep, dict) and rep.get("steps")}
    if not ranks:
        by_lane = {}
        for e in events:
            pid = e.get("pid")
            if isinstance(pid, int) and pid >= 1:
                by_lane.setdefault(pid - 1, []).append(e)
        for rank in sorted(by_lane):
            rep = _perf.attribution_report(by_lane[rank])
            if rep.get("steps"):
                ranks[str(rank)] = rep
    out = {}
    for rank_s, rep in sorted(ranks.items()):
        entry = {
            "steps": rep.get("steps"),
            "total_s": rep.get("total_s"),
            "components": rep.get("components"),
            "fractions": rep.get("fractions"),
            "overlap_efficiency": rep.get("overlap_efficiency"),
            "inter_step_data_wait_s": rep.get("inter_step_data_wait_s"),
        }
        series = by_rank.get(rank_s, {})
        for name in ("mfu", "achieved_flops_per_sec"):
            for (g_name, _labels), v in series.get("gauges", {}).items():
                if g_name == name:
                    entry[name] = v
                    break
        out[rank_s] = entry
    return out or None


def _diagnose_comms(run_dir, by_rank):
    """Predicted-vs-measured communication (or None): the static comms
    budget the launcher pre-flight priced (``comms_report.json``, per
    step under a ring assumption) set against the runtime
    ``collective_bytes_total`` counters each rank actually moved —
    with a measured-per-step/predicted ratio when the rank's executed
    step count is recoverable from ``train_step_total``."""
    doc = _load_json(os.path.join(run_dir, "comms_report.json"))
    reports = [r for r in (doc or {}).get("reports", ())
               if isinstance(r, dict)]
    measured = {}
    for rank_label, series in by_rank.items():
        if not rank_label.isdigit():
            continue
        by_op = {}
        steps = None
        for (name, labels), v in series.get("counters", {}).items():
            if name == "collective_bytes_total":
                by_op[dict(labels).get("op", "?")] = int(v)
            elif (name == "train_step_total"
                  and dict(labels).get("phase") == "execute"):
                steps = int(v)
        if by_op:
            measured[rank_label] = {
                "bytes_by_op": by_op,
                "bytes_total": sum(by_op.values()),
                "steps": steps,
            }
    if not reports and not measured:
        return None
    predicted = sum(
        r.get("totals", {}).get("wire_bytes_per_device") or 0
        for r in reports
    )
    for entry in measured.values():
        if predicted and entry["steps"]:
            entry["per_step_vs_predicted"] = round(
                (entry["bytes_total"] / entry["steps"]) / predicted, 3)
    return {
        "reports": [
            {"name": r.get("name"),
             "device_kind": r.get("device_kind"),
             "totals": r.get("totals")}
            for r in reports
        ],
        "predicted_wire_bytes_per_device_per_step": predicted or None,
        "measured_by_rank": measured,
    }


def _diagnose_fixit(run_dir):
    """Suggested/applied fixes (or None): the verified fixit reports
    the launcher pre-flight wrote (``fixit_report.json``, schema
    ``sparkdl_tpu.analysis.fixit_report/1``) — per fix: the rule, the
    machine action, whether its four proofs held, whether it was
    applied or degraded to the original finding, and the predicted
    peak-HBM delta. Pure artifact math — the doctor renders the
    remediation story from the file alone."""
    doc = _load_json(os.path.join(run_dir, "fixit_report.json"))
    reports = [r for r in (doc or {}).get("reports", ())
               if isinstance(r, dict)]
    if not reports:
        return None
    out = []
    for rep in reports:
        fixes = []
        for entry in rep.get("fixes", ()):
            proofs = entry.get("proofs") or {}
            mem = (proofs.get("budget_delta") or {}).get("memory") or {}
            fixes.append({
                "rule_id": entry.get("rule_id"),
                "action": entry.get("action"),
                "verified": bool(entry.get("verified")),
                "applied": bool(entry.get("applied")),
                "degraded": bool(entry.get("degraded")),
                "degrade_reason": entry.get("degrade_reason"),
                "description": (entry.get("fix") or {}).get("description"),
                "proofs_ok": {k: bool((v or {}).get("ok"))
                              for k, v in proofs.items()},
                "peak_bytes_delta": mem.get("peak_bytes_delta"),
            })
        out.append({
            "name": rep.get("name"),
            "mode": rep.get("mode"),
            "summary": rep.get("summary") or {},
            "fixes": fixes,
            "unfixable": len(rep.get("unfixable") or ()),
        })
    return {"reports": out}


def _diagnose_alerts(run_dir):
    """Live-alert section (or None when the run predates the alert
    engine / never enabled it): the ``alerts.json`` the launcher
    wrote — rule catalog, baseline, and every firing, exactly as the
    engine saw them mid-run. Artifact-only like everything else here:
    no card, no live gang, reproduced from the file alone."""
    doc = _load_json(os.path.join(run_dir, "alerts.json"))
    if not isinstance(doc, dict):
        return None
    fired = [a for a in doc.get("alerts", ()) if isinstance(a, dict)]
    return {
        "enabled": bool(doc.get("enabled")),
        "rules": [r.get("rule") for r in doc.get("rules", ())
                  if isinstance(r, dict)],
        "baseline_step_s": doc.get("baseline_step_s"),
        "baseline_source": doc.get("baseline_source"),
        "fired": fired,
    }


def _diagnose_forensics(run_dir):
    """Perf-forensics section (or None when no capture ever ran): the
    ``regression_report.json`` the forensics manager wrote — one entry
    per trigger, each carrying the differential attribution between
    the alert rule's own calibration window and the window that fired
    — plus every worker-side ``profile_report-rank-*.json`` capture
    (bounded profile window: uncapped attribution rows, device-memory
    snapshot, trace) the aggregator recovered from the job
    dirs. Artifact-only like everything else here: the diff is
    rendered from the stored doc, never recomputed."""
    doc = _load_json(os.path.join(run_dir, "regression_report.json"))
    reports = [r for r in (doc or {}).get("reports", ())
               if isinstance(r, dict)]
    captures = []
    for p in sorted(glob.glob(os.path.join(run_dir,
                                           "profile_report*.json"))):
        rep = _load_json(p)
        if not isinstance(rep, dict):
            continue
        attribution = rep.get("attribution") or {}
        captures.append({
            "file": os.path.basename(p),
            "rank": rep.get("rank"),
            "reason": rep.get("reason"),
            "rule": rep.get("rule"),
            "steps_captured": rep.get("steps_captured"),
            "window_s": rep.get("window_s"),
            "trace_dir": rep.get("trace_dir"),
            "attribution_steps": attribution.get("steps"),
            "fractions": attribution.get("fractions"),
            "overlap_efficiency": attribution.get("overlap_efficiency"),
            "device_memory": rep.get("device_memory") or None,
        })
    # the JAX package's xprof directories, the port's Chrome trace files
    trace_dirs = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(run_dir, "xprof-rank-*"))
        if os.path.isdir(p)) + sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(run_dir, "trace-rank-*.json")))
    if not reports and not captures and not trace_dirs:
        return None
    return {"reports": reports, "captures": captures,
            "trace_dirs": trace_dirs}


def _diagnose_elastic(run_dir):
    """Elastic-controller section (or None when the run predates
    autonomous elasticity / never enabled it): the ``elastic.json``
    decision log — every grow/yield/reclaim the controller planned,
    emitted, refused or cancelled, reproduced from the artifact
    alone."""
    doc = _load_json(os.path.join(run_dir, "elastic.json"))
    if not isinstance(doc, dict):
        return None
    decisions = [d for d in doc.get("decisions", ())
                 if isinstance(d, dict)]
    return {
        "enabled": bool(doc.get("enabled")),
        "arbiter": bool(doc.get("arbiter")),
        "current_np": doc.get("current_np"),
        "available_np": doc.get("available_np"),
        "transitions": doc.get("transitions") or {},
        "decisions": decisions,
    }


def _diagnose_serving(events, by_rank, top_n=5):
    """Serving-run section (or None for pure gang dirs): slowest
    requests by TTFT, the admission rejection/deferral breakdown, and
    the batch-utilization summary — sourced from the ``cat="serving"``
    span tree plus the ``server_*``/``engine_*`` metric series a
    :class:`~sparkdl_tpu_torch.models.server.ServingFrontend` run leaves."""
    req_spans = [e for e in events
                 if e.get("cat") == "serving"
                 and e.get("name") == "request" and e.get("ph") == "X"]
    srv = {}
    for series in by_rank.values():
        for kind in ("counters", "gauges", "histograms"):
            for (name, labels), v in series.get(kind, {}).items():
                if name.startswith(("server_", "engine_")):
                    srv.setdefault(kind, {})[(name, labels)] = v
    if not req_spans and not srv:
        return None

    by_code = {}
    for (name, labels), v in srv.get("counters", {}).items():
        if name == "server_requests_total":
            by_code[dict(labels).get("code", "?")] = int(v)
    rejections = {}
    for (name, labels), v in srv.get("counters", {}).items():
        if name in ("server_admission_rejections_total",
                    "engine_admission_deferrals_total"):
            reason = dict(labels).get("reason", "?")
            if name.startswith("engine_"):
                reason += " (deferred, requeued)"
            rejections[reason] = int(v)

    slowest = sorted(
        (e.get("args", {}) for e in req_spans
         if e.get("args", {}).get("ttft_s") is not None),
        key=lambda a: a["ttft_s"], reverse=True,
    )[:top_n]
    slowest = [{k: a.get(k) for k in
                ("rid", "ttft_s", "queue_wait_s", "tokens",
                 "tokens_per_sec", "code", "prompt_len")}
               for a in slowest]

    util = srv.get("histograms", {}).get(("engine_batch_utilization", ()))
    utilization = None
    if util and util.get("count"):
        utilization = {
            "mean": round(util["sum"] / util["count"], 4),
            "chunks": int(util["count"]),
        }
    return {
        "requests": len(req_spans),
        "by_code": by_code,
        "slowest_requests_by_ttft": slowest,
        "admission_rejections": rejections,
        "batch_utilization": utilization,
    }


def _diagnose_memory(run_dir, by_rank, health):
    """The memory section (or None when the run carried no memory
    evidence): per-rank category tables from the ``mem_bytes{category}``
    / ``host_rss_bytes`` gauges (the beacon samples in ``health.json``
    fill gaps for a rank whose final flush never landed), the leak
    alerts' named categories from ``alerts.json``, and every
    ``oom_report*.json`` the mem ``oom_guard`` wrote — the OOM verdict
    that flips the doctor's exit code. Artifact-only, like the rest."""
    ranks = {}
    for rank_label, series in by_rank.items():
        if not rank_label.isdigit():
            continue
        entry = {}
        rss = _gauge(series, "host_rss_bytes")
        if rss is not None:
            entry["rss_bytes"] = rss
        cats = {}
        for (name, labels), v in series.get("gauges", {}).items():
            if name == "mem_bytes":
                cat = dict(labels).get("category")
                if cat is not None:
                    cats[cat] = v
        if cats:
            entry["categories"] = cats
        if entry:
            ranks[rank_label] = entry
    for att in (health or {}).get("attempts", []):
        for rank_s, info in (att.get("ranks") or {}).items():
            mem = info.get("mem") or {}
            if not mem:
                continue
            entry = ranks.setdefault(str(rank_s), {})
            if entry.get("rss_bytes") is None \
                    and mem.get("rss") is not None:
                entry["rss_bytes"] = mem["rss"]
            cats = entry.setdefault("categories", {})
            for cat, v in (mem.get("categories") or {}).items():
                cats.setdefault(cat, v)
            if mem.get("unattributed") is not None:
                cats.setdefault("unattributed", mem["unattributed"])
            if not cats:
                del entry["categories"]

    leaks = []
    alerts = _load_json(os.path.join(run_dir, "alerts.json")) or {}
    for rec in alerts.get("alerts") or ():
        if rec.get("rule") in ("hbm_leak", "host_rss_growth"):
            d = rec.get("detail") or {}
            leaks.append({
                "rule": rec.get("rule"),
                "rank": rec.get("rank"),
                "category": d.get("category"),
                "slope_bytes_per_step": d.get("slope_bytes_per_step"),
                "threshold_bytes_per_step":
                    d.get("threshold_bytes_per_step"),
            })

    ooms = []
    for p in sorted(glob.glob(os.path.join(run_dir,
                                           "oom_report*.json"))):
        rep = _load_json(p)
        if not isinstance(rep, dict):
            continue
        ooms.append({
            "file": os.path.basename(p),
            "phase": rep.get("phase"),
            "rank": rep.get("rank"),
            "error": str(rep.get("error") or "")[:400],
            "categories": rep.get("categories") or {},
            "unattributed": rep.get("unattributed"),
            "host_rss_bytes": rep.get("host_rss_bytes"),
            "device": rep.get("device") or {},
            "static_budget_bytes": rep.get("static_budget_bytes"),
            "largest_buffers": (rep.get("largest_buffers") or [])[:3],
            "hints": rep.get("hints") or [],
        })

    if not ranks and not leaks and not ooms:
        return None
    return {"ranks": ranks, "leaks": leaks, "oom_reports": ooms,
            "oom": bool(ooms)}


def diagnose(run_dir):
    """Build the structured diagnosis dict for one run dir, or None
    when the directory holds no recognizable artifacts."""
    timeline = _load_json(os.path.join(run_dir, "timeline.json"))
    metrics = _load_json(os.path.join(run_dir, "metrics.json"))
    health = _load_json(os.path.join(run_dir, "health.json"))
    # Crash path: a process SIGKILLed between artifact writes (a
    # serving frontend killed mid-burst — or before its first write,
    # leaving no timeline.json at all) still mirrored its newest
    # events into the flight-recorder ring in the run dir. Recover
    # the tail straight from the mmap file and MERGE it: any ring
    # event not already in timeline.json is story the kill cut off
    # (the doctor stays artifact-only).
    from sparkdl_tpu_torch.observe.flightrec import recover_job_dir

    ring_events = []
    for evs in recover_job_dir(run_dir).values():
        ring_events.extend(e for e in evs if isinstance(e, dict))
    fixit = _diagnose_fixit(run_dir)
    # An OOM-killed process may have written NOTHING but its report —
    # a dir holding only oom_report.json still diagnoses.
    has_oom = bool(glob.glob(os.path.join(run_dir, "oom_report*.json")))
    if (timeline is None and metrics is None and health is None
            and not ring_events and fixit is None and not has_oom):
        return None

    events = [e for e in (timeline or {}).get("traceEvents", ())
              if isinstance(e, dict) and e.get("ph") != "M"]

    def _ev_key(e):
        # stable under the ring's oversized-args truncation (which
        # keeps name/ph/ts/tid) — dedupe must not resurrect events
        # the timeline already has in full
        return (e.get("ts"), e.get("name"), e.get("tid"), e.get("ph"))

    seen = {_ev_key(e) for e in events}
    ring_fresh = [e for e in ring_events
                  if e.get("ph") != "M" and _ev_key(e) not in seen]
    events.extend(ring_fresh)

    def named(name):
        return [e for e in events if e.get("name") == name]

    # -- verdict: health.json is authoritative, the timeline's
    # health.hang instant corroborates (either alone suffices — the
    # doctor must reproduce the verdict from whatever survived).
    verdict = None
    stalled, silent = set(), set()
    attempts = (health or {}).get("attempts", [])
    for att in attempts:
        if att.get("hang_verdict"):
            verdict = att["hang_verdict"]
        stalled.update(att.get("stalled", ()))
        silent.update(att.get("silent", ()))
    for ev in named("health.hang"):
        verdict = verdict or ev.get("args", {}).get("verdict")
        stalled.update(ev.get("args", {}).get("stalled", ()))
        silent.update(ev.get("args", {}).get("silent", ()))
    for ev in named("health.stall"):
        rank = ev.get("args", {}).get("rank")
        if rank is not None:
            stalled.add(rank)
    for ev in named("health.silent"):
        rank = ev.get("args", {}).get("rank")
        if rank is not None:
            silent.add(rank)

    # -- per-rank state: detector summaries first, gauge fallback.
    # Source the forensics from the attempt that HUNG, not the last
    # one — a clean resumed attempt overwrites step/collective with
    # its own (restarted) values and would repaint the postmortem.
    ranks = {}
    hung_attempts = [a for a in attempts if a.get("hang_verdict")]
    for att in (hung_attempts or attempts):
        for rank_s, info in (att.get("ranks") or {}).items():
            ranks[int(rank_s)] = {
                "step": info.get("step"),
                "collective": info.get("collective"),
                "hbm": info.get("hbm") or {},
            }
        if hung_attempts:
            break   # first hung attempt is the incident
    by_rank = _series_by_rank(metrics)
    for rank_label, series in by_rank.items():
        if not rank_label.isdigit():
            continue
        rank = int(rank_label)
        info = ranks.setdefault(
            rank, {"step": None, "collective": None, "hbm": {}})
        if info["step"] is None:
            step = _gauge(series, "worker_step")
            if step is not None:
                info["step"] = int(step)
        for kind in ("peak", "in_use", "limit", "live_buffers"):
            v = _gauge(series, "device_hbm_bytes", kind=kind)
            if v is not None and kind not in info["hbm"]:
                info["hbm"][kind] = v

    # -- supervisor story from the driver lane
    failures = [
        {"attempt": e.get("args", {}).get("attempt"),
         "verdict": e.get("args", {}).get("verdict"),
         "cause": e.get("args", {}).get("cause")}
        for e in named("gang.failure")
    ]
    resumes = [e.get("args", {}) for e in named("gang.resume")]
    # Elastic resume: every resharded restore left a gang.reshard
    # event carrying the recorded→surviving axes, the bytes it moved
    # and the memory-accounted high water vs the plan's bound — the
    # whole topology transition, reproducible from artifacts alone.
    reshards = [e.get("args", {}) for e in named("gang.reshard")]
    hang_causes = [f for f in failures
                   if "hang" in str(f.get("cause", "")).lower()]
    if verdict is None and hang_causes:
        # Last resort: the supervisor recorded a HANG cause even
        # though health.json and the health.* instants were lost.
        m = re.search(r"HANG \((\w+)\)", hang_causes[0].get("cause") or "")
        verdict = m.group(1) if m else "hung"

    stack_dumps = {
        int(os.path.basename(p)[len("stack-rank-"):-len(".txt")]): p
        for p in glob.glob(os.path.join(run_dir, "stack-rank-*.txt"))
    }
    flight = {}
    for p in glob.glob(os.path.join(run_dir, "flightrec-rank-*.json")):
        doc = _load_json(p)
        if doc is not None:
            flight[int(doc.get("rank", -1))] = len(doc.get("events", ()))

    chaos = sorted({e.get("name") for e in events
                    if e.get("cat") == "chaos"})

    return {
        "run_dir": run_dir,
        "recovered_from_flight_recorder": bool(ring_fresh),
        "flight_recorder_recovered_events": len(ring_fresh),
        "serving": _diagnose_serving(events, by_rank),
        "memory": _diagnose_memory(run_dir, by_rank, health),
        "alerts": _diagnose_alerts(run_dir),
        "forensics": _diagnose_forensics(run_dir),
        "elastic": _diagnose_elastic(run_dir),
        "perf": _diagnose_perf(run_dir, events, by_rank),
        "comms": _diagnose_comms(run_dir, by_rank),
        "fixit": fixit,
        "hang": verdict is not None,
        "verdict": verdict,
        "stalled_ranks": sorted(stalled),
        "silent_ranks": sorted(silent),
        "ranks": {str(r): ranks[r] for r in sorted(ranks)},
        "failures": failures,
        "resumes": resumes,
        "reshards": reshards,
        "stack_dumps": {str(r): os.path.basename(p)
                        for r, p in sorted(stack_dumps.items())},
        "flight_recorder_events": {str(r): n
                                   for r, n in sorted(flight.items())},
        "chaos_injections": chaos,
    }


def render_text(diag):
    lines = [f"observe.doctor: {diag['run_dir']}"]
    if diag["hang"]:
        lines.append(f"verdict: HANG ({diag['verdict']})")
    else:
        lines.append("verdict: no hang found")
    if (diag.get("memory") or {}).get("oom"):
        n = len(diag["memory"]["oom_reports"])
        lines.append(f"verdict: OOM ({n} report(s))")
    stalled = set(diag["stalled_ranks"])
    silent = set(diag["silent_ranks"])
    for rank_s, info in diag["ranks"].items():
        rank = int(rank_s)
        state = ("stalled" if rank in stalled
                 else "silent" if rank in silent
                 else "progressed")
        line = f"  rank {rank}: {state}"
        if info.get("step") is not None:
            line += (f" @ step {info['step']}" if state == "stalled"
                     else f" to step {info['step']}")
        if info.get("collective"):
            line += f", last entered {info['collective']}"
        hbm = info.get("hbm") or {}
        peak = hbm.get("peak", hbm.get("in_use",
                                       hbm.get("live_buffers")))
        if peak is not None:
            line += f"; HBM high-water {_fmt_bytes(peak)}"
        lines.append(line)
    if diag["stack_dumps"]:
        lines.append("stack dumps: " + ", ".join(
            f"rank {r} ({name})"
            for r, name in diag["stack_dumps"].items()))
    if diag["flight_recorder_events"]:
        lines.append("flight recorder tails: " + ", ".join(
            f"rank {r} ({n} events)"
            for r, n in diag["flight_recorder_events"].items()))
    if diag["failures"]:
        causes = "; ".join(
            f"attempt {f.get('attempt')}: {f.get('verdict')} — "
            f"{f.get('cause')}" for f in diag["failures"])
        lines.append(f"supervisor: {len(diag['failures'])} classified "
                     f"failure(s): {causes}")
    if diag["resumes"]:
        steps = ", ".join(str(r.get("resume_step")) for r in diag["resumes"])
        lines.append(f"resumed: {len(diag['resumes'])} relaunch(es) "
                     f"(resume step(s): {steps})")
    for r in diag.get("reshards") or ():
        def axes_s(a):
            return ("{" + ", ".join(f"{k}={v}" for k, v in
                                    sorted((a or {}).items())) + "}")
        line = (f"reshard: {r.get('direction')} "
                f"{axes_s(r.get('source_axes'))} -> "
                f"{axes_s(r.get('target_axes'))} at step "
                f"{r.get('step')}: {r.get('params')} param(s) in "
                f"{r.get('groups')} group(s), "
                f"{_fmt_bytes(r.get('bytes_moved'))} moved")
        hw = r.get("high_water_accounted_bytes")
        bound = r.get("restore_high_water_bytes")
        if hw is not None:
            line += f"; restore high-water {_fmt_bytes(hw)}"
            if bound is not None:
                line += f" (plan bound {_fmt_bytes(bound)})"
            hbm = r.get("hbm_bytes")
            if hbm:
                line += f" vs HBM {_fmt_bytes(hbm)}"
        lines.append(line)
    if diag["chaos_injections"]:
        lines.append("chaos injections on the timeline: "
                     + ", ".join(diag["chaos_injections"]))
    if diag.get("recovered_from_flight_recorder"):
        lines.append(
            f"NOTE: {diag.get('flight_recorder_recovered_events')} "
            "event(s) recovered from the flight-recorder ring "
            "(the process died before its final artifact write)")
    alerts = diag.get("alerts")
    if alerts:
        fired = alerts.get("fired") or []
        if not alerts.get("enabled"):
            pass
        elif not fired:
            lines.append(
                f"alerts: none fired ({len(alerts.get('rules') or [])}"
                " rule(s) evaluated)")
        else:
            from sparkdl_tpu_torch.observe.alerts import format_alert_line

            lines.append(f"alerts: {len(fired)} fired")
            for a in fired:
                lines.append("  " + format_alert_line(a))
    elastic = diag.get("elastic")
    if elastic and elastic.get("enabled"):
        decisions = elastic.get("decisions") or []
        head = (f"elastic: {len(decisions)} decision(s)"
                if decisions else "elastic: enabled, no decisions")
        if elastic.get("arbiter"):
            head += " (arbiter on)"
        lines.append(head)
        for d in decisions:
            line = (f"  [{d.get('direction')}] np {d.get('from_np')} "
                    f"-> {d.get('to_np')} ({d.get('reason')}): "
                    f"{d.get('outcome')}")
            if d.get("resume_step") is not None:
                line += f" from step {d['resume_step']}"
            lines.append(line)
    perf = diag.get("perf")
    if perf:
        lines.append("where the time went (per step-thread second):")
        for rank_s, p in sorted(perf.items(), key=lambda kv: kv[0]):
            fr = p.get("fractions") or {}
            parts = ", ".join(
                f"{name.replace('_', ' ')} {fr[name] * 100:.1f}%"
                for name in ("compute", "collective", "host_callback",
                             "data_wait", "checkpoint")
                if isinstance(fr.get(name), (int, float))
                and fr[name] > 0.0005
            )
            line = (f"  rank {rank_s}: {parts or 'no attributed time'}"
                    f" over {p.get('steps')} step(s)")
            eff = p.get("overlap_efficiency")
            if eff is not None:
                line += f"; collective overlap {eff * 100:.0f}%"
            if p.get("mfu") is not None:
                line += f"; MFU {p['mfu'] * 100:.2f}%"
            wait = p.get("inter_step_data_wait_s")
            if isinstance(wait, (int, float)) and wait > 0.0005:
                line += f"; +{wait:.3f}s data wait between steps"
            lines.append(line)
    forensics = diag.get("forensics")
    if forensics:
        from sparkdl_tpu_torch.observe.perf import render_diff_lines

        reports = forensics.get("reports") or []
        captures = forensics.get("captures") or []
        lines.append(
            f"perf forensics: {len(reports)} regression report(s), "
            f"{len(captures)} capture(s)")
        for rep in reports:
            head = (f"  [{rep.get('rule') or rep.get('reason')}] "
                    f"rank {rep.get('rank')}")
            cap = rep.get("capture") or {}
            if cap.get("report"):
                head += f" (capture: {cap['report']})"
            lines.append(head)
            diff = rep.get("diff")
            if diff:
                lines.extend(render_diff_lines(diff, indent="    "))
            else:
                lines.append(
                    "    (no attributable windows to diff — see the "
                    "capture artifacts)")
        for c in captures:
            line = (f"  capture rank {c.get('rank')} "
                    f"[{c.get('rule') or c.get('reason')}] "
                    f"({c['file']}): {c.get('steps_captured')} step(s)")
            if isinstance(c.get("window_s"), (int, float)):
                line += f" in {c['window_s']:.1f}s"
            fr = c.get("fractions") or {}
            parts = ", ".join(
                f"{name.replace('_', ' ')} {fr[name] * 100:.1f}%"
                for name in ("compute", "collective", "host_callback",
                             "data_wait", "checkpoint")
                if isinstance(fr.get(name), (int, float))
                and fr[name] > 0.0005)
            if parts:
                line += f"; {parts}"
            if c.get("trace_dir"):
                # a directory (xprof) gets its slash, a trace file none
                line += f"; trace {c['trace_dir']}" + (
                    "" if c["trace_dir"].endswith(".json") else "/")
            lines.append(line)
        if forensics.get("trace_dirs"):
            lines.append("  traces recovered: "
                         + ", ".join(forensics["trace_dirs"]))
    comms = diag.get("comms")
    if comms:
        pred = comms.get("predicted_wire_bytes_per_device_per_step")
        for rep in comms.get("reports", ()):
            t = rep.get("totals") or {}
            lines.append(
                f"static comms budget [{rep.get('name')}]: "
                f"{t.get('count')} collective(s), "
                f"{_fmt_bytes(t.get('wire_bytes_per_device'))}/device"
                "/step predicted on the wire "
                f"(~{(t.get('predicted_s') or 0) * 1e3:.3f} ms, ring, "
                f"{rep.get('device_kind')})")
        for rank_s, m in sorted(comms.get("measured_by_rank",
                                          {}).items()):
            line = (f"  measured rank {rank_s}: "
                    f"{_fmt_bytes(m.get('bytes_total'))} via "
                    + ", ".join(f"{op} {_fmt_bytes(b)}"
                                for op, b in
                                sorted(m.get("bytes_by_op",
                                             {}).items())))
            if m.get("steps"):
                line += f" over {m['steps']} step(s)"
            ratio = m.get("per_step_vs_predicted")
            if ratio is not None:
                line += f"; {ratio:.2f}x the predicted budget/step"
            elif pred is None:
                line += (" (no static budget to compare — the "
                         "pre-flight prices registered steps only)")
            lines.append(line)
    fixit = diag.get("fixit")
    if fixit:
        for rep in fixit.get("reports", ()):
            s = rep.get("summary") or {}
            lines.append(
                f"suggested fixes [{rep.get('name')}] "
                f"({rep.get('mode')}): {s.get('proposed', 0)} "
                f"proposed, {s.get('verified', 0)} verified, "
                f"{s.get('applied', 0)} applied, "
                f"{s.get('degraded', 0)} degraded"
                + (f"; {rep['unfixable']} unfixable finding(s)"
                   if rep.get("unfixable") else ""))
            for fx in rep.get("fixes", ()):
                state = ("applied" if fx.get("applied")
                         else "verified" if fx.get("verified")
                         else "degraded")
                line = (f"  [{state}] {fx.get('rule_id')} -> "
                        f"{fx.get('action')}")
                delta = fx.get("peak_bytes_delta")
                if isinstance(delta, (int, float)):
                    line += f" (peak {_fmt_bytes(delta)})"
                if fx.get("degrade_reason"):
                    line += f": {fx['degrade_reason']}"
                elif fx.get("description"):
                    line += f": {fx['description']}"
                proofs = fx.get("proofs_ok") or {}
                if proofs:
                    line += (" [proofs: " + ", ".join(
                        f"{k}={'ok' if v else 'FAIL'}"
                        for k, v in sorted(proofs.items())) + "]")
                lines.append(line)
    memory = diag.get("memory")
    if memory:
        lines.append("memory:")
        for rank_s, entry in sorted(memory["ranks"].items()):
            cats = entry.get("categories") or {}
            parts = ", ".join(
                f"{c} {_fmt_bytes(v)}"
                for c, v in sorted(cats.items(),
                                   key=lambda kv: -(kv[1] or 0)))
            line = f"  rank {rank_s}:"
            if entry.get("rss_bytes") is not None:
                line += f" host RSS {_fmt_bytes(entry['rss_bytes'])}"
            if parts:
                line += f"; {parts}"
            lines.append(line)
        for leak in memory["leaks"]:
            where = (f" rank {leak['rank']}"
                     if leak.get("rank") is not None else "")
            line = (f"  leak [{leak['rule']}]{where}: category "
                    f"'{leak.get('category')}' growing "
                    f"{_fmt_bytes(leak.get('slope_bytes_per_step'))}"
                    "/step")
            thr = leak.get("threshold_bytes_per_step")
            if thr is not None:
                line += f" (threshold {_fmt_bytes(thr)}/step)"
            lines.append(line)
        for oom in memory["oom_reports"]:
            where = (f" rank {oom['rank']}"
                     if oom.get("rank") is not None else "")
            lines.append(f"  OOM [{oom.get('phase')}]{where} "
                         f"({oom['file']}): {oom.get('error')}")
            cats = oom.get("categories") or {}
            if cats:
                lines.append("    categories at death: " + ", ".join(
                    f"{c} {_fmt_bytes(v)}"
                    for c, v in sorted(cats.items(),
                                       key=lambda kv: -(kv[1] or 0))))
            if oom.get("unattributed") is not None:
                lines.append("    unattributed: "
                             + _fmt_bytes(oom["unattributed"]))
            peak = (oom.get("device") or {}).get("peak")
            budget = oom.get("static_budget_bytes")
            if peak is not None or budget is not None:
                lines.append(
                    f"    measured peak {_fmt_bytes(peak)} vs static "
                    f"budget {_fmt_bytes(budget)}")
            for buf in oom.get("largest_buffers") or ():
                lines.append(
                    f"    largest: {buf.get('count')} x "
                    f"{buf.get('shape')} {buf.get('dtype')} = "
                    f"{_fmt_bytes(buf.get('bytes'))}")
            for hint in oom.get("hints") or ():
                lines.append(f"    hint: {hint}")
    srv = diag.get("serving")
    if srv:
        codes = ", ".join(f"{c}: {n}" for c, n in
                          sorted(srv["by_code"].items()))
        lines.append(f"serving: {srv['requests']} traced request(s)"
                     + (f" ({codes})" if codes else ""))
        if srv["slowest_requests_by_ttft"]:
            lines.append("  slowest requests by TTFT:")
            for r in srv["slowest_requests_by_ttft"]:
                extra = ""
                if r.get("queue_wait_s") is not None:
                    extra += f", queued {r['queue_wait_s'] * 1e3:.1f} ms"
                if r.get("tokens_per_sec"):
                    extra += f", {r['tokens_per_sec']:.1f} tok/s"
                lines.append(
                    f"    rid {r.get('rid')}: "
                    f"ttft {r['ttft_s'] * 1e3:.1f} ms"
                    f" ({r.get('tokens')} tok, code {r.get('code')}"
                    f"{extra})")
        if srv["admission_rejections"]:
            lines.append("  admission rejections: " + "; ".join(
                f"{reason}: {n}" for reason, n in
                sorted(srv["admission_rejections"].items())))
        util = srv.get("batch_utilization")
        if util:
            lines.append(
                f"  batch utilization: {util['mean']:.2f} mean over "
                f"{util['chunks']} decode chunk(s)")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.observe.doctor",
        description="Postmortem diagnosis over a merged telemetry run "
                    "dir; exits nonzero when a hang or OOM verdict is "
                    "found.",
    )
    parser.add_argument("run_dir", help="a run-* dir under "
                        "observe.TELEMETRY_DIR (or a copy of one)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    args = parser.parse_args(argv)

    diag = diagnose(args.run_dir)
    if diag is None:
        print(f"observe.doctor: no telemetry artifacts under "
              f"{args.run_dir} (expected timeline.json / metrics.json "
              f"/ health.json)", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(diag, indent=2, sort_keys=True))
    else:
        print(render_text(diag))
    oom = (diag.get("memory") or {}).get("oom")
    return 1 if (diag["hang"] or oom) else 0


if __name__ == "__main__":
    sys.exit(main())
