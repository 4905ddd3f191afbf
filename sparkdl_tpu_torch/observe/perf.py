"""Step-time attribution and roofline/MFU accounting.

Counterpart of ``sparkdl_tpu/observe/perf.py``, its attribution and
roofline half:

1. **Attribution** (:func:`attribution_report`): a per-step wall-time
   breakdown (``compute`` / ``collective`` / ``host_callback`` /
   ``data_wait`` / ``checkpoint``) from the spans the timeline carries
   (``instrument_step``'s step spans, the ``hvd`` collectives' spans,
   the checkpointer's), by interval arithmetic over event dicts: the
   JAX package's code, so both attribute one event list alike and
   ``perf.json`` keeps the schema ``sparkdl_tpu.perf.breakdown/1``. A
   collective span on the step's thread is serialized collective time;
   one on another thread, overlapped with compute. An NCCL collective's
   span is its enqueue (as a dispatched XLA collective is in the JAX
   package): its wire time falls inside the step's device time, which
   ``instrument_step`` waits for, and so reads as compute.

2. **Roofline/MFU** (:func:`register_step_cost`, :func:`note_step`):
   achieved FLOP/s and bytes/s of each executed step, and ``mfu`` and
   ``membw_util`` against one peak table.

Three differences from the JAX module (each a stated difference of the
port):

- :data:`PEAK_TABLE` holds the H100's own numbers (public H100 SXM
  figures: 989e12 dense bf16 FLOP/s, 3.35e12 HBM bytes/s, 900e9 NVLink
  bytes/s) and the JAX package's ``cpu`` proxy row, and no TPU row. An
  unknown card gets no MFU gauge; it never borrows another card's peak.
  :func:`device_kind` is the name of the card that ``hvd.init()`` bound
  (the process's current card otherwise), and :func:`hbm_capacity_bytes`
  that card's total memory.
- There is no lowering to read a cost from: :func:`register_step_cost`
  takes the caller's analytic count (``flops=``, ``bytes_accessed=``).
- No environment variable overrides a peak.

3. **Differential attribution** (:func:`diff_attribution`,
   :func:`render_diff_lines`): why steps got slower between two windows,
   component by component, with the grown span names: the JAX package's
   code, schema ``sparkdl_tpu.perf.regression/1``.

4. **Regression ledger** (:func:`history_record`, :func:`append_history`,
   :func:`read_history`): one schema-versioned JSON line a record, the
   JAX package's format byte for byte, so each package reads the other's
   ledger. Its path is the module setting :data:`HISTORY_PATH`, read at
   call time; None (the default) is no ledger: :func:`append_history`
   writes only where it is given a ``path``, and :func:`read_history`
   returns ``[]``. The JAX module defaults to its package's
   ``benchmarks/results/history.jsonl``; the port never writes there.
"""

import json
import os
import socket
import time

BREAKDOWN_SCHEMA = "sparkdl_tpu.perf.breakdown/1"

# Wall-time categories the attribution understands, in render order.
# ``compute`` is the remainder of the step span not covered by any
# instrumented wait on the step thread.
COMPONENTS = ("compute", "collective", "host_callback", "data_wait",
              "checkpoint")

# timeline span cat -> breakdown component
_CAT_TO_COMPONENT = {
    "collective": "collective",
    "host": "host_callback",
    "data": "data_wait",
    "checkpoint": "checkpoint",
}

# Dense bf16 peak FLOP/s, HBM bytes/s and interconnect bytes/s of one
# card, by normalized device kind. ``cpu`` is the JAX package's nominal
# proxy row: a CPU has no honest peak, but a stable denominator keeps
# the proxy MFU moving only when the code does.
PEAK_TABLE = {
    "h100": (989e12, 3.35e12, 900e9),
    "cpu": (1e12, 2e11, 1e10),
}


def normalize_device_kind(kind):
    """Map a device name (``"NVIDIA H100 80GB HBM3"``, ``"cpu"``) onto
    a :data:`PEAK_TABLE` key, or None for a kind the table lacks. The
    ``h100`` row is the SXM card's (HBM3): an H100 PCIe or NVL has other
    peaks and gets None."""
    k = (kind or "").lower()
    if "h100" in k:
        sxm = ("hbm3" in k or "sxm" in k) and not (
            "pcie" in k or "nvl" in k)
        return "h100" if sxm else None
    if "cpu" in k:
        return "cpu"
    return None


def _card():
    """The card this process computes on: the one ``hvd.init()`` bound,
    else the current card of a process whose CUDA context exists; None
    otherwise (asking would create a context)."""
    import torch

    from sparkdl_tpu_torch.hvd import _state

    dev = _state.state().device
    if dev is not None:
        return dev if dev.type == "cuda" else None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def device_kind():
    """The name of this process's card (:func:`_card`), or ``"cpu"``."""
    import torch

    dev = _card()
    if dev is None:
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _row(kind):
    return PEAK_TABLE.get(normalize_device_kind(
        kind if kind is not None else device_kind()))


def peak_flops(kind=None):
    """Peak FLOP/s of ``kind`` (a device name; default this process's
    card), or None for a kind the table lacks."""
    row = _row(kind)
    return row[0] if row else None


def peak_bytes_per_sec(kind=None):
    """Peak memory bytes/s of ``kind``, as :func:`peak_flops`."""
    row = _row(kind)
    return row[1] if row else None


def peak_interconnect_bytes_per_sec(kind=None):
    """Peak interconnect bytes/s of one card of ``kind`` (NVLink on the
    H100), as :func:`peak_flops`."""
    row = _row(kind)
    return row[2] if row else None


def hbm_capacity_bytes(kind=None):
    """The total memory of this process's card when ``kind`` (default
    its own) names a card, from ``torch.cuda.get_device_properties``;
    None on the CPU or without a card."""
    import torch

    norm = normalize_device_kind(kind if kind is not None
                                 else device_kind())
    dev = _card()
    if norm in (None, "cpu") or dev is None:
        return None
    return torch.cuda.get_device_properties(dev).total_memory


# -- step-time attribution ---------------------------------------------------


def _union(intervals):
    """Merge ``[(lo, hi), ...]`` into disjoint intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _measure(intervals):
    return sum(hi - lo for lo, hi in intervals)


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def _intersect(a, b):
    """Intersection of two DISJOINT-SORTED interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a, b):
    """Interval list ``a`` minus union-list ``b`` (both disjoint
    sorted)."""
    out = []
    for lo, hi in a:
        cur = lo
        for blo, bhi in b:
            if bhi <= cur or blo >= hi:
                continue
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def step_breakdown(events, step_cat="train"):
    """Per-step wall-time attribution over raw timeline events (the
    merged-trace or drained-worker event dicts; ``ts``/``dur`` integer
    microseconds).

    Returns one dict per *execute-phase* step span (``cat ==
    step_cat``, ``ph == "X"``; the ``phase="compile"`` first-call span
    is excluded — compile wall time is not compute) in timestamp
    order::

        {"step": int|None, "ts": µs, "dur_s": float,
         "components": {compute, collective, host_callback,
                        data_wait, checkpoint},   # step-thread seconds
         "overlapped_collective_s": float,        # concurrent, extra
         "collective_total_s": float,
         "overlap_efficiency": float|None}

    Attribution rules:

    - A categorized span **on the step span's thread** is time the
      step thread was blocked in that wait; per-category time is the
      *union measure* of its intervals clipped to the step window, so
      nested spans (``allgather`` calling ``reduce``) never double
      count. ``compute`` is the uncovered remainder — components sum
      to the step duration by construction.
    - A **collective span on another thread** overlapping the step
      window is an async collective. The portion of it during which
      the step thread was computing (not inside any same-thread wait)
      is ``overlapped_collective_s`` — concurrent time, reported next
      to (not inside) the wall-time components.
    - ``overlap_efficiency`` = overlapped / (overlapped + serialized)
      collective time; ``None`` when the step ran no collectives.
    """
    steps = [e for e in events
             if e.get("ph") == "X" and e.get("cat") == step_cat
             and isinstance(e.get("ts"), (int, float))
             # the first call's span (instrument_step phase="compile")
             # carries one-time warm-up (autotuning, allocator growth,
             # kernel builds): not compute
             and (e.get("args") or {}).get("phase") != "compile"]
    cats = {}
    for e in events:
        comp = _CAT_TO_COMPONENT.get(e.get("cat"))
        if comp is None or e.get("ph") != "X":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        dur = e.get("dur", 0) or 0
        cats.setdefault(comp, []).append(
            (float(ts), float(ts) + float(dur), e.get("tid")))
    out = []
    for step in sorted(steps, key=lambda e: e["ts"]):
        lo = float(step["ts"])
        hi = lo + float(step.get("dur", 0) or 0)
        tid = step.get("tid")
        dur_s = (hi - lo) / 1e6
        components = {c: 0.0 for c in COMPONENTS}
        blocked = []
        async_collective = []
        for comp, spans in cats.items():
            same = _union(_clip(
                [(a, b) for a, b, t in spans if t == tid], lo, hi))
            components[comp] = _measure(same) / 1e6
            blocked.extend(same)
            if comp == "collective":
                async_collective = _union(_clip(
                    [(a, b) for a, b, t in spans if t != tid], lo, hi))
        blocked = _union(blocked)
        compute_iv = _subtract([(lo, hi)], blocked)
        components["compute"] = _measure(compute_iv) / 1e6
        overlapped = _measure(_intersect(async_collective, compute_iv)) / 1e6
        serialized = components["collective"]
        total_coll = serialized + _measure(async_collective) / 1e6
        eff = None
        if total_coll > 0:
            eff = overlapped / total_coll
        out.append({
            "step": step.get("args", {}).get("step"),
            "ts": step["ts"],
            "dur_s": dur_s,
            "components": components,
            "overlapped_collective_s": overlapped,
            "collective_total_s": total_coll,
            "overlap_efficiency": eff,
        })
    return out


def make_breakdown(total_s, components, *, source, extra=None):
    """The one breakdown document shape (``BREAKDOWN_SCHEMA``) shared
    by the telemetry-derived attribution and the hand-rolled
    ``benchmarks/step_breakdown.py`` decomposition, so the two are
    cross-checkable in one file format. ``components`` maps name →
    seconds; fractions are derived here."""
    total_s = float(total_s)
    doc = {
        "schema": BREAKDOWN_SCHEMA,
        "source": source,
        "total_s": total_s,
        "components": {k: float(v) for k, v in components.items()},
        "fractions": {
            k: (float(v) / total_s if total_s > 0 else None)
            for k, v in components.items()
        },
    }
    if extra:
        doc.update(extra)
    return doc


def attribution_report(events, step_cat="train"):
    """Aggregate :func:`step_breakdown` over one process's events into
    the ``perf.json`` / doctor document: summed components (a
    :func:`make_breakdown` doc), overall overlap efficiency, the
    per-step rows, and ``inter_step_data_wait_s``. Zero instrumented
    steps → ``{"steps": 0}`` so callers can skip rendering.

    ``inter_step_data_wait_s`` is the data-wait time that fell
    BETWEEN step windows: in the canonical ``for batch in
    prefetch_to_device(...): stepped(batch)`` pattern the refill (and
    its ``data.wait`` span) runs when the for-loop advances the
    iterator, strictly between the step spans — so a starved input
    pipeline shows up here, not in the per-step ``data_wait``
    component (which only catches iterators consumed *inside* the
    step function). Outside-the-window time, reported next to — not
    inside — the sum-to-step-duration components, like the overlapped
    collective time."""
    rows = step_breakdown(events, step_cat=step_cat)
    if not rows:
        return {"steps": 0}
    totals = {c: 0.0 for c in COMPONENTS}
    for r in rows:
        for c, v in r["components"].items():
            totals[c] += v
    total_s = sum(r["dur_s"] for r in rows)
    overlapped = sum(r["overlapped_collective_s"] for r in rows)
    coll_total = sum(r["collective_total_s"] for r in rows)
    step_windows = _union([
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0) or 0))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == step_cat
        and isinstance(e.get("ts"), (int, float))])
    data_spans = _union([
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0) or 0))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "data"
        and isinstance(e.get("ts"), (int, float))])
    inter_step_wait = _measure(_subtract(data_spans, step_windows)) / 1e6
    doc = make_breakdown(total_s, totals, source="timeline")
    doc.update({
        "steps": len(rows),
        "overlapped_collective_s": overlapped,
        "collective_total_s": coll_total,
        "overlap_efficiency": (overlapped / coll_total
                               if coll_total > 0 else None),
        "inter_step_data_wait_s": inter_step_wait,
        "per_step": rows,
    })
    return doc


# -- differential attribution (perf forensics) -------------------------------

REGRESSION_SCHEMA = "sparkdl_tpu.perf.regression/1"


def _report_from_rows(rows):
    """An :func:`attribution_report`-shaped doc aggregated from
    precomputed per-step rows (the capped-rows fallback: when only
    ``perf.json``'s ``per_step`` survive, the diff still runs — it
    just cannot name grown span names)."""
    totals = {c: 0.0 for c in COMPONENTS}
    for r in rows:
        for c, v in (r.get("components") or {}).items():
            if c in totals and isinstance(v, (int, float)):
                totals[c] += float(v)
    total_s = sum(float(r.get("dur_s") or 0.0) for r in rows)
    overlapped = sum(float(r.get("overlapped_collective_s") or 0.0)
                     for r in rows)
    coll = sum(float(r.get("collective_total_s") or 0.0) for r in rows)
    doc = make_breakdown(total_s, totals, source="rows")
    doc.update({
        "steps": len(rows),
        "overlapped_collective_s": overlapped,
        "collective_total_s": coll,
        "overlap_efficiency": (overlapped / coll if coll > 0 else None),
        "per_step": list(rows),
    })
    return doc


def _window_report(window, step_cat="train"):
    """Normalize one diff side into ``(attribution doc, raw events)``.

    Accepts — in order of forensic fidelity — a raw timeline event
    list (→ :func:`attribution_report`, span names available), a list
    of precomputed per-step rows (``components``/``dur_s`` dicts), or
    an already-built attribution/breakdown doc. ``(None, None)`` when
    the window carries nothing attributable."""
    if isinstance(window, dict):
        if "events" in window and isinstance(window["events"],
                                             (list, tuple)):
            events = list(window["events"])
            doc = attribution_report(events, step_cat=step_cat)
            if window.get("mfu") is not None and "mfu" not in doc:
                doc["mfu"] = window["mfu"]
            return (doc if doc.get("steps") else None,
                    events if doc.get("steps") else None)
        if "components" in window or "per_step" in window:
            return (window if window.get("steps") else None), None
        return None, None
    if isinstance(window, (list, tuple)):
        items = [w for w in window if isinstance(w, dict)]
        if not items:
            return None, None
        if all("components" in w and "dur_s" in w for w in items):
            return _report_from_rows(items), None
        doc = attribution_report(items, step_cat=step_cat)
        if not doc.get("steps"):
            return None, None
        return doc, items
    return None, None


def _per_step_components(doc):
    """Mean step-thread seconds per step for every component."""
    steps = doc.get("steps") or 0
    comps = doc.get("components") or {}
    if not steps:
        return {c: 0.0 for c in COMPONENTS}
    return {c: float(comps.get(c, 0.0) or 0.0) / steps
            for c in COMPONENTS}


def _span_seconds_per_step(events, steps, step_cat="train"):
    """Per-step seconds by span name over raw events (non-step X
    spans) — the grown-span-names half of the diff."""
    if not events or not steps:
        return {}
    by_name = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") == step_cat:
            continue
        name = e.get("name")
        ts = e.get("ts")
        if not name or not isinstance(ts, (int, float)):
            continue
        dur = float(e.get("dur", 0) or 0) / 1e6
        by_name[name] = by_name.get(name, 0.0) + dur
    return {n: s / steps for n, s in by_name.items()}


def _window_summary(doc):
    steps = doc.get("steps") or 0
    total_s = float(doc.get("total_s") or 0.0)
    return {
        "steps": steps,
        "step_s_mean": (total_s / steps if steps else None),
        "components_per_step": _per_step_components(doc),
        "overlap_efficiency": doc.get("overlap_efficiency"),
        "mfu": doc.get("mfu"),
        "inter_step_data_wait_s": doc.get("inter_step_data_wait_s"),
    }


def diff_attribution(baseline_window, regressed_window, *,
                     step_cat="train", noise_floor_s=1e-3,
                     rel_floor=0.05, top_spans=5):
    """Differential step attribution: WHY did steps get slower between
    two windows (the alert rule's own calibration window vs the window
    that fired)?

    Each window may be a raw timeline event list, a list of per-step
    attribution rows, or an :func:`attribution_report` doc — the
    capped-rows fallback means a 200-row ``perf.json`` still diffs,
    it just cannot name grown spans. Returns a
    :data:`REGRESSION_SCHEMA` doc::

        {"schema", "baseline": {...}, "regressed": {...},
         "delta": {"step_s", "step_factor", "components_per_step",
                   "overlap_efficiency", "mfu"},
         "top_growing_component": name|None,   # None = under the floor
         "growth_fraction": {...},  # share of step growth, grown comps
         "top_growing_spans": [{"name", "baseline_s_per_step",
                                "regressed_s_per_step", "delta_s"}],
         "significant": bool, "noise_floor_s": float}

    or ``None`` when either side has no attributable steps. The noise
    floor — ``max(noise_floor_s, rel_floor × baseline step time)`` —
    keeps run-to-run jitter from being named a grown component: a
    zero-delta pair reports ``significant: False`` and no culprit.
    """
    base_doc, base_events = _window_report(baseline_window,
                                           step_cat=step_cat)
    reg_doc, reg_events = _window_report(regressed_window,
                                         step_cat=step_cat)
    if base_doc is None or reg_doc is None:
        return None
    base = _window_summary(base_doc)
    reg = _window_summary(reg_doc)
    step_delta = reg["step_s_mean"] - base["step_s_mean"]
    floor = max(float(noise_floor_s), rel_floor * base["step_s_mean"])
    comp_delta = {
        c: reg["components_per_step"][c] - base["components_per_step"][c]
        for c in COMPONENTS
    }
    grown = {c: d for c, d in comp_delta.items() if d > floor}
    significant = step_delta > floor and bool(grown)
    top_component = (max(grown, key=grown.get) if significant else None)
    growth_fraction = {}
    if significant and step_delta > 0:
        growth_fraction = {c: d / step_delta for c, d in grown.items()}
    eff_delta = None
    if isinstance(base.get("overlap_efficiency"), (int, float)) and \
            isinstance(reg.get("overlap_efficiency"), (int, float)):
        eff_delta = (reg["overlap_efficiency"]
                     - base["overlap_efficiency"])
    mfu_delta = None
    if isinstance(base.get("mfu"), (int, float)) and \
            isinstance(reg.get("mfu"), (int, float)):
        mfu_delta = reg["mfu"] - base["mfu"]
    spans = []
    if base_events is not None and reg_events is not None:
        base_spans = _span_seconds_per_step(
            base_events, base["steps"], step_cat=step_cat)
        reg_spans = _span_seconds_per_step(
            reg_events, reg["steps"], step_cat=step_cat)
        for name in set(base_spans) | set(reg_spans):
            d = reg_spans.get(name, 0.0) - base_spans.get(name, 0.0)
            if d > floor:
                spans.append({
                    "name": name,
                    "baseline_s_per_step": base_spans.get(name, 0.0),
                    "regressed_s_per_step": reg_spans.get(name, 0.0),
                    "delta_s": d,
                })
        spans.sort(key=lambda s: -s["delta_s"])
        spans = spans[:top_spans]
    return {
        "schema": REGRESSION_SCHEMA,
        "baseline": base,
        "regressed": reg,
        "delta": {
            "step_s": step_delta,
            "step_factor": (reg["step_s_mean"] / base["step_s_mean"]
                            if base["step_s_mean"] else None),
            "components_per_step": comp_delta,
            "overlap_efficiency": eff_delta,
            "mfu": mfu_delta,
        },
        "top_growing_component": top_component,
        "growth_fraction": growth_fraction,
        "top_growing_spans": spans,
        "significant": significant,
        "noise_floor_s": floor,
    }


def render_diff_lines(diff, indent=""):
    """Human-readable lines for one :func:`diff_attribution` doc — the
    SHARED renderer doctor, ``observe.compare --explain`` and the
    forensics report all use, so the three surfaces read alike."""
    if not diff:
        return []
    base, reg = diff["baseline"], diff["regressed"]
    d = diff["delta"]
    lines = [
        "%sstep time: %.4fs -> %.4fs (x%.2f, %+.4fs) over %d vs %d "
        "step(s)" % (
            indent, base["step_s_mean"], reg["step_s_mean"],
            d["step_factor"] or 0.0, d["step_s"],
            base["steps"], reg["steps"]),
    ]
    for c in COMPONENTS:
        delta = d["components_per_step"].get(c, 0.0)
        marker = ""
        if c == diff.get("top_growing_component"):
            marker = "  <-- grew the most"
        lines.append(
            "%s  %-13s %.4fs/step -> %.4fs/step (%+.4fs)%s" % (
                indent, c, base["components_per_step"].get(c, 0.0),
                reg["components_per_step"].get(c, 0.0), delta, marker))
    if d.get("overlap_efficiency") is not None:
        lines.append("%s  overlap efficiency %+.1f%%" % (
            indent, d["overlap_efficiency"] * 100))
    if d.get("mfu") is not None:
        lines.append("%s  mfu %+.4f" % (indent, d["mfu"]))
    for s in diff.get("top_growing_spans") or ():
        lines.append(
            "%s  span %-24s %+0.4fs/step (%.4fs -> %.4fs)" % (
                indent, s["name"], s["delta_s"],
                s["baseline_s_per_step"], s["regressed_s_per_step"]))
    if not diff.get("significant"):
        lines.append(
            "%s  (delta under the %.4fs noise floor — no component "
            "named)" % (indent, diff["noise_floor_s"]))
    return lines


# -- roofline / MFU gauges ---------------------------------------------------

# name -> {"flops", "bytes_accessed", "device_kind", "peak_flops",
# "peak_bytes"}; written only with telemetry on
_step_costs = {}


def register_step_cost(name, flops=None, bytes_accessed=None):
    """Record one step function's analytic cost (FLOPs and bytes moved
    a call, the caller's count) so that every later :func:`note_step`
    of ``name`` turns its wall time into achieved rates and MFU. The
    device kind and its peaks are resolved once, here. No-op (None) with
    telemetry off or without a cost."""
    from sparkdl_tpu_torch import observe

    if not observe.enabled():
        return None
    entry = {"flops": flops, "bytes_accessed": bytes_accessed}
    if not any(v for v in entry.values()):
        return None
    kind = device_kind()
    entry["device_kind"] = normalize_device_kind(kind)
    entry["peak_flops"] = peak_flops(kind)
    entry["peak_bytes"] = peak_bytes_per_sec(kind)
    _step_costs[name] = entry
    if flops:
        observe.set_gauge("step_cost_flops", flops, fn=name)
    if bytes_accessed:
        observe.set_gauge("step_cost_bytes", bytes_accessed, fn=name)
        if flops:
            observe.set_gauge("step_operational_intensity",
                              flops / bytes_accessed, fn=name)
    return entry


def note_step(name, seconds):
    """Fold one executed step's wall time into the achieved-rate gauges
    and, against a known peak, ``mfu`` and ``membw_util`` (called by
    ``instrument_step`` behind the switch). Silent when no cost was
    registered for ``name``."""
    from sparkdl_tpu_torch import observe

    entry = _step_costs.get(name)
    if not entry or seconds <= 0:
        return
    norm = entry["device_kind"]
    flops, nbytes = entry.get("flops"), entry.get("bytes_accessed")
    if flops:
        achieved = flops / seconds
        observe.set_gauge("achieved_flops_per_sec", achieved, fn=name)
        if entry["peak_flops"]:
            observe.set_gauge("mfu", achieved / entry["peak_flops"],
                              fn=name, device_kind=norm)
    if nbytes:
        achieved_b = nbytes / seconds
        observe.set_gauge("achieved_bytes_per_sec", achieved_b, fn=name)
        if entry["peak_bytes"]:
            observe.set_gauge("membw_util", achieved_b / entry["peak_bytes"],
                              fn=name, device_kind=norm)


def _reset_for_tests():
    _step_costs.clear()


# -- regression ledger -------------------------------------------------------

HISTORY_SCHEMA = 1
# the ledger's path, read at call time (None: no ledger)
HISTORY_PATH = None


def default_history_path():
    """:data:`HISTORY_PATH` as it stands (None: no ledger)."""
    return HISTORY_PATH


def host_fingerprint():
    """Stable who-measured-this string: comparisons across different
    fingerprints are apples-to-oranges and the compare CLI says so."""
    import platform as _platform

    return "%s/%s/cpu%s" % (
        socket.gethostname(), _platform.machine(), os.cpu_count() or 0)


def git_sha():
    """Short HEAD sha of the checkout this package sits in, or None."""
    from sparkdl_tpu_torch.observe.metrics import _git_sha

    return _git_sha()


def _percentile(samples, q):
    """np.percentile's default linear interpolation, without the
    numpy import this artifact-side module avoids."""
    xs = sorted(float(s) for s in samples)
    if not xs:
        return None
    k = (len(xs) - 1) * q / 100.0
    f, c = int(k), min(int(k) + 1, len(xs) - 1)
    return xs[f] + (xs[c] - xs[f]) * (k - f)


def sample_metric(samples, *, unit, higher_is_better=False, digits=4):
    """ONE ledger metric dict from raw per-rep samples (already in the
    target unit): ``value`` = p50, with ``p99`` and the samples
    preserved so :mod:`sparkdl_tpu_torch.observe.compare`'s median/IQR noise
    protection applies. The single definition of the shape
    :func:`history_record` documents — benchmarks must not hand-roll
    copies of it."""
    if not samples:
        raise ValueError("sample_metric needs at least one sample")
    p50 = round(_percentile(samples, 50), digits)
    return {
        "value": p50, "p50": p50,
        "p99": round(_percentile(samples, 99), digits),
        "samples": [round(float(s), digits) for s in samples],
        "unit": unit, "higher_is_better": higher_is_better,
    }


def history_record(metrics, *, device_kind=None, bench=None, extra=None):
    """One schema-versioned ledger line. ``metrics`` maps name →
    ``{"value": float, "unit": str, "samples": [...]?, "p50"?,
    "p99"?, "higher_is_better"?: bool}`` (plain numbers are wrapped).
    """
    norm = {}
    for name, m in metrics.items():
        if not isinstance(m, dict):
            m = {"value": m}
        if m.get("value") is None:
            continue
        norm[name] = {k: v for k, v in m.items() if v is not None}
    rec = {
        "schema": HISTORY_SCHEMA,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
        "host": host_fingerprint(),
        "device_kind": device_kind,
        "bench": bench,
        "metrics": norm,
    }
    if extra:
        rec.update(extra)
    return rec


def append_history(record, path=None):
    """Append one record as a JSON line (creating parents) to ``path``,
    else to :data:`HISTORY_PATH`; nothing when both are None. Best
    effort and silent on failure: the ledger must never fail the run
    that feeds it. Returns the path written, or None."""
    path = path or HISTORY_PATH
    if not path:
        return None
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
        return path
    except Exception:
        return None


def read_history(path=None):
    """Parsed ledger entries of ``path`` (else :data:`HISTORY_PATH`),
    skipping unparsable lines, oldest first; ``[]`` for a missing file
    or no ledger at all."""
    path = path or HISTORY_PATH
    if not path:
        return []
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out
