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

The perf-history ledger and ``diff_attribution`` are not ported.
"""

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
