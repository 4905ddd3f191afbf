"""Memory accounting by category, a sampler, the heartbeat's memory field
and OOM forensics.

Counterpart of ``sparkdl_tpu/observe/mem.py``:

- **Categories**: long-lived state is registered once by category
  (``params``, ``opt_state``, ``kv_pages``, ...; :func:`register_tree`
  takes a tensor, a nest of them such as a state dict, a module, an
  optimizer, a byte count, or a callable that returns bytes). A module
  and an optimizer are sized at each sample (an optimizer's state
  appears at its first step). :func:`tree_nbytes` is ``numel *
  element_size`` over the distinct tensors.
- **Sampler**: a low-rate thread (every :data:`SAMPLE_S` seconds) sets
  ``mem_bytes{category=}`` and ``host_rss_bytes``, with the residual
  ``mem_bytes{category="unattributed"}`` (the card's allocated bytes
  less the categories), keeps a rolling tail, emits a ``mem.sample``
  instant (which the flight recorder keeps), and hands the latest sample
  to the heartbeat (:func:`beacon_sample`).
- **OOM forensics**: :func:`oom_guard` wraps a step or an admission; an
  allocation failure (``torch.cuda.OutOfMemoryError``, ``MemoryError``,
  the paged pool's dead end) writes ``oom_report.json`` with the JAX
  package's keys before the exception goes on.

The card's numbers come from ``torch.cuda.memory_stats`` of the card
that ``hvd.init()`` bound (allocated, reserved, peak;
:func:`sparkdl_tpu_torch.observe.health.device_memory_stats`): before
that, on a CPU rank and outside a gang, a sample carries none, and the
sampler thread makes no CUDA call. :func:`largest_buffers` cannot group
live arrays by (shape, dtype) as the JAX module does, since torch keeps
no list of live tensors: it reports the largest allocated blocks of
``torch.cuda.memory_snapshot()``, grouped by block size.

Everything is behind the telemetry switch: without it no thread starts,
nothing is registered and no report is written. :data:`SAMPLE_S` is a
module setting (the JAX package's ``SPARKDL_TPU_MEM_SAMPLE_S``);
:data:`TOP_BUFFERS` and :data:`SAMPLES` are constants (the defaults of
its other ``SPARKDL_TPU_MEM_*`` variables).
"""

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time

# seconds between samples (<= 0: no sampler thread)
SAMPLE_S = 2.0
# rows of the largest-block table
TOP_BUFFERS = 8
# samples kept in the rolling tail
SAMPLES = 64

CATEGORIES = ("params", "opt_state", "kv_pages", "compile_cache",
              "host_prefetch")

OOM_REPORT_SCHEMA = "sparkdl_tpu.observe.mem/oom_report/1"

# what an allocation failure says, beside its type
_OOM_MARKERS = ("out of memory", "Out of memory", "OOM",
                "RESOURCE_EXHAUSTED", "paged pool exhausted")

_lock = threading.Lock()
_trees = {}            # category -> int | callable() -> int
_samples = None        # deque of sample dicts (made at first use)
_latest = None         # the last sample
_host_rss_high = 0     # high-water of sampled VmRSS
_sampler = None
_sampler_stop = None
_job_dir = None        # a gang rank's job dir (the worker bootstrap's)


def set_job_dir(job_dir):
    """Where this process writes its OOM report (a gang rank's job dir,
    set by its bootstrap; None: the telemetry root)."""
    global _job_dir
    _job_dir = job_dir


# -- host RSS ------------------------------------------------------------------


def host_rss_bytes():
    """This process's resident set in bytes (``/proc/self/status``,
    else ``getrusage``'s high-water), or None."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def host_rss_high_water_bytes():
    """The high-water host RSS: the largest sampled VmRSS or the
    kernel's ``ru_maxrss``."""
    high = _host_rss_high
    try:
        import resource

        high = max(high, resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024)
    except Exception:
        pass
    return high or None


# -- categorized accounting ----------------------------------------------------


def _tensors(obj, seen):
    import torch

    if isinstance(obj, torch.Tensor):
        if id(obj) not in seen:
            seen.add(id(obj))
            yield obj
    elif isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            yield from _tensors(t, seen)
    elif isinstance(obj, torch.optim.Optimizer):
        for state in obj.state.values():
            yield from _tensors(state, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)


def tree_nbytes(tree):
    """Bytes of the distinct tensors of ``tree`` (a tensor, a nest of
    dicts, lists, tuples and dataclasses, a module's parameters and
    buffers, an optimizer's state): ``numel * element_size`` each."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree, set()))


def register_tree(category, tree):
    """Register long-lived state under ``category``: a module or an
    optimizer (sized at every sample), a callable returning bytes, a
    byte count, or a tensor nest (sized now). Registering a category
    again replaces it. Returns the bytes now; None with telemetry
    off."""
    import torch

    from sparkdl_tpu_torch import observe

    if not observe.enabled():
        return None
    if isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        sized = (lambda obj=tree: tree_nbytes(obj))
    elif callable(tree):
        sized = tree
    elif isinstance(tree, (int, float)):
        sized = int(tree)
    else:
        sized = tree_nbytes(tree)
    with _lock:
        _trees[str(category)] = sized
    return sized() if callable(sized) else sized


def clear_category(category):
    with _lock:
        _trees.pop(str(category), None)


def category_bytes():
    """``{category: bytes}`` now (a failing callable reports 0)."""
    with _lock:
        items = list(_trees.items())
    table = {}
    for cat, sized in items:
        if callable(sized):
            try:
                table[cat] = int(sized() or 0)
            except Exception:
                table[cat] = 0
        else:
            table[cat] = int(sized)
    return table


def largest_buffers(top_n=None):
    """The largest allocated blocks of the bound card's caching allocator
    (``torch.cuda.memory_snapshot()``), grouped by block size, largest
    first: ``[{"shape", "dtype", "count", "bytes", "block_bytes"}]`` with
    ``shape`` naming the block size and ``dtype`` the word ``block`` (torch
    keeps no list of live tensors to group by shape and dtype). Empty on
    the CPU or before the card is bound; never raises."""
    from sparkdl_tpu_torch.observe import health

    top_n = int(TOP_BUFFERS if top_n is None else top_n)
    dev = health.bound_card()
    if dev is None:
        return []
    try:
        import torch

        agg = collections.Counter()
        for seg in torch.cuda.memory_snapshot():
            if seg.get("device") != dev.index:
                continue
            for blk in seg.get("blocks", ()):
                if blk.get("state") == "active_allocated":
                    agg[int(blk["size"])] += 1
    except Exception:
        return []
    rows = [{"shape": f"{size} B", "dtype": "block", "count": n,
             "bytes": size * n, "block_bytes": size}
            for size, n in agg.items()]
    rows.sort(key=lambda r: r["bytes"], reverse=True)
    return rows[:top_n]


# -- sampling --------------------------------------------------------------------


def _samples_deque():
    global _samples
    if _samples is None:
        _samples = collections.deque(maxlen=max(4, int(SAMPLES)))
    return _samples


def sample_now():
    """One sample: the gauges, the rolling tail, the ``mem.sample``
    instant; returns it (None with telemetry off)."""
    global _latest, _host_rss_high
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.observe import health

    if not observe.enabled():
        return None
    rss = host_rss_bytes()
    stats = health.device_memory_stats()
    live = stats.get("bytes_in_use")
    cats = category_bytes()
    unattributed = None
    if live is not None:
        unattributed = max(0, int(live) - sum(cats.values()))
    sample = {
        "ts": time.time(),
        "rss": rss,
        "hbm": live,
        "peak": stats.get("peak_bytes_in_use"),
        "limit": stats.get("bytes_limit"),
        "live": live,
        "reserved": stats.get("bytes_reserved"),
        "categories": cats,
        "unattributed": unattributed,
    }
    with _lock:
        if rss:
            _host_rss_high = max(_host_rss_high, rss)
        _latest = sample
    _samples_deque().append(sample)
    if rss is not None:
        observe.set_gauge("host_rss_bytes", rss)
    for cat, nbytes in cats.items():
        observe.set_gauge("mem_bytes", nbytes, category=cat)
    if unattributed is not None:
        observe.set_gauge("mem_bytes", unattributed, category="unattributed")
    observe.instant("mem.sample", cat="mem", rss=rss, hbm=sample["hbm"],
                    unattributed=unattributed)
    return sample


def beacon_sample():
    """The latest sample, compact, for the heartbeat (``{}`` before the
    first)."""
    with _lock:
        sample = _latest
    if not sample:
        return {}
    out = {"rss": sample["rss"], "hbm": sample["hbm"],
           "unattributed": sample["unattributed"],
           "categories": sample["categories"]}
    return {k: v for k, v in out.items() if v is not None}


def sample_tail(n=16):
    return list(_samples_deque())[-n:]


def maybe_start_sampler(interval=None):
    """Start the sampler thread (every ``interval`` seconds, None:
    :data:`SAMPLE_S`) behind the switch: with telemetry off no thread
    exists. Idempotent; an interval <= 0 starts none. Takes one sample at
    once, so the next beat carries one."""
    global _sampler, _sampler_stop
    from sparkdl_tpu_torch import observe

    if not observe.enabled():
        return None
    if _sampler is not None and _sampler.is_alive():
        return _sampler
    interval = float(SAMPLE_S if interval is None else interval)
    if interval <= 0:
        return None
    _sampler_stop = stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            try:
                sample_now()
            except Exception:
                pass  # accounting never takes the worker down

    _sampler = threading.Thread(target=loop, name="sparkdl-torch-mem",
                                daemon=True)
    _sampler.start()
    try:
        sample_now()
    except Exception:
        pass
    return _sampler


def stop_sampler():
    global _sampler, _sampler_stop
    if _sampler_stop is not None:
        _sampler_stop.set()
    if _sampler is not None:
        _sampler.join(timeout=5.0)
    _sampler = None
    _sampler_stop = None


# -- OOM forensics -------------------------------------------------------------


def is_oom(exc):
    """True for an allocation failure: ``torch.cuda.OutOfMemoryError``,
    ``MemoryError``, or an error whose text names one."""
    import torch

    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(marker in text for marker in _OOM_MARKERS)


def _hints(phase, sample):
    hints = []
    if phase == "admission":
        hints.append(
            "KV pool exhausted: raise the engine's n_pages (or lower "
            "max_new_tokens / concurrent sequences); int8 or int4 weights "
            "free card memory for more pages.")
    else:
        hints.append(
            "The step's peak holds the weights, the optimizer state, the "
            "activations kept for the backward and the gradients: "
            "make_train_step(remat=True) or a smaller batch lowers it.")
        hints.append(
            "Fragmentation: torch.cuda.memory_stats()'s reserved bytes far "
            "above the allocated ones; expandable_segments in "
            "PYTORCH_CUDA_ALLOC_CONF reduces it.")
    unattributed = (sample or {}).get("unattributed")
    attributed = sum(((sample or {}).get("categories") or {}).values())
    if unattributed and unattributed > max(attributed, 1):
        hints.append(
            "Most allocated bytes are unattributed (outside every "
            "registered category): a leak candidate; diff consecutive "
            "mem.sample instants and the largest-block table.")
    return hints


def oom_report_path(out_dir, rank=None):
    """``oom_report.json`` in ``out_dir``, rank-suffixed when the plain
    name is taken."""
    base = os.path.join(out_dir, "oom_report.json")
    if rank is None or not os.path.exists(base):
        return base
    return os.path.join(out_dir, f"oom_report-rank-{rank}.json")


def write_oom_report(phase, error, run_dir=None, extra=None):
    """Write ``oom_report.json`` (the JAX package's keys) into
    ``run_dir``, else this rank's job dir, else the telemetry root;
    returns its path, or None with telemetry off or nowhere to write.
    Never raises: it runs inside a handler that raises the real
    error."""
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.hvd import _state

    if not observe.enabled():
        return None
    out_dir = run_dir or _job_dir or observe.telemetry_dir()
    if not out_dir:
        return None
    try:
        sample = sample_now() or (_latest or {})
    except Exception:
        sample = _latest or {}
    st = _state.state()
    rank = st.rank if st.initialized else None
    report = {
        "schema": OOM_REPORT_SCHEMA,
        "ts": time.time(),
        "phase": phase,
        "rank": rank,
        "error": str(error)[:4000],
        "host_rss_bytes": sample.get("rss"),
        "host_rss_high_water_bytes": host_rss_high_water_bytes(),
        "device": {k: sample.get(k) for k in ("hbm", "peak", "limit",
                                              "live")},
        "categories": sample.get("categories") or category_bytes(),
        "unattributed": sample.get("unattributed"),
        "largest_buffers": largest_buffers(),
        # no lowering gives the port a static budget
        "static_budget_bytes": None,
        "sample_tail": sample_tail(),
        "hints": _hints(phase, sample),
    }
    if extra:
        report["extra"] = extra
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = oom_report_path(out_dir, rank=rank)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, default=str)
        os.replace(tmp, path)
    except OSError:
        return None
    try:
        observe.instant("mem.oom", cat="mem", phase=phase,
                        error=str(error)[:200])
        observe.inc("oom_reports_total", phase=phase)
        observe.flush()    # the process is probably about to die
    except Exception:
        pass
    return path


@contextlib.contextmanager
def oom_guard(phase="step", run_dir=None, extra=None):
    """An allocation failure inside the block writes ``oom_report.json``
    before it goes on; any other exception passes untouched."""
    try:
        yield
    except BaseException as e:
        from sparkdl_tpu_torch import observe

        if observe.enabled() and is_oom(e):
            write_oom_report(phase, e, run_dir=run_dir, extra=extra)
        raise


def _reset_for_tests():
    global _trees, _samples, _latest, _host_rss_high
    stop_sampler()
    with _lock:
        _trees = {}
        _latest = None
        _host_rss_high = 0
    _samples = None
