"""Metrics registry of the port's serving box: counters, gauges,
histograms, rendered in the Prometheus text format.

Counterpart of ``sparkdl_tpu/observe/metrics.py``, copied (the port
imports nothing of the JAX package): ``Counter``, ``Gauge``,
``Histogram``, ``Registry`` (``snapshot``, ``to_prometheus``,
``to_json``), ``render_prometheus`` and ``ensure_build_info``. Thread-safe
by construction: every mutation is one short critical section over
plain Python numbers. The gang telemetry's merging
(``merge_snapshots``, ``snapshot_delta``) and ``render_json`` are not
ported yet.

``build_info`` carries the git sha, ``torch_version`` (in place of the
JAX package's ``jax_version``) and the device kind from
``torch.cuda.get_device_name``.
"""

import bisect
import json
import os
import subprocess
import threading
import time

# Latency-shaped default buckets (seconds): sub-millisecond through a
# minute.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, value=1):
        if value < 0:
            raise ValueError(f"counters only go up (inc({value}))")
        with self._lock:
            self._value += value

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (Prometheus ``gauge``)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``histogram``): one
    count per upper bound plus the implicit ``+Inf`` catch-all, a
    running sum, and a total count."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_count")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._uppers = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._uppers) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        value = float(value)
        idx = bisect.bisect_left(self._uppers, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def buckets(self):
        return self._uppers

    @property
    def counts(self):
        with self._lock:
            return list(self._counts)

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def count(self):
        with self._lock:
            return self._count


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Registry:
    """Get-or-create store of named metrics, keyed by (name, labels).

    A name is bound to ONE metric kind; asking for the same name as a
    different kind raises instead of silently shadowing (the exporter
    could not render both under one ``# TYPE`` header anyway).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}   # (name, label_key) -> metric object
        self._kinds = {}     # name -> "counter" | "gauge" | "histogram"
        self._hist_buckets = {}  # name -> upper bounds (pinned at first use)

    def _get(self, kind, name, labels, factory):
        key = (name, _label_key(labels))
        with self._lock:
            seen = self._kinds.get(name)
            if seen is not None and seen != kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {seen}, "
                    f"cannot re-register as a {kind}"
                )
            metric = self._metrics.get(key)
            if metric is None:
                metric = factory()
                self._metrics[key] = metric
                self._kinds[name] = kind
            return metric

    def counter(self, name, **labels):
        return self._get("counter", name, labels, Counter)

    def gauge(self, name, **labels):
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name, buckets=None, **labels):
        # Bucket layout is pinned per name so every labeled series of
        # one histogram aggregates (and renders) on the same bounds.
        with self._lock:
            bounds = self._hist_buckets.setdefault(
                name,
                tuple(sorted(float(b) for b in buckets))
                if buckets is not None else DEFAULT_BUCKETS,
            )
        return self._get(
            "histogram", name, labels, lambda: Histogram(bounds)
        )

    # -- export --------------------------------------------------------------

    def snapshot(self):
        """Cumulative JSON-able dump of every series (one snapshot
        supersedes the previous one from the same process)."""
        with self._lock:
            items = list(self._metrics.items())
            kinds = dict(self._kinds)
        snap = {"ts": time.time(), "counters": [], "gauges": [],
                "histograms": []}
        for (name, label_key), metric in items:
            labels = dict(label_key)
            kind = kinds[name]
            if kind == "counter":
                snap["counters"].append(
                    {"name": name, "labels": labels, "value": metric.value}
                )
            elif kind == "gauge":
                snap["gauges"].append(
                    {"name": name, "labels": labels, "value": metric.value}
                )
            else:
                snap["histograms"].append({
                    "name": name, "labels": labels,
                    "buckets": list(metric.buckets),
                    "counts": metric.counts,
                    "sum": metric.sum, "count": metric.count,
                })
        for k in ("counters", "gauges", "histograms"):
            snap[k].sort(key=lambda s: (s["name"], sorted(s["labels"].items())))
        return snap

    def to_prometheus(self):
        return render_prometheus([({}, self.snapshot())])

    def to_json(self, indent=None):
        """The registry as one JSON document, shaped like the JAX
        package's ``render_json`` of a single unlabeled snapshot."""
        doc = {"generated_at": time.time(),
               "series": [{"labels": {}, **self.snapshot()}]}
        return json.dumps(doc, indent=indent, sort_keys=True)


# -- build-info correlation ---------------------------------------------------
#
# Every export surface stamps a constant ``build_info{git_sha,
# torch_version,device_kind} 1`` gauge onto its registry before
# rendering, so scrapes join ledger lines on the git sha. Injection is
# explicit per surface, not inside ``snapshot()``.

_build_info_labels = None
_build_info_lock = threading.Lock()


def _git_sha():
    """Short HEAD sha of the checkout this package sits in, or None."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def build_info_labels():
    """Process-lifetime constant labels: the short git sha (``none``
    outside a checkout), the torch version and the first CUDA device's
    name (``none`` without one)."""
    global _build_info_labels
    with _build_info_lock:
        if _build_info_labels is None:
            import torch

            _build_info_labels = {
                "git_sha": _git_sha() or "none",
                "torch_version": torch.__version__,
                "device_kind": (torch.cuda.get_device_name(0)
                                if torch.cuda.is_available() else "none"),
            }
        return dict(_build_info_labels)


def ensure_build_info(registry):
    """Stamp the ``build_info`` gauge (value 1, labels from
    :func:`build_info_labels`) onto ``registry``; idempotent, cheap
    after the first call. Returns the labels."""
    labels = build_info_labels()
    registry.gauge("build_info", **labels).set(1)
    return labels


# -- rendering ------------------------------------------------------------------


def _esc(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_str(labels):
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_esc(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_num(v):
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(labeled_snapshots):
    """Prometheus text format over ``[(extra_labels, snapshot), ...]``
    — one ``# TYPE`` header per metric name, every series carrying its
    own labels plus the extras. Deterministic ordering so exports are
    golden-testable."""
    # name -> (kind, [(series_sort_key, [lines in emit order])])
    # Series sort by their labels; a histogram's bucket lines keep
    # ascending-``le`` order inside their series (the exposition
    # format expects cumulative buckets in increasing order).
    by_name = {}
    for extra, snap in labeled_snapshots:
        for kind, key in (("counter", "counters"), ("gauge", "gauges")):
            for s in snap.get(key, ()):
                labels = {**s["labels"], **extra}
                by_name.setdefault(s["name"], (kind, []))[1].append((
                    _label_key(labels),
                    [f"{s['name']}{_labels_str(labels)} "
                     f"{_fmt_num(s['value'])}"],
                ))
        for h in snap.get("histograms", ()):
            labels = {**h["labels"], **extra}
            lines = []
            cum = 0
            for upper, n in zip(h["buckets"], h["counts"]):
                cum += n
                lines.append(
                    f"{h['name']}_bucket"
                    f"{_labels_str({**labels, 'le': _fmt_num(upper)})} "
                    f"{cum}"
                )
            cum += h["counts"][len(h["buckets"])]
            lines.append(
                f"{h['name']}_bucket"
                f"{_labels_str({**labels, 'le': '+Inf'})} {cum}"
            )
            lines.append(
                f"{h['name']}_sum{_labels_str(labels)} "
                f"{_fmt_num(h['sum'])}"
            )
            lines.append(
                f"{h['name']}_count{_labels_str(labels)} {h['count']}"
            )
            by_name.setdefault(h["name"], ("histogram", []))[1].append(
                (_label_key(labels), lines)
            )
    out = []
    for name in sorted(by_name):
        kind, series = by_name[name]
        out.append(f"# TYPE {name} {kind}")
        for _, lines in sorted(series, key=lambda s: s[0]):
            out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")
