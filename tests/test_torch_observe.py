"""The port's telemetry facade and its artifact formats against the JAX
package's on the same inputs: metric merging and rendering, the Chrome
timeline, step attribution and MFU on the ``cpu`` peak row, the flight
recorder's ring read across packages, memory accounting and the OOM
report; and the switch: with ``observe.TELEMETRY_DIR`` None an
instrumented step, a collective, a checkpoint save and a served request
call nothing of the facade and start no thread.

The JAX side is switched on as its own tests do it
(``SPARKDL_TPU_TELEMETRY_DIR`` and its ``_reset_for_tests``); the port
by its module setting."""

import importlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sparkdl_tpu import observe as jobs
from sparkdl_tpu.observe import flightrec as jflightrec
from sparkdl_tpu.observe import mem as jmem
from sparkdl_tpu.observe import perf as jperf
from sparkdl_tpu.observe.timeline import Timeline as JTimeline
from sparkdl_tpu.observe.timeline import chrome_trace as jchrome_trace
from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.hvd import _collectives
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.models.server import ServingFrontend
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.observe import flightrec, mem, perf
from sparkdl_tpu_torch.observe.timeline import Timeline, chrome_trace
from sparkdl_tpu_torch.parallel import train as pt_train
from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

torch.set_num_threads(2)

# the modules by name: each package's ``metrics`` is its registry getter
pmetrics = importlib.import_module("sparkdl_tpu_torch.observe.metrics")
jmetrics = importlib.import_module("sparkdl_tpu.observe.metrics")

TELEMETRY_THREADS = ("sparkdl-torch-flush", "sparkdl-torch-heartbeat",
                     "sparkdl-torch-mem", "sparkdl-torch-serving-write")


@pytest.fixture
def port_on(tmp_path, monkeypatch):
    """The port's switch on (a module setting), fresh state."""
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "port"))
    observe._reset_for_tests()
    yield tmp_path / "port"
    observe._reset_for_tests()


@pytest.fixture
def jax_on(tmp_path, monkeypatch):
    """The JAX package's switch on, as its own tests set it."""
    monkeypatch.setenv(jobs.TELEMETRY_DIR_ENV, str(tmp_path / "jax"))
    jobs._reset_for_tests()
    yield tmp_path / "jax"
    monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV)
    jobs._reset_for_tests()


def _tiny_cfg(**kw):
    return pt_llama.LlamaConfig.tiny(d_model=256, vocab_size=512,
                                     n_heads=4, n_kv_heads=2, d_ff=512,
                                     dtype=torch.float32, **kw)


# -- metrics -------------------------------------------------------------------


def _fill(reg, scale):
    reg.counter("collective_ops_total", op="reduce").inc(3 * scale)
    reg.counter("collective_ops_total", op="allgather").inc(scale)
    reg.counter("gang_failures_total", verdict="transient").inc()
    reg.gauge("worker_step").set(7 * scale)
    reg.gauge("mem_bytes", category="params").set(1024 * scale)
    h = reg.histogram("train_step_seconds", phase="execute")
    for v in (0.002, 0.03, 0.4 * scale, 7.0):
        h.observe(v)
    reg.histogram("engine_batch_utilization",
                  buckets=tuple(i / 4 for i in range(1, 5))).observe(
                      0.5 / scale)
    return reg


def _snapshots(mod, stamp):
    a = _fill(mod.Registry(), 1).snapshot()
    b = _fill(mod.Registry(), 2).snapshot()
    a["ts"], b["ts"] = stamp, stamp + 1.0
    return a, b


def _strip_time(doc):
    doc = json.loads(doc)
    doc.pop("generated_at")
    return doc


@pytest.mark.parametrize("what", ["snapshot", "merge", "delta",
                                  "prometheus", "json"])
def test_metrics_merge_and_render_like_jax(what):
    pa, pb = _snapshots(pmetrics, 100.0)
    ja, jb = _snapshots(jmetrics, 100.0)
    assert (pa, pb) == (ja, jb)  # the registries' snapshots: one shape
    if what == "merge":
        assert (pmetrics.merge_snapshots([pb, pa])
                == jmetrics.merge_snapshots([jb, ja]))
    elif what == "delta":
        assert (pmetrics.snapshot_delta(pa, pb)
                == jmetrics.snapshot_delta(ja, jb))
        assert pmetrics.snapshot_delta(pa, pa)["counters"] == []
    elif what == "prometheus":
        labeled = [({"rank": "0"}, pa), ({"rank": "driver"}, pb)]
        assert (pmetrics.render_prometheus(labeled)
                == jmetrics.render_prometheus(labeled))
    elif what == "json":
        labeled = [({"rank": "0"}, pa), ({"rank": "1"}, pb)]
        assert (_strip_time(pmetrics.render_json(labeled, indent=2))
                == _strip_time(jmetrics.render_json(labeled, indent=2)))


# -- timeline ------------------------------------------------------------------


def _clocks():
    t = {"wall": 1_700_000_000.25, "perf": 50.0}

    def wall():
        t["wall"] += 0.001
        return t["wall"]

    def perf_clock():
        t["perf"] += 0.0015
        return t["perf"]

    return wall, perf_clock


def _record(tl):
    seen = []
    tl.observer = seen.append
    with tl.span("train_step", cat="train", step=0, phase="compile"):
        tl.instant("worker.start", cat="worker", rank=0)
        with tl.span("reduce", cat="collective", op="reduce", bytes=64):
            pass
    tl.complete("reduce", 1_700_000_000.5, 0.25, cat="collective", tid=7,
                op="reduce")
    tl.instant("request.submit", cat="serving", tid=3, rid=3)
    with tl.span("checkpoint.save", cat="checkpoint", step=2, sync=True):
        pass
    events = tl.drain()
    assert len(tl) == 0 and seen == events
    return events


def test_timeline_chrome_trace_like_jax():
    port_events = _record(Timeline(*_clocks()))
    jax_events = _record(JTimeline(*_clocks()))
    assert port_events == jax_events
    groups = [(0, "driver", []), (1, "rank 0 @ host", port_events)]
    assert chrome_trace(groups) == jchrome_trace(groups)
    doc = chrome_trace(groups)
    assert [e["ph"] for e in doc["traceEvents"][:2]] == ["M", "M"]
    ts = [e["ts"] for e in doc["traceEvents"][2:]]
    assert ts == sorted(ts)


# -- perf: attribution and MFU ---------------------------------------------------


def _span(name, cat, ts, dur, tid, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _step_events():
    t0 = 1_000_000
    ev = [_span("train_step", "train", t0, 50_000, 1, step=0,
                phase="compile")]
    for i in range(1, 4):
        lo = t0 + i * 100_000
        ev.append(_span("train_step", "train", lo, 40_000, 1, step=i,
                        phase="execute"))
        # an allgather calling a reduce: nested on the step's thread
        ev.append(_span("allgather", "collective", lo + 5_000, 6_000, 1))
        ev.append(_span("reduce", "collective", lo + 6_000, 3_000, 1))
        ev.append(_span("checkpoint.snapshot", "host", lo + 20_000, 2_500,
                        1))
        if i == 2:
            ev.append(_span("checkpoint.save", "checkpoint", lo + 25_000,
                            10_000, 1, step=i, sync=True))
        if i == 3:
            # an overlapped collective on another thread, over the step
            # window's edge
            ev.append(_span("reduce", "collective", lo + 30_000, 20_000, 2))
        # the input pipeline between steps
        ev.append(_span("data.wait", "data", lo + 45_000, 8_000, 1))
    ev.append({"name": "worker.exit", "cat": "worker", "ph": "i",
               "ts": t0 + 500_000, "s": "p", "tid": 1, "args": {}})
    return ev


def test_attribution_report_like_jax():
    events = _step_events()
    got = perf.attribution_report(events)
    assert got == jperf.attribution_report(events)
    assert got["schema"] == "sparkdl_tpu.perf.breakdown/1"
    assert got["steps"] == 3
    for row in got["per_step"]:
        assert sum(row["components"].values()) == pytest.approx(
            row["dur_s"], abs=1e-9)
    assert got["overlap_efficiency"] > 0
    assert perf.attribution_report([]) == {"steps": 0}


def test_mfu_on_the_cpu_row_like_jax(port_on, jax_on):
    flops, nbytes, secs = 3.0e9, 6.0e8, 0.0125
    entry = perf.register_step_cost("train_step", flops=flops,
                                    bytes_accessed=nbytes)
    assert entry["device_kind"] == "cpu"  # no card here
    jperf._step_costs["train_step"] = {
        "flops": flops, "bytes_accessed": nbytes, "device_kind": "cpu",
        "peak_flops": jperf.peak_flops("cpu"),
        "peak_bytes": jperf.peak_bytes_per_sec("cpu")}
    perf.note_step("train_step", secs)
    jperf.note_step("train_step", secs)

    def gauges(reg, names):
        return {(g["name"], tuple(sorted(g["labels"].items()))): g["value"]
                for g in reg.snapshot()["gauges"] if g["name"] in names}

    names = {"mfu", "membw_util", "achieved_flops_per_sec",
             "achieved_bytes_per_sec"}
    got = gauges(observe.metrics(), names)
    assert got == gauges(jobs.metrics(), names)
    assert got[("mfu", (("device_kind", "cpu"), ("fn", "train_step")))] \
        == pytest.approx(flops / secs / 1e12)


def test_peak_table_is_the_cards_own(port_on, monkeypatch):
    name = "NVIDIA H100 80GB HBM3"
    assert perf.normalize_device_kind(name) == "h100"
    assert (perf.peak_flops(name), perf.peak_bytes_per_sec(name),
            perf.peak_interconnect_bytes_per_sec(name)) == (
                989e12, 3.35e12, 900e9)
    assert perf.PEAK_TABLE["cpu"] == jperf.PEAK_TABLE["cpu"]
    assert not set(perf.PEAK_TABLE) & {"v4", "v5e", "v5p"}
    assert perf.hbm_capacity_bytes("cpu") is None
    # an unknown card borrows no peak: no MFU gauge, only the rates
    monkeypatch.setattr(perf, "device_kind",
                        lambda: "NVIDIA A100-SXM4-80GB")
    assert perf.peak_flops() is None
    perf.register_step_cost("s", flops=1e9)
    perf.note_step("s", 0.5)
    names = {g["name"] for g in observe.metrics().snapshot()["gauges"]}
    assert "achieved_flops_per_sec" in names and "mfu" not in names


@pytest.mark.parametrize("name, kind", [
    ("NVIDIA H100 80GB HBM3", "h100"),
    ("NVIDIA H100 SXM5 80GB", "h100"),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", "cpu"),
])
def test_only_the_sxm_h100_has_the_h100_peaks(name, kind):
    # the H100 PCIe (756 TFLOP/s, 2.0 TB/s) and NVL differ from the SXM
    # card's row: they borrow no peak
    assert perf.normalize_device_kind(name) == kind
    assert (perf.peak_flops(name) is None) == (kind is None)


# -- flight recorder ----------------------------------------------------------


def _events(n):
    return [{"name": f"e{i}", "cat": "train", "ph": "i", "ts": 1000 + i,
             "tid": 1, "args": {"i": i}} for i in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flight_recorder_rings_read_across_packages(tmp_path, writer):
    rec_cls = (flightrec.FlightRecorder if writer == "port"
               else jflightrec.FlightRecorder)
    path = str(tmp_path / "flightrec-rank-3.ring")
    rec = rec_cls(path, nslots=8)
    for ev in _events(20):   # wraps around: the last 8 survive, in order
        rec.record(ev)
    rec.record({"name": "big", "ph": "i", "ts": 1, "tid": 1,
                "args": {"pad": "x" * 5000}})   # cut to its identity
    rec.close()
    want = _events(20)[-7:]
    for reader in (flightrec.FlightRecorder.read_tail,
                   jflightrec.FlightRecorder.read_tail):
        tail = reader(path)
        assert tail[:-1] == want
        assert tail[-1]["truncated"] is True and tail[-1]["name"] == "big"
    assert (flightrec.recover_job_dir(str(tmp_path))
            == jflightrec.recover_job_dir(str(tmp_path)))
    # a torn slot (its payload garbled after its header) is dropped
    raw = bytearray(open(path, "rb").read())
    off = 16 + 2 * 1024 + 12
    raw[off:off + 4] = b"\xff\xfe{x"
    open(path, "wb").write(bytes(raw))
    for reader in (flightrec.FlightRecorder.read_tail,
                   jflightrec.FlightRecorder.read_tail):
        tail = reader(path)
        assert len(tail) == 7 and tail == reader(path)
    with pytest.raises(ValueError, match="not a flight-recorder ring"):
        flightrec.FlightRecorder.read_tail(__file__)


def test_flight_recorder_layout_is_the_jax_layout(tmp_path):
    a, b = str(tmp_path / "a.ring"), str(tmp_path / "b.ring")
    for cls, path in ((flightrec.FlightRecorder, a),
                      (jflightrec.FlightRecorder, b)):
        rec = cls(path, nslots=8)
        for ev in _events(5):
            rec.record(ev)
        rec.close()
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a, "rb").read()[:8] == b"SDTFR1\x00\x00"


# -- memory accounting ----------------------------------------------------------


def _exact_bytes(tensors):
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def test_mem_categories_are_exact_tensor_bytes(port_on):
    model = pt_llama.init_weights(pt_llama.Llama(_tiny_cfg(lora_rank=4),
                                                 device="cpu"),
                                  torch.Generator().manual_seed(0))
    mask = lora_mask(model)
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=1e-3)
    assert mem.register_tree("params", model) == _exact_bytes(
        list(model.parameters()) + list(model.buffers()))
    mem.register_tree("opt_state", opt)
    assert mem.category_bytes()["opt_state"] == 0   # no step yet
    step = pt_train.make_train_step(pt_train.make_lm_loss_fn(model), opt,
                                    param_mask=mask, device="cpu")
    step(pt_train.global_batch(np.random.default_rng(0), 512, 2, 16))
    opt_bytes = _exact_bytes(t for s in opt.state.values()
                             for t in s.values()
                             if isinstance(t, torch.Tensor))
    assert opt_bytes > 0
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    mem.register_tree("kv_pages", sd)
    sample = mem.sample_now()
    assert sample["categories"] == {
        "params": _exact_bytes(list(model.parameters())
                               + list(model.buffers())),
        "opt_state": opt_bytes, "kv_pages": _exact_bytes(sd.values())}
    assert sample["hbm"] is None and sample["unattributed"] is None
    gauges = {g["labels"].get("category"): g["value"]
              for g in observe.metrics().snapshot()["gauges"]
              if g["name"] == "mem_bytes"}
    assert gauges == sample["categories"]
    assert mem.beacon_sample()["categories"] == sample["categories"]


def _telemetry_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name in TELEMETRY_THREADS)


def test_mem_sampler_starts_only_with_the_switch(port_on, monkeypatch):
    monkeypatch.setattr(observe, "TELEMETRY_DIR", None)
    assert mem.maybe_start_sampler(0.01) is None
    assert mem.register_tree("params", 123) is None
    assert _telemetry_threads() == []
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(port_on))
    thread = mem.maybe_start_sampler(0.01)
    assert thread is not None and "sparkdl-torch-mem" in _telemetry_threads()
    time.sleep(0.05)
    mem.stop_sampler()
    assert _telemetry_threads() == []
    names = [e["name"] for e in observe.timeline().drain()]
    assert names.count("mem.sample") >= 2


def test_oom_guard_writes_the_jax_report(port_on, jax_on, tmp_path):
    port_dir, jax_dir = tmp_path / "p_oom", tmp_path / "j_oom"
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with mem.oom_guard(phase="step", run_dir=str(port_dir)):
            raise err
    with pytest.raises(ValueError):   # not an allocation failure
        with mem.oom_guard(phase="step", run_dir=str(port_dir / "x")):
            raise ValueError("bad shape")
    assert not (port_dir / "x").exists()
    jpath = jmem.write_oom_report("step", MemoryError("host OOM"),
                                  run_dir=str(jax_dir))
    port = json.load(open(port_dir / "oom_report.json"))
    ref = json.load(open(jpath))
    assert set(port) == set(ref)
    assert set(port["device"]) == set(ref["device"])
    assert port["schema"] == ref["schema"] and port["phase"] == "step"
    assert "CUDA out of memory" in port["error"]
    assert mem.is_oom(err) and not mem.is_oom(ValueError("x"))
    counters = {c["name"] for c in observe.metrics().snapshot()["counters"]}
    assert "oom_reports_total" in counters


# -- the switch off: nothing of the facade -------------------------------------


def _raise(*a, **k):
    raise AssertionError("a telemetry call with the switch off")


def test_switch_off_calls_nothing_of_the_facade(monkeypatch, tmp_path):
    monkeypatch.setattr(observe, "TELEMETRY_DIR", None)
    observe._reset_for_tests()
    from sparkdl_tpu_torch.observe import health

    for name in ("inc", "set_gauge", "observe_value", "span", "host_span",
                 "instant", "complete", "flush", "new_run_dir",
                 "set_sink", "start_flusher", "snapshot_payload"):
        monkeypatch.setattr(observe, name, _raise)
    for name in ("note_step", "note_collective", "heartbeat_payload"):
        monkeypatch.setattr(health, name, _raise)
    monkeypatch.setattr(mem, "sample_now", _raise)
    monkeypatch.setattr(perf, "note_step", _raise)
    before = _telemetry_threads()

    # an instrumented step
    model = pt_llama.init_weights(pt_llama.Llama(_tiny_cfg(lora_rank=4),
                                                 device="cpu"),
                                  torch.Generator().manual_seed(0))
    mask = lora_mask(model)
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=1e-3)
    step = pt_train.instrument_step(pt_train.make_train_step(
        pt_train.make_lm_loss_fn(model), opt, param_mask=mask,
        device="cpu"))
    batch = pt_train.global_batch(np.random.default_rng(0), 512, 2, 16)
    assert torch.isfinite(step(batch)["loss"])
    # a collective (outside a gang it copies), and an async one
    x = torch.arange(4.0)
    assert torch.equal(_collectives.reduce(x, _collectives.SUM), x)
    assert torch.equal(_collectives.reduce_start(
        x, _collectives.SUM).result(), x)
    # a checkpoint save, sync and async, and a restore
    for async_save in (False, True):
        ck = TrainCheckpointer(str(tmp_path / f"ck{async_save}"),
                               async_save=async_save)
        assert ck.save(1, {"w": x})
        assert torch.equal(ck.restore(1)["w"], x)
    # a served request
    cfg = _tiny_cfg(n_layers=1, max_cache_len=64)
    served = pt_llama.init_weights(pt_llama.Llama(cfg, device="cpu"),
                                   torch.Generator().manual_seed(1))
    engine = ContinuousBatchingEngine(served, served.state_dict(),
                                      n_slots=2, chunk=4, page_size=8,
                                      quant="int8", device="cpu")
    fe = ServingFrontend(engine).start()
    try:
        assert fe.request_telemetry is None and engine.telemetry is None
        req = urllib.request.Request(
            f"http://{fe.address[0]}:{fe.address[1]}/generate",
            data=json.dumps({"tokens": [1, 2, 3],
                             "max_new_tokens": 3}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())["tokens"]) == 3
        assert _telemetry_threads() == before == []
    finally:
        fe.close()
    assert len(observe.timeline()) == 0
    assert observe.metrics().snapshot()["counters"] == []
    assert mem.category_bytes() == {}
    assert perf._step_costs == {}


def test_worker_settings_travel_as_module_settings(monkeypatch):
    from sparkdl_tpu_torch.observe import capture, health

    monkeypatch.setattr(observe, "TELEMETRY_DIR", None)
    assert observe.worker_settings() is None
    monkeypatch.setattr(observe, "TELEMETRY_DIR", "/some/where")
    monkeypatch.setattr(health, "HEARTBEAT_S", 0.5)
    settings = observe.worker_settings()
    assert settings == {
        "observe.TELEMETRY_DIR": "/some/where", "observe.FLUSH_S": 5.0,
        "health.HEARTBEAT_S": 0.5, "mem.SAMPLE_S": mem.SAMPLE_S,
        "flightrec.EVENTS": flightrec.EVENTS,
        "capture.STEPS": capture.STEPS, "capture.AT_STEP": capture.AT_STEP}
    assert json.loads(json.dumps(settings)) == settings
    monkeypatch.setattr(observe, "TELEMETRY_DIR", None)
    with observe.applied_settings(dict(settings, **{
            "health.HEARTBEAT_S": 0.25})):
        assert observe.enabled() and health.HEARTBEAT_S == 0.25
    assert not observe.enabled() and health.HEARTBEAT_S == 0.5
    # no environment variable is read
    monkeypatch.setenv("SPARKDL_TPU_TELEMETRY_DIR", "/else/where")
    assert not observe.enabled()
