"""Gang health and the gang's run dir on the port, against the JAX
package: the hang detector's verdicts beat for beat under one injected
clock, the stack dump of a waiting thread, the control plane's
telemetry, heartbeat and dump frames, no CUDA read before ``hvd.init``
has bound the rank's card; and two CPU gangs:

1. a telemetry-on gang of two ranks (tiny Llama, LoRA, three steps
   through ``hvd.DistributedOptimizer``): its run dir is read by the JAX
   package's doctor, the JAX attribution of its timeline is its
   ``perf.json``, both lanes carry the allreduce's collective spans, and
   each rank's losses are those of the same steps with the switch off
   (taken first, in the same gang);
2. a one-rank gang under one retry whose first attempt wedges inside a
   collective: a hang verdict, the wedged frame in the stack dump, one
   relaunch, the recovered flight-recorder tail.

cloudpickle sends this module's functions by value, so a worker imports
the port and torch, never this module or JAX."""

import glob
import json
import os
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

from sparkdl_tpu.observe import doctor as jdoctor
from sparkdl_tpu.observe import health as jhealth
from sparkdl_tpu.observe import perf as jperf
from sparkdl_tpu_torch import HorovodRunner, observe
from sparkdl_tpu_torch.horovod import _worker, launcher, supervisor
from sparkdl_tpu_torch.horovod.control_plane import (
    ControlPlaneClient,
    ControlPlaneServer,
)
from sparkdl_tpu_torch.hvd import _state
from sparkdl_tpu_torch.observe import health
from sparkdl_tpu_torch.observe.aggregate import GangTelemetry
from sparkdl_tpu_torch.parallel.train import global_batch

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STEPS = 3

# -- the hang detector, beat for beat ---------------------------------------------

# each case: ("t", now) | ("beat", rank, progress, step, collective) |
# ("poll",) — the cases of the JAX package's own detector tests
CASES = {
    "progressing": [op for now in range(0, 40, 5) for op in (
        ("t", now), ("beat", 0, now + 1, now, None),
        ("beat", 1, now + 1, now, None), ("poll",))],
    "straggler_then_hang": [
        ("beat", 0, 1, 1, "reduce"), ("beat", 1, 1, 1, None), ("poll",),
        ("t", 5), ("beat", 0, 3, 2, "reduce"), ("beat", 1, 1, 1, None),
        ("t", 16), ("beat", 0, 3, 2, "reduce"), ("beat", 1, 1, 1, None),
        ("poll",), ("t", 30), ("poll",)],
    "deadlock": [
        ("beat", 0, 2, 7, "allgather"), ("beat", 1, 2, 7, "allgather"),
        ("poll",), ("t", 12), ("beat", 0, 2, 7, "allgather"),
        ("beat", 1, 2, 7, "allgather"), ("poll",)],
    "silent": [
        ("beat", 0, 1, 0, None), ("beat", 1, 1, 0, None), ("poll",),
        ("t", 12), ("beat", 0, 9, 4, None), ("poll",),
        ("beat", 1, 2, 1, None), ("poll",)],
    "never_beat": [
        ("beat", 0, 1, 0, None), ("poll",), ("t", 11),
        ("beat", 0, 5, 2, "reduce"), ("poll",), ("t", 23),
        ("beat", 0, 5, 2, "reduce"), ("poll",)],
    "recovered": [
        ("beat", 0, 1, 0, None), ("beat", 1, 1, 0, None), ("poll",),
        ("t", 11), ("beat", 0, 1, 0, None), ("beat", 1, 9, 3, None),
        ("poll",), ("t", 12), ("beat", 0, 7, 1, None), ("t", 23),
        ("beat", 0, 20, 5, None), ("beat", 1, 9, 3, None), ("poll",)],
    "uninstrumented": [
        ("beat", 0, 0, None, None), ("beat", 1, 0, None, None), ("poll",),
        ("t", 100), ("beat", 0, 0, None, None), ("beat", 1, 0, None, None),
        ("poll",)],
}


def _run_case(module, ops):
    t = {"now": 0.0}
    det = module.HangDetector(2, stall_s=10.0, clock=lambda: t["now"],
                              check_every=0)
    reports = []
    for op in ops:
        if op[0] == "t":
            t["now"] = float(op[1])
        elif op[0] == "beat":
            _, rank, progress, step, coll = op
            det.observe_beat(rank, {"progress": progress, "step": step,
                                    "collective": coll})
        else:
            reports.append(det.poll())
    return (reports, det.summary(), det.describe(), det.live_state(),
            det.stalled_ranks, det.hang_verdict)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hang_detector_verdicts_like_jax(case):
    got = _run_case(health, CASES[case])
    assert got == _run_case(jhealth, CASES[case])
    reports, verdict = got[0], got[-1]
    want = {"progressing": None, "straggler_then_hang": "straggler",
            "deadlock": "deadlock", "silent": None, "never_beat": "deadlock",
            "recovered": None, "uninstrumented": None}[case]
    assert verdict == want
    # one hang an attempt
    assert sum(r["hang"] is not None for r in reports) == (want is not None)


def test_verdict_instants_and_counters_like_jax(tmp_path, monkeypatch):
    from sparkdl_tpu import observe as jobs

    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "p"))
    monkeypatch.setenv(jobs.TELEMETRY_DIR_ENV, str(tmp_path / "j"))
    observe._reset_for_tests()
    jobs._reset_for_tests()
    try:
        got = []
        for obs, module in ((observe, health), (jobs, jhealth)):
            _run_case(module, CASES["straggler_then_hang"])
            events = obs.timeline().drain()
            counts = {c["labels"]["verdict"]: c["value"]
                      for c in obs.metrics().snapshot()["counters"]
                      if c["name"] == "gang_stalls_total"}
            got.append(([(e["name"], e["args"]) for e in events], counts))
        assert got[0] == got[1]
        names = [n for n, _ in got[0][0]]
        assert names[:3] == ["health.stall", "health.stall", "health.hang"]
        assert got[0][1]["straggler"] == 1 and got[0][1]["stall"] == 2
    finally:
        monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV)
        observe._reset_for_tests()
        jobs._reset_for_tests()


def _wedged_in_allreduce(event):
    """A rank stuck in a collective its peer never joins."""
    health.note_collective("allreduce")
    event.wait()


def test_dump_all_threads_names_a_waiting_thread():
    ev = threading.Event()
    t = threading.Thread(target=_wedged_in_allreduce, args=(ev,),
                         name="wedged")
    t.start()
    try:
        time.sleep(0.05)
        dump = health.dump_all_threads()
    finally:
        ev.set()
        t.join()
    assert "_wedged_in_allreduce" in dump and "test_torch_health" in dump


# -- the control plane's telemetry frames ------------------------------------------


def test_control_plane_carries_telemetry_beats_and_dumps():
    tel = GangTelemetry()
    det = health.HangDetector(1, stall_s=30.0)
    server = ControlPlaneServer(1, telemetry=tel, health=det)
    client = ControlPlaneClient(server.address, 0, server.secret)
    try:
        client.start_driver_watchdog()
        client.send_ready()
        client.send_heartbeat({"rank": 0, "step": 4, "progress": 9,
                               "collective": "reduce", "hbm": {},
                               "mem": {}, "ts": time.time()})
        reg = observe.Registry()
        reg.counter("collective_ops_total", op="reduce").inc(2)
        client.send_telemetry({
            "host": "h", "pid": 1, "metrics": reg.snapshot(),
            "events": [{"name": "reduce", "cat": "collective", "ph": "X",
                        "ts": 1, "dur": 2, "tid": 1, "args": {}}]})
        client.send_telemetry({"metrics": {"counters": [{"name": 3}]}})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not det.summary()["ranks"]:
            time.sleep(0.02)
        assert det.summary()["ranks"]["0"]["progress"] == 9
        assert server.request_dump(0, reason="stall")
        assert not server.request_dump(5)
        while time.monotonic() < deadline and not server.stack_dumps(0):
            time.sleep(0.02)
        dump = server.stack_dumps(0)[0]
        assert "hvd-driver-watchdog" in dump or "watch" in dump
        _, journal = tel.events_since(0)
        assert [e["name"] for _, _, e in journal] == ["reduce"]
        assert tel._hosts == {0: "h"}
    finally:
        client.send_bye(0)
        client.close()
        server.wait_drained(5.0)
        server.close()


# -- no CUDA read before hvd.init binds the card --------------------------------


class _FakeClient:
    """A rank's control-plane client that records what it sends."""

    rank = 0

    def __init__(self):
        self.beats = []

    def start_driver_watchdog(self):
        pass

    def send_log(self, stream, text):
        pass

    def send_heartbeat(self, payload):
        self.beats.append((time.monotonic(), payload))

    def send_telemetry(self, *payload):
        pass

    send_ready = send_user_log = send_result = send_exception = \
        send_profile_done = set_profile_handler = send_telemetry

    def send_bye(self, exit_code):
        pass

    def close(self):
        pass


def test_no_cuda_read_before_hvd_init_binds_the_card(tmp_path, monkeypatch):
    """A telemetry-on rank (the bootstrap of a Spark task, run here)
    beats and samples from before ``hvd.init``; with the card made to
    look bound at init, every read of its memory comes after, for the
    bound card only, and the first beats carry no device gauges."""
    reads, bound = [], {}
    real_init = _state.init

    def init(device=None):
        time.sleep(0.2)   # the first beat goes meanwhile
        real_init(device=device)
        _state.state().device = torch.device("cuda", 3)
        bound["at"] = time.monotonic()

    def read(dev):
        reads.append((time.monotonic(), dev))
        return ({"allocated_bytes.all.current": 5,
                 "allocated_bytes.all.peak": 7,
                 "reserved_bytes.all.current": 8}, 100)

    monkeypatch.setattr(_state, "init", init)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(health, "_read_cuda_memory", read)
    client = _FakeClient()
    settings = {"observe.TELEMETRY_DIR": str(tmp_path), "observe.FLUSH_S": 0,
                "health.HEARTBEAT_S": 0.02, "mem.SAMPLE_S": 0.02,
                "flightrec.EVENTS": 16}
    _worker.run_rank(client, log_path=str(tmp_path / "rank-0.log"),
                     device="cpu", restart=_worker_restart(),
                     load_payload=lambda: (_nap, {"seconds": 0.3}),
                     send_result=False, parent_death=False,
                     telemetry=settings, job_dir=str(tmp_path))
    assert not observe.enabled() and _state.state().device is None
    assert reads and all(t > bound["at"] for t, _ in reads)
    assert {dev for _, dev in reads} == {torch.device("cuda", 3)}
    before = [p for t, p in client.beats if t < bound["at"]]
    after = [p for t, p in client.beats if t > bound["at"]]
    assert before and all(p["hbm"] == {} for p in before)
    assert after and after[-1]["hbm"] == {"in_use": 5, "peak": 7,
                                          "limit": 100}
    assert os.path.exists(tmp_path / "flightrec-rank-0.ring")


def _nap(seconds):
    time.sleep(seconds)


def _worker_restart():
    from sparkdl_tpu_torch.horovod import RestartContext

    return RestartContext(0, None)


# -- the gangs ----------------------------------------------------------------------


@pytest.fixture
def bounded_gangs(monkeypatch):
    """Each gang must start within 60 s and end within 120 s; a failed
    worker's peers are killed 2 s after it."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)


def _tiny_trainer(torch, hvd):
    from sparkdl_tpu_torch.models import llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        replicate,
    )

    cfg = llama.LlamaConfig.tiny(d_model=256, vocab_size=512, n_heads=4,
                                 n_kv_heads=2, d_ff=512, lora_rank=4,
                                 dtype=torch.float32)
    model = llama.init_weights(llama.Llama(cfg, device="cpu"),
                               torch.Generator().manual_seed(0))
    replicate(model)
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3,
                          weight_decay=1e-4), named_parameters=named)
    return model, opt, make_train_step(make_lm_loss_fn(model), opt,
                                       param_mask=mask, device="cpu")


def _telemetry_main(batch, steps):
    """The same LoRA steps twice from the same weights: with the switch
    turned off in this rank, then instrumented with it on."""
    import torch

    from sparkdl_tpu_torch import hvd, observe
    from sparkdl_tpu_torch.observe import mem, perf
    from sparkdl_tpu_torch.parallel.train import instrument_step, shard_batch

    torch.set_num_threads(2)
    hvd.init()
    mine = shard_batch(batch)
    on, observe.TELEMETRY_DIR = observe.TELEMETRY_DIR, None
    _, _, plain = _tiny_trainer(torch, hvd)
    ref = [plain(mine)["loss"].item() for _ in range(steps)]
    observe.TELEMETRY_DIR = on
    model, opt, step = _tiny_trainer(torch, hvd)
    mem.register_tree("params", model)
    mem.register_tree("opt_state", opt)
    perf.register_step_cost("train_step", flops=1e9, bytes_accessed=1e8)
    step = instrument_step(step)
    losses = [step(mine)["loss"].item() for _ in range(steps)]
    return {"ref": hvd.allgather_object(ref),
            "losses": hvd.allgather_object(losses),
            "categories": hvd.allgather_object(mem.category_bytes()),
            "params_bytes": sum(t.numel() * t.element_size() for t in
                                list(model.parameters())
                                + list(model.buffers()))}


def _run_dir(root):
    dirs = glob.glob(os.path.join(root, "run-*"))
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def telemetry_gang(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gang_telemetry"))
    mp = pytest.MonkeyPatch()
    mp.setattr(launcher, "START_TIMEOUT_S", 60.0)
    mp.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    mp.setattr(launcher, "ABORT_GRACE_S", 2.0)
    mp.setattr(observe, "TELEMETRY_DIR", root)
    mp.setattr(observe, "FLUSH_S", 0.5)
    mp.setattr(health, "HEARTBEAT_S", 0.25)
    observe._reset_for_tests()
    try:
        batch = global_batch(np.random.default_rng(3), 512, 4, 16)
        out = HorovodRunner(np=-2).run(_telemetry_main, batch=batch,
                                       steps=STEPS)
    finally:
        mp.undo()
        observe._reset_for_tests()
    return out, _run_dir(root)


def _lanes(run_dir):
    doc = json.load(open(os.path.join(run_dir, "timeline.json")))
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] != "M":
            lanes.setdefault(e["pid"], []).append(e)
    return lanes


@pytest.mark.gang
def test_gang_run_dir_is_read_by_the_jax_readers(telemetry_gang):
    out, run_dir = telemetry_gang
    names = set(os.listdir(run_dir))
    assert {"timeline.json", "metrics.prom", "metrics.json", "perf.json",
            "health.json", "flightrec-rank-0.json",
            "flightrec-rank-1.json"} <= names
    diag = jdoctor.diagnose(run_dir)
    assert diag is not None
    text = jdoctor.render_text(diag)
    assert "rank" in text
    perf_doc = json.load(open(os.path.join(run_dir, "perf.json")))
    assert perf_doc["schema"] == jperf.BREAKDOWN_SCHEMA
    lanes = _lanes(run_dir)
    for rank in (0, 1):
        report = jperf.attribution_report(lanes[rank + 1])
        assert json.loads(json.dumps(report)) == perf_doc["ranks"][str(rank)]
        assert report["steps"] == STEPS - 1


@pytest.mark.gang
def test_gang_lanes_carry_steps_collectives_and_lifecycle(telemetry_gang):
    out, run_dir = telemetry_gang
    lanes = _lanes(run_dir)
    driver = [e["name"] for e in lanes[0]]
    assert "gang.attempt" in driver and "gang.ready" in driver
    for rank in (0, 1):
        lane = lanes[rank + 1]
        names = [e["name"] for e in lane]
        assert names.count("worker.start") == 1
        assert names.count("worker.exit") == 1
        phases = [e["args"]["phase"] for e in lane
                  if e["name"] == "train_step" and e["ph"] == "X"]
        assert phases == ["compile"] + ["execute"] * (STEPS - 1)
        # the DistributedOptimizer's allreduce, under the JAX op name
        reduces = [e for e in lane if e["cat"] == "collective"
                   and e["name"] == "reduce" and e["ph"] == "X"]
        assert len(reduces) >= STEPS
    prom = open(os.path.join(run_dir, "metrics.prom")).read()
    for rank in (0, 1):
        assert (f'train_step_total{{phase="execute",rank="{rank}"}} '
                f'{STEPS - 1}') in prom
        assert f'collective_ops_total{{op="reduce",rank="{rank}"}}' in prom
        assert f'mfu{{device_kind="cpu",fn="train_step",rank="{rank}"}}' \
            in prom
    assert 'gang_attempts_total{rank="driver"} 1' in prom
    # CPU ranks: no device gauges, in the beats or the metrics
    assert "device_hbm_bytes" not in prom
    health_doc = json.load(open(os.path.join(run_dir, "health.json")))
    ranks = health_doc["attempts"][0]["ranks"]
    assert set(ranks) == {"0", "1"}
    assert all(r["hbm"] == {} for r in ranks.values())
    assert health_doc["attempts"][0]["hang_verdict"] is None


@pytest.mark.gang
def test_gang_losses_equal_the_switch_off_and_memory_is_exact(
        telemetry_gang):
    out, _ = telemetry_gang
    assert out["losses"] == out["ref"]
    assert np.all(np.isfinite(out["losses"]))
    for cats in out["categories"]:
        assert cats["params"] == out["params_bytes"]
        assert cats["opt_state"] > 0


def _hang_main():
    """Attempt 0 takes a step and wedges in a collective; attempt 1
    takes two steps."""
    import threading

    import torch

    from sparkdl_tpu_torch import horovod, hvd
    from sparkdl_tpu_torch.parallel.train import instrument_step

    hvd.init()
    ctx = horovod.restart_context()
    step = instrument_step(lambda: {"loss": torch.ones(())})
    if ctx.attempt == 0:
        step()
        _wedged_in_allreduce(threading.Event())
    for _ in range(2):
        step()
    return ctx.attempt


@pytest.mark.gang
def test_hang_gang_is_diagnosed_and_relaunched(tmp_path, monkeypatch,
                                               bounded_gangs):
    root = str(tmp_path / "telemetry")
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy(
        max_retries=1, backoff_base=0.1, jitter=0.0))
    monkeypatch.setattr(observe, "TELEMETRY_DIR", root)
    monkeypatch.setattr(observe, "FLUSH_S", 0.5)
    monkeypatch.setattr(health, "HEARTBEAT_S", 0.25)
    monkeypatch.setattr(health, "STALL_S", 3.0)
    observe._reset_for_tests()
    try:
        assert HorovodRunner(np=1).run(_hang_main) == 1
    finally:
        observe._reset_for_tests()
    run_dir = _run_dir(root)
    health_doc = json.load(open(os.path.join(run_dir, "health.json")))
    verdicts = [a["hang_verdict"] for a in health_doc["attempts"]]
    assert verdicts == ["deadlock", None]
    assert health_doc["attempts"][0]["ranks"]["0"]["collective"] == \
        "allreduce"
    dump = open(os.path.join(run_dir, "stack-rank-0.txt")).read()
    assert "_wedged_in_allreduce" in dump
    prom = open(os.path.join(run_dir, "metrics.prom")).read()
    assert 'gang_restarts_total{rank="driver"} 1' in prom
    assert 'gang_failures_total{rank="driver",verdict="transient"} 1' in prom
    assert 'gang_stalls_total{rank="driver",verdict="deadlock"} 1' in prom
    lanes = _lanes(run_dir)
    driver = [e["name"] for e in lanes[0]]
    assert driver.count("gang.attempt") == 2
    assert driver.index("health.hang") < driver.index("gang.backoff")
    failure = next(e for e in lanes[0] if e["name"] == "gang.failure")
    assert failure["args"]["kind"] == "hang"
    assert failure["args"]["verdict"] == "transient"
    # attempt 0 died by the kill: its ring keeps its step
    tail = json.load(open(os.path.join(run_dir, "flightrec-rank-0.json")))
    steps = [e for e in tail["events"] if e["name"] == "train_step"]
    assert {e["args"]["step"] for e in steps} >= {0, 1}
    assert any(e["name"] == "gang.resume" for e in lanes[1])
