"""The port's multi-replica fleet front-end, ported from
``tests/models/test_fleet.py``: admission control (503 with
Retry-After), routing by depth, a dead replica's requests failed with
500 and a hung one replaced, 400 on a saturated fleet, every outcome
accounted in ``server_requests_total``; with real tiny port engines
against JAX ``generate``; plus what the port adds: each blocking client
answered when its own request ends (``engine.take_finished()``), and
the engine's telemetry hooks called with the JAX engine's arguments on
the same requests.

The fake engine follows the port engine's contract: ``run()`` decodes
one token a step for every admitted request, admits arrivals between
steps and hands finished requests to ``take_finished()`` from its
progress hook."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import quant as jax_quant
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.models.generate import generate as jax_generate
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.fleet import EngineWorker, FleetFrontend
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.observe.metrics import Registry

torch.set_num_threads(2)


class _FakeCfg:
    max_cache_len = 64


class _FakeEngine:
    """Engine-shaped stub: serves arange(max_new) per request, one token
    a step for every admitted request (``delay`` seconds a step).
    ``fault`` = Exception -> engine fault (recoverable 500);
    BaseException -> loop death; ``block`` = an Event the engine waits
    on inside run() (a hung replica)."""

    mesh = None

    def __init__(self, fault=None, block=None, delay=0.0):
        self.cfg = _FakeCfg()
        self.fault = fault
        self.block = block
        self.delay = delay
        self.telemetry = None
        self.finish_reasons = {}
        self.logprobs = {}
        self._queued = {}
        self._results = {}
        self._next = 0
        self.served = 0

    def _worst_case_tokens(self, prompt_len, max_new):
        return prompt_len + max_new

    def submit(self, tokens, max_new_tokens, stop=None):
        rid = self._next
        self._next += 1
        self._queued[rid] = max_new_tokens
        return rid

    def take_finished(self):
        out = {rid: (toks, self.finish_reasons.pop(rid),
                     self.logprobs.pop(rid))
               for rid, toks in self._results.items()}
        self._results = {}
        return out

    def run(self, progress=None, on_token=None):
        if self.fault is not None:
            fault, self.fault = self.fault, None
            raise fault
        if self.block is not None:
            self.block.wait()
        active = {}  # rid -> [budget, tokens so far]
        while self._queued or active:
            for rid, n in self._queued.items():
                if self.telemetry is not None:
                    self.telemetry.request_admitted(rid)
                active[rid] = [n, 0]
            self._queued.clear()
            if self.delay:
                time.sleep(self.delay)
            if self.telemetry is not None:
                self.telemetry.decode_chunk(len(active), 8, 1)
            for rid in list(active):
                n, k = active[rid]
                if on_token is not None:
                    on_token(rid, k)
                active[rid][1] = k + 1
                if k + 1 == n:
                    del active[rid]
                    self._results[rid] = np.arange(n, dtype=np.int32)
                    self.finish_reasons[rid] = "length"
                    self.logprobs[rid] = [0.0] * n
                    self.served += 1
            if progress is not None:
                progress(self)
        out, self._results = self._results, {}
        return out

    def abort_requests(self):
        self._queued.clear()


def _url(fleet, path="/generate"):
    return f"http://{fleet.address[0]}:{fleet.address[1]}{path}"


def _post(fleet, payload, timeout=60):
    req = urllib.request.Request(
        _url(fleet), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(fleet, path, timeout=30):
    with urllib.request.urlopen(_url(fleet, path), timeout=timeout) as r:
        return r.status, r.read()


def _requests_total(fleet):
    """{code: count} from the fleet registry."""
    out = {}
    for (name, labels), c in list(fleet.metrics._metrics.items()):
        if name == "server_requests_total":
            out[dict(labels)["code"]] = c.value
    return out


def _settled_requests_total(fleet, n, timeout=10):
    """The counts once ``n`` responses are accounted (a handler accounts
    its response just after writing it)."""
    deadline = time.monotonic() + timeout
    while (sum(_requests_total(fleet).values()) < n
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return _requests_total(fleet)


def _fake_fleet(factory, **kw):
    kw.setdefault("poll_seconds", 0.05)
    kw.setdefault("hang_seconds", 60.0)
    return FleetFrontend(factory, **kw).start()


def _join(threads, timeout=30):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


def test_fleet_serves_and_routes_by_depth():
    """Requests land on the least-loaded live replica; all complete."""
    engines = []

    def factory():
        e = _FakeEngine()
        engines.append(e)
        return e

    fleet = _fake_fleet(factory, replicas=2, max_queue=32)
    try:
        for _ in range(8):
            out = _post(fleet, {"tokens": [1, 2], "max_new_tokens": 3})
            assert out["tokens"] == [0, 1, 2]
        assert sum(e.served for e in engines) == 8
        assert _settled_requests_total(fleet, 8) == {"200": 8}
    finally:
        fleet.close()


def test_admission_control_rejects_503_above_bound():
    """Arrivals above max_queue get a fast 503 (+ Retry-After), are
    counted as rejections, and never hang; the fleet keeps serving
    after the burst."""
    gate = threading.Event()

    def factory():
        return _FakeEngine(block=gate)

    fleet = _fake_fleet(factory, replicas=1, max_queue=2)
    try:
        results = []

        def client():
            try:
                results.append(
                    ("ok", _post(fleet, {"tokens": [1],
                                         "max_new_tokens": 2})))
            except urllib.error.HTTPError as e:
                results.append((e.code, dict(e.headers)))

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.05)   # let depth build deterministically
        gate.set()
        _join(threads)
        codes = [r[0] for r in results]
        assert codes.count("ok") >= 2
        rejected = [r for r in results if r[0] == 503]
        assert rejected, f"no 503s in {codes}"
        assert all(h.get("Retry-After") == "1" for _, h in rejected)
        counts = _settled_requests_total(fleet, 6)
        assert sum(counts.values()) == 6
        assert counts.get("503", 0) == len(rejected)
        rej = fleet.metrics.counter(
            "server_admission_rejections_total", reason="overload")
        assert rej.value == len(rejected)
    finally:
        gate.set()
        fleet.close()


def test_replica_death_fails_in_flight_500_and_survivors_serve():
    """A replica that dies mid-burst fails its in-flight requests with
    500 (not a hang), later arrivals route to the survivor, and the
    restart counter fires."""
    made = []

    def factory():
        # the first engine dies on its first run(); every later one (the
        # survivor and the respawn) serves
        e = _FakeEngine(
            fault=SystemExit("injected death") if not made else None)
        made.append(e)
        return e

    fleet = _fake_fleet(factory, replicas=2, max_queue=32)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fleet, {"tokens": [1, 2], "max_new_tokens": 4})
        assert e.value.code == 500
        assert "died" in str(e.value.reason)
        for _ in range(4):
            out = _post(fleet, {"tokens": [1], "max_new_tokens": 2})
            assert out["tokens"] == [0, 1]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if fleet.metrics.counter("server_replica_restarts_total",
                                     cause="death").value >= 1:
                break
            time.sleep(0.05)
        assert fleet.metrics.counter(
            "server_replica_restarts_total", cause="death").value >= 1
        counts = _settled_requests_total(fleet, 5)
        assert counts.get("500") == 1 and counts.get("200") == 4
        assert sum(counts.values()) == 5
    finally:
        fleet.close()


def test_replica_death_mid_stream_ends_sse_with_error_event():
    """A streaming client of a dying replica gets a terminal error event
    (the SSE already committed 200), never a hang."""
    def factory():
        return _FakeEngine(fault=SystemExit("injected death"))

    fleet = _fake_fleet(factory, replicas=1, max_queue=8, respawn=False)
    try:
        req = urllib.request.Request(
            _url(fleet),
            data=json.dumps({"tokens": [1], "max_new_tokens": 4,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        events = []
        with urllib.request.urlopen(req, timeout=30) as r:
            for line in r:
                line = line.strip()
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
        assert events and "error" in events[-1]
        assert "died" in events[-1]["error"]
        assert _settled_requests_total(fleet, 1).get("500") == 1
    finally:
        fleet.close()


def test_hung_replica_is_drained_and_replaced():
    """A replica with work but no progress past hang_seconds: its waiter
    gets 500 (not a hang), a fresh replica takes its slot, and the
    fleet serves on."""
    gate = threading.Event()
    made = []

    def factory():
        e = _FakeEngine(block=None if made else gate)
        made.append(e)
        return e

    fleet = _fake_fleet(factory, replicas=1, max_queue=8,
                        hang_seconds=0.4, poll_seconds=0.05)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fleet, {"tokens": [1], "max_new_tokens": 2}, timeout=30)
        assert e.value.code == 500
        assert "hung" in str(e.value.reason)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            states = fleet.replica_states()
            if states and states[0]["alive"]:
                break
            time.sleep(0.05)
        out = _post(fleet, {"tokens": [1], "max_new_tokens": 2})
        assert out["tokens"] == [0, 1]
        assert fleet.metrics.counter(
            "server_replica_restarts_total", cause="hang").value == 1
    finally:
        gate.set()
        fleet.close()


def test_healthz_fleet_and_metrics_surfaces():
    def factory():
        return _FakeEngine()

    fleet = _fake_fleet(factory, replicas=2, max_queue=4)
    try:
        status, body = _get(fleet, "/healthz")
        doc = json.loads(body)
        assert status == 200 and doc["replicas_alive"] == 2
        _, body = _get(fleet, "/fleet")
        doc = json.loads(body)
        assert [r["replica"] for r in doc["replicas"]] == [0, 1]
        assert doc["max_queue"] == 4
        _post(fleet, {"tokens": [1], "max_new_tokens": 2})
        _settled_requests_total(fleet, 1)
        _, body = _get(fleet, "/metrics")
        prom = body.decode()
        for series in ("server_requests_total", "server_queue_depth",
                       "server_replicas_alive",
                       "server_replica_queue_depth",
                       "fleet_replica_inflight", "build_info"):
            assert series in prom, series
    finally:
        fleet.close()
    # a closed fleet answers no health check
    status = None
    try:
        urllib.request.urlopen(_url(fleet, "/healthz"), timeout=5)
    except (urllib.error.HTTPError, urllib.error.URLError) as e:
        status = getattr(e, "code", "closed")
    assert status in (503, "closed")


def test_bad_request_400_even_when_saturated():
    """Admission control must not reclassify malformed input: a junk
    body is 400, not 503, even with the queue full."""
    gate = threading.Event()

    def factory():
        return _FakeEngine(block=gate)

    fleet = _fake_fleet(factory, replicas=1, max_queue=1)
    try:
        t = threading.Thread(
            target=lambda: _post(fleet, {"tokens": [1],
                                         "max_new_tokens": 2}))
        t.start()
        time.sleep(0.2)   # saturate the bound
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fleet, {"tokens": "junk"})
        assert e.value.code == 400
        gate.set()
        _join([t])
    finally:
        gate.set()
        fleet.close()


@pytest.fixture(scope="module")
def tiny():
    """A tiny fp32 JAX Llama and its weights, and the port's model on
    them."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, max_cache_len=96)
    model = jax_llama.Llama(cfg)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    pt = load_jax_params(
        pt_llama.Llama(pt_llama.LlamaConfig.tiny(dtype=torch.float32,
                                                 max_cache_len=96),
                       device="cpu"), jax.tree.map(np.asarray, params))
    return cfg, model, params, pt


@pytest.mark.parametrize("quant", ["", "int8"])
def test_fleet_real_engines_match_oracle_and_mixed_quant(tiny, quant):
    """Real tiny port engines, 2 replicas sharing one weight dict: every
    answer is JAX ``generate``'s greedy decode of the same weights (the
    int8 fleet against the JAX int8 model)."""
    cfg, model, params, pt = tiny
    p = np.arange(1, 7, dtype=np.int32)
    state = pt.state_dict()
    engines = []

    def factory():
        e = ContinuousBatchingEngine(pt, state, n_slots=2, chunk=4,
                                     quant=quant, device="cpu")
        engines.append(e)
        return e

    if quant:
        oracle_model = jax_llama.Llama(dataclasses.replace(cfg, quant=quant))
        oracle_params = jax_quant.quantize_llama_params(params)
    else:
        oracle_model, oracle_params = model, params
    oracle = np.asarray(jax_generate(
        oracle_model, oracle_params, p[None], max_new_tokens=5,
        temperature=0.0))[0, 6:]
    fleet = FleetFrontend(factory, replicas=2, max_queue=16).start()
    try:
        outs = []
        threads = [threading.Thread(target=lambda: outs.append(
            _post(fleet, {"tokens": p.tolist(), "max_new_tokens": 5},
                  timeout=300)["tokens"]))
            for _ in range(4)]
        for t in threads:
            t.start()
        _join(threads, timeout=300)
        assert len(outs) == 4
        for o in outs:
            assert o == oracle.tolist()
        if not quant:
            # the replicas share the caller's tensors
            for e in engines:
                assert (e._model.lm_head.kernel.data_ptr()
                        == state["lm_head.kernel"].data_ptr())
    finally:
        fleet.close()


def test_a_blocking_client_is_answered_when_its_request_ends():
    """Two requests in one burst: the short one is answered while the
    long one still decodes (the JAX worker answers both at the drain)."""
    fleet = _fake_fleet(lambda: _FakeEngine(delay=0.03), replicas=1,
                        max_queue=8)
    try:
        done = {}

        def client(name, n):
            _post(fleet, {"tokens": [1], "max_new_tokens": n})
            done[name] = time.monotonic()
            if name == "short":
                done["inflight"] = fleet.replica_states()[0]["inflight"]

        threads = [threading.Thread(target=client, args=("long", 60)),
                   threading.Thread(target=client, args=("short", 3))]
        for t in threads:
            t.start()
            time.sleep(0.05)
        _join(threads)
        # the long request still held the replica when the short one
        # was answered, and ended a second or more later
        assert done["inflight"] == 1
        assert done["long"] - done["short"] > 1.0
    finally:
        fleet.close()


def test_hang_detected_under_sustained_traffic():
    """Arrivals keep flowing at a wedged replica: the hang clock does not
    reset per submit (only an idle worker's first arrival resets it),
    so the verdict lands within ~hang_seconds and every parked client
    gets its 500."""
    gate = threading.Event()
    made = []

    def factory():
        e = _FakeEngine(block=None if made else gate)
        made.append(e)
        return e

    fleet = _fake_fleet(factory, replicas=1, max_queue=32,
                        hang_seconds=0.5, poll_seconds=0.05)
    try:
        results = []

        def client():
            try:
                _post(fleet, {"tokens": [1], "max_new_tokens": 2},
                      timeout=30)
                results.append("ok")
            except urllib.error.HTTPError as e:
                results.append(e.code)

        threads = []
        t_start = time.monotonic()
        for _ in range(15):
            t = threading.Thread(target=client)
            t.start()
            threads.append(t)
            time.sleep(0.1)
            if fleet.metrics.counter("server_replica_restarts_total",
                                     cause="hang").value:
                break
        verdict_at = time.monotonic() - t_start
        gate.set()
        _join(threads)
        assert fleet.metrics.counter(
            "server_replica_restarts_total", cause="hang").value >= 1, \
            f"no hang verdict under sustained traffic ({results})"
        assert verdict_at < 1.4, verdict_at
        assert 500 in results
    finally:
        gate.set()
        fleet.close()


def test_simultaneous_burst_spreads_across_replicas():
    """Routing happens under the admission lock, so a burst of
    concurrent arrivals sees each other's enqueues: with blocked
    engines, 6 requests at 2 replicas land 3 and 3."""
    gate = threading.Event()

    def factory():
        return _FakeEngine(block=gate)

    fleet = _fake_fleet(factory, replicas=2, max_queue=32)
    try:
        threads = [threading.Thread(
            target=lambda: _post(fleet, {"tokens": [1],
                                         "max_new_tokens": 2}))
            for _ in range(6)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            depths = [s["depth"] for s in fleet.replica_states()]
            if sum(depths) == 6:
                break
            time.sleep(0.02)
        assert sorted(depths) == [3, 3], depths
        gate.set()
        _join(threads)
    finally:
        gate.set()
        fleet.close()


def test_last_progress_writes_go_through_the_worker_lock():
    """last_progress is written by the engine thread and handler threads
    and read by the supervisor: every write goes through
    _touch_progress() under the worker lock."""
    w = EngineWorker(0, _FakeEngine, Registry())
    before = w.last_progress
    assert w._lock.acquire()
    t = threading.Thread(target=w._touch_progress)
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()                 # blocked on the worker lock
    assert w.last_progress == before
    w._lock.release()
    t.join(timeout=5)
    assert not t.is_alive()
    assert w.last_progress > before
    mid = w.last_progress
    w.engine.telemetry.decode_chunk(active=1, n_slots=1, n_tokens=1)
    assert w.last_progress >= mid


def test_scale_to_grows_and_shrinks_the_fleet():
    fleet = _fake_fleet(_FakeEngine, replicas=1, max_queue=8)
    try:
        assert fleet.scale_to(3) == 3
        assert [s["replica"] for s in fleet.replica_states()] == [0, 1, 2]
        assert _post(fleet, {"tokens": [1], "max_new_tokens": 2})[
            "tokens"] == [0, 1]
        assert fleet.scale_to(1) == 1
        assert fleet.metrics.counter("server_fleet_scalings_total",
                                     direction="shrink").value == 1
        with pytest.raises(ValueError, match="replicas must be >= 1"):
            fleet.scale_to(0)
    finally:
        fleet.close()


class _Recorder:
    """A telemetry stub that records every hook call."""

    def __init__(self):
        self.calls = []

    def request_admitted(self, rid):
        self.calls.append(("request_admitted", rid))

    def request_pages(self, rid, pages):
        self.calls.append(("request_pages", rid, pages))

    def admission_deferred(self, reason):
        self.calls.append(("admission_deferred", reason))

    def decode_chunk(self, active, n_slots, n_tokens, free_pages=None,
                     n_pages=None):
        self.calls.append(("decode_chunk", active, n_slots, n_tokens,
                           free_pages, n_pages))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_hooks_see_the_jax_engines_arguments(tiny, paged):
    """The same requests through the JAX and the port engines, a
    recording telemetry on each: the same calls with the same arguments
    in the same order. Paged, the pool (3 pages, one the dump page)
    cannot hold the second request beside the first, so it is
    deferred."""
    cfg, model, params, pt = tiny
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    budgets = [5, 2, 4]
    kw = dict(page_size=8, n_pages=3) if paged else {}
    seen = []
    for eng in (jax_serving.ContinuousBatchingEngine(model, params,
                                                     n_slots=2, chunk=4,
                                                     **kw),
                ContinuousBatchingEngine(pt, pt.state_dict(), n_slots=2,
                                         chunk=4, device="cpu", **kw)):
        eng.telemetry = _Recorder()
        for p, b in zip(prompts, budgets):
            eng.submit(p, b)
        eng.run()
        seen.append(eng.telemetry.calls)
    assert seen[1] == seen[0]
    names = {c[0] for c in seen[1]}
    assert names == ({"request_admitted", "request_pages",
                      "admission_deferred", "decode_chunk"} if paged
                     else {"request_admitted", "decode_chunk"})
