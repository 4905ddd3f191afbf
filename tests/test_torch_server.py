"""The port's HTTP ServingFrontend on the CPU: a tiny int4 engine with
chunked prefill behind 127.0.0.1:0 answers blocking and streamed
requests with the engine's own tokens; the status classification (400,
500 and recovery, 503 at a dead engine loop) is held against the JAX
frontend on the same stub engine; the metrics registry renders what the
JAX registry renders."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sparkdl_tpu.models.server import ServingFrontend as JaxFrontend
from sparkdl_tpu.observe.metrics import Registry as JaxRegistry
from sparkdl_tpu.observe.metrics import (
    render_prometheus as jax_render_prometheus,
)
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.models.server import ServingFrontend
from sparkdl_tpu_torch.observe import metrics as pt_metrics

torch.set_num_threads(2)

TIMEOUT = 60
ENGINE = dict(n_slots=2, chunk=4, page_size=8, quant="int4",
              prefill_chunk=4, device="cpu")


def _url(fe, path):
    return f"http://{fe.address[0]}:{fe.address[1]}{path}"


def _post(fe, payload):
    req = urllib.request.Request(
        _url(fe, "/generate"), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _stream(fe, payload):
    req = urllib.request.Request(
        _url(fe, "/generate"),
        data=json.dumps(dict(payload, stream=True)).encode())
    events = []
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        for line in r:
            line = line.strip()
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
    return events


def _get(fe, path):
    try:
        with urllib.request.urlopen(_url(fe, path), timeout=TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post_code(fe, data):
    req = urllib.request.Request(_url(fe, "/generate"), data=data)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def tiny():
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, n_layers=1,
                                    max_cache_len=64, quant_group=32)
    model = pt_llama.init_weights(pt_llama.Llama(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0))
    return model


def _oracle(model, prompts, budgets):
    eng = ContinuousBatchingEngine(model, model.state_dict(), **ENGINE)
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    res = eng.run()
    return [(res[r].tolist(), eng.logprobs[r]) for r in rids]


@pytest.fixture(scope="module")
def frontend(tiny):
    eng = ContinuousBatchingEngine(tiny, tiny.state_dict(), **ENGINE)
    fe = ServingFrontend(eng).start()
    try:
        yield fe
    finally:
        fe.close()


def test_blocking_and_streamed_requests_return_the_engines_tokens(
        tiny, frontend):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (9, 5)]
    (toks0, lps0), (toks1, _) = _oracle(tiny, prompts, [6, 5])
    out = _post(frontend, {"tokens": prompts[0].tolist(),
                           "max_new_tokens": 6})
    assert out["tokens"] == toks0
    assert out["finish_reason"] == "length"
    np.testing.assert_allclose(out["logprobs"], lps0, atol=1e-6)
    events = _stream(frontend, {"tokens": prompts[1].tolist(),
                                "max_new_tokens": 5})
    assert events[-1] == {"done": "length"}
    assert [e["token"] for e in events[:-1]] == toks1


def test_concurrent_clients_each_get_their_tokens(tiny, frontend):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 11, 7)]
    oracle = _oracle(tiny, prompts, [4, 6, 3])
    results = [None] * 3

    def client(i):
        payload = {"tokens": prompts[i].tolist(),
                   "max_new_tokens": [4, 6, 3][i]}
        if i == 1:
            events = _stream(frontend, payload)
            results[i] = [e["token"] for e in events[:-1]]
        else:
            results[i] = _post(frontend, payload)["tokens"]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert results == [toks for toks, _ in oracle]


def test_a_short_request_is_answered_while_a_long_one_still_generates(
        tiny):
    """Results are posted as each request finishes, not when the burst
    drains: a short blocking request sent while a long streamed one is
    generating gets its answer before the long stream's ``done``, and
    both carry the tokens the engine gives them alone."""
    rng = np.random.default_rng(3)
    long_p, short_p = (rng.integers(0, 256, (n,)).astype(np.int32)
                       for n in (6, 5))
    long_n, short_n = 56, 3
    ((long_toks, _),) = _oracle(tiny, [long_p], [long_n])
    ((short_toks, short_lps),) = _oracle(tiny, [short_p], [short_n])

    eng = ContinuousBatchingEngine(tiny, tiny.state_dict(), **ENGINE)
    # after its first chunk (streamed to the client) the long request
    # waits until the short one is submitted, and each chunk takes at
    # least 5 ms: the short one is admitted mid-burst with most of the
    # long budget still to go
    submitted = threading.Event()
    submit, decode = eng.submit, eng._decode_chunk
    chunks = []

    def gated_submit(tokens, *a, **k):
        rid = submit(tokens, *a, **k)
        if len(tokens) == len(short_p):
            submitted.set()
        return rid

    def slow_decode(*a, **k):
        if chunks:
            submitted.wait(TIMEOUT)
        chunks.append(1)
        time.sleep(0.005)
        return decode(*a, **k)

    eng.submit, eng._decode_chunk = gated_submit, slow_decode
    fe = ServingFrontend(eng).start()
    try:
        events, first = [], threading.Event()

        def stream_long():
            req = urllib.request.Request(
                _url(fe, "/generate"),
                data=json.dumps({"tokens": long_p.tolist(),
                                 "max_new_tokens": long_n,
                                 "stream": True}).encode())
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                for line in r:
                    if line.startswith(b"data: "):
                        events.append(json.loads(line[6:].strip()))
                        first.set()

        t = threading.Thread(target=stream_long)
        t.start()
        assert first.wait(TIMEOUT)  # the long request is generating
        out = _post(fe, {"tokens": short_p.tolist(),
                         "max_new_tokens": short_n})
        seen = list(events)  # the long stream when the short one returned
        t.join(TIMEOUT)
        assert not t.is_alive()
    finally:
        fe.close()
    assert out["tokens"] == short_toks
    assert out["finish_reason"] == "length"
    np.testing.assert_allclose(out["logprobs"], short_lps, atol=1e-6)
    assert {"done": "length"} not in seen
    assert len(seen) < long_n
    assert events[-1] == {"done": "length"}
    assert [e["token"] for e in events[:-1]] == long_toks


@pytest.mark.parametrize("body", [
    b"{not json",
    json.dumps({"max_new_tokens": 4}).encode(),            # no tokens
    json.dumps({"tokens": [1, 2], "max_new_tokens": 0}).encode(),
    json.dumps({"tokens": [1, 2], "max_new_tokens": 10_000}).encode(),
    json.dumps({"tokens": [], "max_new_tokens": 2}).encode(),
])
def test_bad_body_is_400(frontend, body):
    assert _post_code(frontend, body) == 400
    # the box keeps serving
    assert _post(frontend, {"tokens": [1, 2, 3],
                            "max_new_tokens": 2})["finish_reason"] == "length"


def test_health_and_metrics(frontend):
    _post(frontend, {"tokens": [4, 5], "max_new_tokens": 2})
    code, body = _get(frontend, "/health")
    assert code == 200 and json.loads(body)["status"] == "ok"
    code, body = _get(frontend, "/healthz")
    assert code == 200
    assert json.loads(body) == {"status": "ok", "queue_depth": 0,
                                "engine_alive": True}
    code, body = _get(frontend, "/metrics")
    assert code == 200
    assert 'server_requests_total{code="200"}' in body
    assert "server_first_token_seconds_count" in body
    assert f'torch_version="{torch.__version__}"' in body
    assert _get(frontend, "/nope")[0] == 404


# -- status classification against the JAX frontend ----------------------


class _Cfg:
    max_cache_len = 64


class _StubEngine:
    """Engine-shaped stub: ``fault`` None serves, an Exception instance
    faults one run() (500), a BaseException instance kills the engine
    loop (503)."""

    def __init__(self, fault=None):
        self.cfg = _Cfg()
        self.fault = fault
        self.finish_reasons = {}
        self.logprobs = {}
        self._queued = {}
        self._next = 0
        self.aborted = 0

    def _worst_case_tokens(self, p_len, max_new):
        return p_len + max_new

    def submit(self, tokens, max_new_tokens, stop=None):
        rid = self._next
        self._next += 1
        self._queued[rid] = max_new_tokens
        return rid

    def run(self, progress=None, on_token=None):
        if self.fault is not None:
            fault, self.fault = self.fault, None
            raise fault
        out = {}
        for rid, n in self._queued.items():
            toks = np.arange(n, dtype=np.int32)
            for t in toks:
                on_token(rid, t)
            out[rid] = toks
            self.finish_reasons[rid] = "length"
            self.logprobs[rid] = [0.0] * n
        self._queued.clear()
        return out

    def abort_requests(self):
        self.aborted += 1
        self._queued.clear()


FRONTENDS = pytest.mark.parametrize("cls", [JaxFrontend, ServingFrontend],
                                    ids=["jax", "port"])


@FRONTENDS
def test_engine_fault_is_500_then_the_next_request_is_served(cls):
    eng = _StubEngine(fault=RuntimeError("boom"))
    fe = cls(eng).start()
    try:
        ok = json.dumps({"tokens": [1, 2], "max_new_tokens": 3}).encode()
        assert _post_code(fe, ok) == 500
        assert eng.aborted == 1
        assert _post_code(fe, ok) == 200
        assert _post_code(fe, b"[") == 400
        _, body = _get(fe, "/metrics")
        for code in ("200", "400", "500"):
            assert f'server_requests_total{{code="{code}"}} 1' in body
    finally:
        fe.close()


@FRONTENDS
def test_dead_engine_loop_is_503(cls):
    fe = cls(_StubEngine(fault=KeyboardInterrupt())).start()
    try:
        code = _post_code(fe, json.dumps({"tokens": [1],
                                          "max_new_tokens": 2}).encode())
        assert code == 503
        # the loop's finally may still be running: poll with a deadline
        deadline = time.monotonic() + TIMEOUT
        code, body = _get(fe, "/healthz")
        while code != 503 and time.monotonic() < deadline:
            time.sleep(0.05)
            code, body = _get(fe, "/healthz")
        assert code == 503
        body = json.loads(body)
        assert body["status"] == "unavailable"
        assert body["engine_alive"] is False
    finally:
        fe.close()


@FRONTENDS
def test_streamed_engine_fault_rides_an_error_event(cls):
    fe = cls(_StubEngine(fault=RuntimeError("boom"))).start()
    try:
        events = _stream(fe, {"tokens": [1, 2], "max_new_tokens": 2})
        assert events == [{"error": "engine error: boom"}]
        _, body = _get(fe, "/metrics")
        assert 'server_requests_total{code="500"} 1' in body
    finally:
        fe.close()


# -- the metrics registry -----------------------------------------------------


def _fill(reg):
    reg.counter("server_requests_total", code="200").inc(3)
    reg.counter("server_requests_total", code="400").inc()
    reg.gauge("server_queue_depth").set(2)
    h = reg.histogram("server_request_seconds", code="200")
    for v in (0.0004, 0.02, 0.02, 3.0, 100.0):
        h.observe(v)
    reg.histogram("tiny", buckets=(0.5, 1.0)).observe(0.75)
    return reg


def test_registry_renders_what_the_jax_registry_renders():
    jreg, treg = _fill(JaxRegistry()), _fill(pt_metrics.Registry())
    assert treg.to_prometheus() == jreg.to_prometheus()
    jdoc, tdoc = json.loads(jreg.to_json()), json.loads(treg.to_json())
    for doc in (jdoc, tdoc):
        doc.pop("generated_at")
        doc["series"][0].pop("ts")
    assert tdoc == jdoc
    snap = treg.snapshot()
    assert (pt_metrics.render_prometheus([({"replica": "0"}, snap)])
            == jax_render_prometheus([({"replica": "0"}, snap)]))
    with pytest.raises(ValueError, match="already registered"):
        treg.gauge("server_requests_total")
    with pytest.raises(ValueError, match="only go up"):
        treg.counter("c").inc(-1)


def test_build_info_labels():
    reg = pt_metrics.Registry()
    labels = pt_metrics.ensure_build_info(reg)
    assert set(labels) == {"git_sha", "torch_version", "device_kind"}
    assert labels["torch_version"] == torch.__version__
    assert labels["device_kind"] == (torch.cuda.get_device_name(0)
                                     if torch.cuda.is_available() else "none")
    assert 'build_info{device_kind="' in reg.to_prometheus()
