"""ServingTelemetry on the port's HTTP frontend against the JAX
frontend's: each over its tiny int8 engine with the same weights (the
port's loaded from the JAX tree), the same 4 requests (two streamed),
sent together: the same series names and counts, the same span tree a
request, the instants ordered ``request.submit <= request.admit <=
request.first_token <= request.done`` on each request's own track, the
engine's chunk and token counters against its own counts, the KV pool's
bytes as its memory category, and the run dir with its flight-recorder
ring.

The JAX side is switched on as its own tests do it
(``SPARKDL_TPU_TELEMETRY_DIR`` and its ``_reset_for_tests``); the port
by its module setting."""

import gc
import glob
import json
import os
import threading
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu import observe as jobs
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.models.server import ServingFrontend as JaxFrontend
from sparkdl_tpu.observe import flightrec as jflightrec
from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.server import ServingFrontend
from sparkdl_tpu_torch.models import serving as pt_serving
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.observe import mem

torch.set_num_threads(2)

TIMEOUT = 120
ENGINE = dict(n_slots=2, chunk=4, page_size=8, quant="int8")
DIMS = dict(d_model=256, vocab_size=512, n_heads=4, n_kv_heads=2,
            d_ff=512, n_layers=2, max_cache_len=64)
INSTANTS = ("request.submit", "request.admit", "request.first_token",
            "request.done")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **DIMS)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **DIMS)
    tmodel = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                             jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _requests():
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, 512, (n,)).tolist(),
             "max_new_tokens": m, "stream": bool(i % 2)}
            for i, (n, m) in enumerate(((3, 5), (9, 3), (6, 6), (4, 2)))]


def _call(fe, payload):
    req = urllib.request.Request(
        f"http://{fe.address[0]}:{fe.address[1]}/generate",
        data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        if not payload["stream"]:
            return json.loads(r.read())["tokens"]
        toks = []
        for line in r:
            if line.startswith(b"data: "):
                ev = json.loads(line[6:].strip())
                if "token" in ev:
                    toks.append(ev["token"])
        return toks


def _serve(frontend_cls, engine, count_chunks=False):
    """The 4 requests, sent together; returns (tokens by request, the
    run dir, the decode chunks the engine ran when counted)."""
    chunks = []
    if count_chunks:
        decode = engine._decode_chunk

        def counted(*a, **k):
            chunks.append(1)
            return decode(*a, **k)

        engine._decode_chunk = counted
    fe = frontend_cls(engine).start()
    payloads = _requests()
    out = [None] * len(payloads)
    try:
        def client(i):
            out[i] = _call(fe, payloads[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert all(o is not None for o in out)
    finally:
        fe.close()
    return out, fe.request_telemetry.run_dir, len(chunks)


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    jmodel, params, tmodel = models
    root = tmp_path_factory.mktemp("serving_telemetry")
    mp = pytest.MonkeyPatch()
    mp.setenv(jobs.TELEMETRY_DIR_ENV, str(root / "jax"))
    mp.setattr(observe, "TELEMETRY_DIR", str(root / "port"))
    jobs._reset_for_tests()
    observe._reset_for_tests()
    try:
        jeng = jax_serving.ContinuousBatchingEngine(
            jmodel, params, quant_kernel="off", **ENGINE)
        teng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(),
                                        device="cpu", **ENGINE)
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in (teng._cache.k, teng._cache.v))
        kv_pages = mem.category_bytes()["kv_pages"]
        jax_out = _serve(JaxFrontend, jeng)
        port_out = _serve(ServingFrontend, teng, count_chunks=True)
        stats = dict(teng.stats)
    finally:
        mp.undo()
        jobs._reset_for_tests()
        observe._reset_for_tests()
    return jax_out, port_out, stats, pool_bytes, kv_pages


def _metrics(run_dir):
    doc = json.load(open(os.path.join(run_dir, "metrics.json")))
    (series,) = doc["series"]
    assert series["labels"] == {"rank": "server"}
    out = {}
    for kind in ("counters", "gauges", "histograms"):
        for s in series[kind]:
            if s["name"] == "build_info":
                continue
            key = (s["name"], tuple(sorted(s["labels"].items())))
            out[key] = s.get("count", s.get("value"))
    return out


def _tracks(run_dir):
    doc = json.load(open(os.path.join(run_dir, "timeline.json")))
    tracks = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "serving":
            tracks.setdefault(e["tid"], []).append(e)
    return tracks


def test_same_tokens_series_names_and_request_counts(served):
    (jtoks, jdir, _), (ttoks, tdir, _), *_ = served
    assert ttoks == jtoks
    jm, tm = _metrics(jdir), _metrics(tdir)
    assert {k[0] for k in tm} == {k[0] for k in jm}
    n = len(_requests())
    for name in ("server_ttft_seconds", "server_queue_wait_seconds",
                 "server_tokens_per_sec", "engine_request_kv_pages"):
        assert tm[(name, ())] == jm[(name, ())] == n, name
    tokens = sum(len(t) for t in ttoks)
    assert tm[("server_generated_tokens_total", ())] == tokens
    assert jm[("server_generated_tokens_total", ())] == tokens
    assert tm[("server_requests_total", (("code", "200"),))] == n


def test_same_span_tree_and_ordered_instants(served):
    (_, jdir, _), (_, tdir, _), *_ = served
    shapes = []
    for run_dir in (jdir, tdir):
        tracks = _tracks(run_dir)
        assert len(tracks) == len(_requests())
        shape = set()
        for tid, events in tracks.items():
            names = sorted(e["name"] for e in events)
            shape.add(tuple(names))
            ts = {e["name"]: e["ts"] for e in events if e["ph"] == "i"}
            order = [ts[name] for name in INSTANTS]
            assert order == sorted(order), (run_dir, tid, ts)
            span = next(e for e in events if e["name"] == "request")
            assert span["ph"] == "X" and span["ts"] <= ts["request.submit"]
            done = next(e for e in events if e["name"] == "request.done")
            assert done["args"]["code"] == 200
        shapes.append(shape)
    assert shapes[0] == shapes[1] and len(shapes[1]) == 1


def test_engine_counters_pool_bytes_and_ring(served):
    _, (ttoks, tdir, chunks), stats, pool_bytes, kv_pages = served
    tm = _metrics(tdir)
    assert tm[("engine_decode_chunks_total", ())] == chunks
    assert tm[("engine_decode_tokens_total", ())] == stats[
        "active_slot_steps"]
    assert kv_pages == pool_bytes
    names = set(os.listdir(tdir))
    assert {"timeline.json", "metrics.prom", "metrics.json",
            "flightrec-rank-0.ring"} <= names
    ring = jflightrec.FlightRecorder.read_tail(
        os.path.join(tdir, "flightrec-rank-0.ring"))
    assert [e["name"] for e in ring].count("request.done") == len(ttoks)
    prom = open(os.path.join(tdir, "metrics.prom")).read()
    assert 'server_ttft_seconds_count{rank="server"} 4' in prom
    assert glob.glob(os.path.join(os.path.dirname(tdir), "run-*")) == [tdir]


def _pool(engine):
    return sum(t.numel() * t.element_size()
               for t in (engine._cache.k, engine._cache.v))


def test_categories_sum_live_engines_and_hold_none(models, tmp_path,
                                                   monkeypatch):
    *_, tmodel = models
    gc.collect()
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path))
    observe._reset_for_tests()
    try:
        # two replicas on one weight dict (as a fleet's): the pools add
        # up, the shared weights count once
        weights = tmodel.state_dict()
        spec = dict(ENGINE, quant=None)
        a = ContinuousBatchingEngine(tmodel, weights, device="cpu", **spec)
        b = ContinuousBatchingEngine(tmodel, weights, device="cpu", **spec)
        assert set(pt_serving._LIVE_ENGINES) == {a, b}
        cats = mem.category_bytes()
        assert cats["kv_pages"] == _pool(a) + _pool(b)
        assert cats["params"] == mem.tree_nbytes(weights)
        fe = ServingFrontend(a).start()
        assert _call(fe, dict(_requests()[0], stream=False))
        fe.close()
        gone = weakref.ref(a)
        del a, fe
        gc.collect()
        # closed and dropped, the engine is freed: only b is counted
        assert gone() is None
        assert mem.category_bytes()["kv_pages"] == _pool(b)
        del b
        gc.collect()
        assert mem.category_bytes()["kv_pages"] == 0
    finally:
        observe._reset_for_tests()
