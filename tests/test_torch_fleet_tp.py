"""A tensor-parallel replica in the serving fleet, one gang a replica,
against the JAX package on the CPU.

ONE module-scoped ``FleetFrontend(GangReplica(..., np=2))`` serves an
int8 paged TP=2 engine (each rank builds its engine from the same JAX
tree) through HTTP on 127.0.0.1. Its gang runs on the CPU
(``launcher.WORKER_DEVICE = "cpu"``, two slots in a registry under the
module's tmp dir), bounded by the launcher's own timeouts as
``tests/test_torch_gang.py`` bounds its gangs; at most three gangs start
(the first, the respawn after a SIGKILLed rank, the respawn after a
wedged rank). The oracle is the JAX TP engine's greedy tokens on
``MeshSpec(data=4, model=2)`` (``tests/conftest.py``'s 8 CPU devices),
exactly, as ``tests/test_torch_tp_serving.py`` holds the port's TP
ranks to them, and the port's single-rank engine's.

cloudpickle sends this module's functions (the ranks' engine factory)
by value, so a rank imports the port and torch, never JAX."""

import functools
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.fleet import FleetFrontend, GangReplica
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree, load_jax_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CFG = dict(max_cache_len=64)
ENGINE = dict(n_slots=2, chunk=4, page_size=8, quant="int8")
# the no-token window of the replica's hang verdict
HANG_S = 5.0
# how long a test waits for a respawned gang to serve
RESPAWN_S = 60.0
# a long request: a burst in flight when its first token arrives
LONG = 48


def _requests():
    """test_torch_tp_serving.py's three requests (prompts of 5, 9 and 13
    tokens; budgets 6, 20, 7)."""
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 9, 13)]
    return [{"tokens": p.tolist(), "max_new_tokens": b}
            for p, b in zip(prompts, (6, 20, 7))]


def _rank_engine(flat):
    """Every rank: a TP=2 mesh over the gang and its int8 paged engine
    of the whole tree (the rank keeps its slice)."""
    import torch

    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec(model=2))
    model = load_jax_params(pt_llama.Llama(
        pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG),
        device="cpu"), flat)
    return ContinuousBatchingEngine(model, model.state_dict(), device="cpu",
                                    mesh=mesh, **ENGINE)


@pytest.fixture(scope="module")
def tree():
    """tiny's dense JAX tree, widened 1.7x (test_torch_tp_serving.py's)."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG)
    params = jax_llama.Llama(cfg).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)


def _serve(engine, reqs):
    rids = [engine.submit(r["tokens"], r["max_new_tokens"]) for r in reqs]
    res = engine.run()
    return [np.asarray(res[r]).tolist() for r in rids]


@pytest.fixture(scope="module")
def reference(tree):
    """The JAX TP engine's greedy tokens on data=4 x model=2 and the
    port's single-rank engine's, for the three requests and the long
    one."""
    reqs = _requests() + [dict(_requests()[1], max_new_tokens=LONG)]
    jeng = jax_serving.ContinuousBatchingEngine(
        jax_llama.Llama(jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG)),
        tree, mesh=jax_mesh.make_mesh(jax_mesh.MeshSpec(data=4, model=2)),
        quant_kernel="off", **ENGINE)
    model = load_jax_params(pt_llama.Llama(
        pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG), device="cpu"),
        flatten_jax_tree(jax.tree.map(np.asarray, tree)))
    single = ContinuousBatchingEngine(model, model.state_dict(),
                                      device="cpu", **ENGINE)
    return _serve(jeng, reqs), _serve(single, reqs)


@pytest.fixture(scope="module")
def fleet(tree, tmp_path_factory):
    """One gang replica behind the fleet; every gang it starts within
    60 s, each living at most 240 s, its ranks' survivors killed 2 s
    after a rank dies."""
    names = ("WORKER_DEVICE", "SLOT_DIR", "NUM_SLOTS", "START_TIMEOUT_S",
             "JOB_TIMEOUT_S", "ABORT_GRACE_S")
    saved = {n: getattr(launcher, n) for n in names}
    launcher.WORKER_DEVICE, launcher.NUM_SLOTS = "cpu", 2
    launcher.SLOT_DIR = str(tmp_path_factory.mktemp("fleet_tp_slots"))
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 240.0
    launcher.ABORT_GRACE_S = 2.0
    flat = flatten_jax_tree(jax.tree.map(np.asarray, tree))
    fl = None
    try:
        fl = FleetFrontend(
            GangReplica(functools.partial(_rank_engine, flat), np=2),
            replicas=1, max_queue=16, hang_seconds=HANG_S,
            poll_seconds=0.1).start()
        fl.seen_pids = set(fl._workers[0].pids)
        yield fl
    finally:
        if fl is not None and not fl._shutdown.is_set():
            fl.close()
        for n, v in saved.items():
            setattr(launcher, n, v)


def _post(fl, req, stream=False, on_first=None):
    """One /generate: (code, tokens, error) for a blocking request or a
    stream (a stream's error rides its terminal event); ``on_first`` is
    called at a stream's first token."""
    body = json.dumps(dict(req, stream=stream)).encode()
    r = urllib.request.Request(
        f"http://{fl.address[0]}:{fl.address[1]}/generate", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            if not stream:
                return resp.status, json.loads(resp.read())["tokens"], None
            toks = []
            for line in resp:
                if not line.startswith(b"data: "):
                    continue
                event = json.loads(line[6:])
                if "token" in event:
                    toks.append(event["token"])
                    if on_first is not None and len(toks) == 1:
                        on_first()
                elif "error" in event:
                    return 500, toks, event["error"]
                else:
                    return resp.status, toks, None
    except urllib.error.HTTPError as e:
        return e.code, None, str(e)
    return None, None, "stream ended without a terminal event"


def _burst(fl, reqs, streamed):
    """The requests at once, those of ``streamed`` (indices) as streams;
    their (code, tokens, error) in order."""
    out = [None] * len(reqs)

    def go(i):
        out[i] = _post(fl, reqs[i], stream=i in streamed)

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(150)
    return out


def _metric(fl, name, **labels):
    from sparkdl_tpu_torch.observe.metrics import Registry

    assert isinstance(fl.metrics, Registry)
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    line = f"{name}{{{want}}}" if labels else name
    for row in fl.metrics.to_prometheus().splitlines():
        if row.startswith(line + " "):
            return float(row.split()[-1])
    return 0.0


def _respawned(fl, old_pids):
    """Wait until the replica serves again on a new gang; its pids."""
    deadline = time.monotonic() + RESPAWN_S
    while time.monotonic() < deadline:
        w = fl._workers[0]
        if w.alive and w.pids and w.pids != old_pids:
            fl.seen_pids.update(w.pids)
            return w.pids
        time.sleep(0.1)
    raise AssertionError(f"no new gang within {RESPAWN_S:g}s: "
                         f"{fl.replica_states()}")


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.gang
def test_tp_replica_gives_the_jax_tp_engines_tokens(fleet, reference):
    """The three requests through HTTP, the odd ones streamed, then the
    same three the other way round: every request's tokens are the JAX
    TP engine's and the single-rank engine's, exactly, streamed equal to
    blocking; the fleet shows one replica, its gang two live ranks."""
    jax_toks, single = reference
    assert jax_toks[:3] == single[:3]
    reqs = _requests()
    first = _burst(fleet, reqs, streamed={1})
    second = _burst(fleet, reqs, streamed={0, 2})
    for i, (a, b) in enumerate(zip(first, second)):
        assert a[0] == b[0] == 200, (a, b)
        assert a[1] == b[1] == jax_toks[i], i
    states = fleet.replica_states()
    assert len(states) == 1 and states[0]["alive"]
    pids = fleet._workers[0].pids
    assert len(set(pids)) == 2 and not any(_gone(p) for p in pids)
    # a handler accounts its response just after writing it
    deadline = time.monotonic() + 10
    while (_metric(fleet, "server_requests_total", code="200") < 6
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert _metric(fleet, "server_requests_total", code="200") == 6


@pytest.mark.gang
def test_a_killed_rank_fails_its_burst_and_a_new_gang_serves(fleet,
                                                            reference):
    """A long blocking request in flight, then a long stream; rank 1
    SIGKILLed at the stream's first token: both end in 500, the
    replica's restart is counted as a death, every rank of the old gang
    is gone, and the new gang gives the JAX tokens again."""
    jax_toks, _ = reference
    old = list(fleet._workers[0].pids)
    long_req = dict(_requests()[1], max_new_tokens=LONG)
    out = {}

    def kill():
        os.kill(old[1], signal.SIGKILL)

    t = threading.Thread(target=lambda: out.setdefault(
        "blocking", _post(fleet, long_req)))
    t.start()
    deadline = time.monotonic() + 30
    while (fleet.replica_states()[0]["inflight"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    out["stream"] = _post(fleet, long_req, stream=True, on_first=kill)
    t.join(150)
    for key in ("stream", "blocking"):
        assert out[key][0] == 500, out
    assert len(out["stream"][1]) < LONG
    new = _respawned(fleet, old)
    assert _metric(fleet, "server_replica_restarts_total",
                   cause="death") == 1
    assert all(_gone(p) for p in old)
    got = _burst(fleet, _requests() + [long_req], streamed={1, 3})
    assert [g[1] for g in got] == jax_toks
    assert fleet._workers[0].pids == new


@pytest.mark.gang
def test_a_wedged_rank_is_declared_hung_and_replaced(fleet, reference):
    """Rank 1 stopped (SIGSTOP): a request gets 500 once the replica has
    shown no token for ``hang_seconds``; the restart is counted as a
    hang, the wedged gang is killed and a new one gives the JAX tokens
    again."""
    jax_toks, _ = reference
    old = list(fleet._workers[0].pids)
    os.kill(old[1], signal.SIGSTOP)
    t0 = time.monotonic()
    code, _, error = _post(fleet, _requests()[0])
    assert code == 500 and "hung" in error
    assert time.monotonic() - t0 >= HANG_S
    _respawned(fleet, old)
    assert _metric(fleet, "server_replica_restarts_total",
                   cause="hang") == 1
    assert all(_gone(p) for p in old)
    code, toks, _ = _post(fleet, _requests()[0])
    assert code == 200 and toks == jax_toks[0]


@pytest.mark.gang
def test_close_ends_every_gang_it_started(fleet):
    """At most three gangs started; after ``close()`` no rank process of
    any of them is alive."""
    assert len(fleet.seen_pids) <= 6
    fleet.close()
    assert all(_gone(p) for p in fleet.seen_pids), fleet.seen_pids
