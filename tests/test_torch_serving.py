"""Port serving engine vs the JAX ContinuousBatchingEngine on the CPU:
paged, int8, greedy — token-exact, with equal finish reasons and
logprobs, through refill, eos and stop sequences; plus the engine's
own admission control and the arguments this port refuses by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, chunk=4, page_size=8, quant="int8")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, n_layers=1,
                                      max_cache_len=64)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, n_layers=1,
                                     max_cache_len=64)
    tmodel = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                             jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _requests(vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    return prompts, [5, 2, 4]


def _serve_both(models, eos_id=None, stops=None):
    jmodel, params, tmodel = models
    prompts, budgets = _requests(tmodel.cfg.vocab_size)
    stops = stops or [None] * len(prompts)
    jeng = jax_serving.ContinuousBatchingEngine(
        jmodel, params, eos_id=eos_id, quant_kernel="off", **ENGINE)
    teng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(),
                                    eos_id=eos_id, device="cpu", **ENGINE)
    out = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, b, stop=st)
                for p, b, st in zip(prompts, budgets, stops)]
        res = eng.run()
        out.append((rids, res, dict(eng.finish_reasons),
                    dict(eng.logprobs), dict(eng.stats)))
    return out


def _assert_same(jax_out, port_out):
    jrids, jres, jreasons, jlps, jstats = jax_out
    trids, tres, treasons, tlps, tstats = port_out
    assert jrids == trids
    assert set(tres) == set(jres) == set(trids)
    for rid in trids:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"request {rid}")
        np.testing.assert_allclose(tlps[rid], jlps[rid], atol=1e-4,
                                   err_msg=f"request {rid} logprobs")
    assert treasons == jreasons
    for key in ("steps", "active_slot_steps", "total_slot_steps",
                "prefill_segments"):
        assert tstats[key] == jstats[key], key


def test_engine_token_exact_with_refill(models):
    """3 requests through 2 slots: the third admits mid-run into a
    freed slot's recycled pages."""
    jax_out, port_out = _serve_both(models)
    _assert_same(jax_out, port_out)
    assert set(port_out[2].values()) == {"length"}
    assert [len(port_out[1][r]) for r in port_out[0]] == [5, 2, 4]


def test_engine_token_exact_with_eos(models):
    # an eos that the plain run emits mid-stream for request 0
    _, (rids, res, *_rest) = _serve_both(models)
    eos = int(res[rids[0]][2])
    jax_out, port_out = _serve_both(models, eos_id=eos)
    _assert_same(jax_out, port_out)
    assert "eos" in port_out[2].values()


def test_engine_token_exact_with_stop(models):
    _, (rids, res, *_rest) = _serve_both(models)
    stop = [res[rids[2]][1:3].tolist()]
    jax_out, port_out = _serve_both(models, stops=[None, None, stop])
    _assert_same(jax_out, port_out)
    assert port_out[2][rids[2]] == "stop"


@pytest.mark.parametrize("kwargs,name", [
    (dict(mesh=object()), "mesh"),
    (dict(rules=object()), "rules"),
    (dict(prefill_chunk=4), "prefill_chunk"),
    (dict(quant="int4"), "int4"),
    (dict(quant_kernel="auto"), "quant_kernel"),
    (dict(page_size=0), "page_size=0"),
])
def test_unported_engine_arguments_raise_by_name(models, kwargs, name):
    tmodel = models[2]
    args = dict(n_slots=2, page_size=8, device="cpu")
    args.update(kwargs)
    with pytest.raises(NotImplementedError, match=name):
        ContinuousBatchingEngine(tmodel, tmodel.state_dict(), **args)


def test_unported_request_features_raise_by_name(models):
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="prefix_id"):
        eng.submit([1, 2, 3], 2, prefix_id="prefix-0")
    with pytest.raises(NotImplementedError, match="adapter_id"):
        eng.submit([1, 2, 3], 2, adapter_id=1)
    with pytest.raises(NotImplementedError, match="register_prefix"):
        eng.register_prefix([1, 2, 3])


def test_submit_validates_budget(models):
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], 0)
    with pytest.raises(ValueError, match="exceeds max_cache_len"):
        eng.submit(np.ones(60, np.int32), 5)
    with pytest.raises(ValueError, match="empty stop"):
        eng.submit([1, 2], 2, stop=[[]])


def test_pool_admission_control_and_dead_end(models):
    """A pool of 2 usable pages: a 1-page and a 2-page request serve
    one after the other (the second waits for the first's pages); one that
    needs 3 pages can never admit and raises instead of spinning."""
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, n_pages=3, device="cpu")
    a = eng.submit([1, 2, 3, 4], 4)       # 8 rows: 1 page
    b = eng.submit([5, 6, 7], 6)          # 9 rows: 2 pages, waits for a
    big = np.ones(12, np.int32)
    order = []
    res = eng.run(on_token=lambda rid, tok: order.append(rid))
    assert set(res) == {a, b} and sorted(eng._free_pages) == [1, 2]
    assert order == [a] * 4 + [b] * 6     # b admitted only after a
    eng.submit(big, 10)                   # 22 rows: 3 pages
    with pytest.raises(RuntimeError, match="pool exhausted"):
        eng.run()
    eng.abort_requests()
    assert not eng._queue and sorted(eng._free_pages) == [1, 2]


def test_abort_frees_active_slots(models):
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    total = len(eng._free_pages)
    eng.submit([1, 2, 3], 6)
    eng.submit([4, 5, 6, 7], 6)
    eng._fill_slots()
    assert len(eng._free_pages) < total
    eng.abort_requests()
    assert len(eng._free_pages) == total
    assert not any(s.active for s in eng._slots)
    assert eng.run() == {}


def test_temperature_sampling_is_seeded(models):
    tmodel = models[2]
    outs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(
            tmodel, tmodel.state_dict(), n_slots=2, page_size=8,
            temperature=0.9, top_p=0.9, device="cpu",
            generator=torch.Generator().manual_seed(3))
        rid = eng.submit([1, 2, 3], 6)
        outs.append(eng.run()[rid])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert len(outs[0]) == 6 and outs[0].max() < tmodel.cfg.vocab_size


def test_streaming_callback_sees_every_token(models):
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    seen = {}
    rid = eng.submit([3, 1, 4, 1, 5], 7)
    res = eng.run(on_token=lambda r, t: seen.setdefault(r, []).append(t))
    assert seen[rid] == res[rid].tolist()
    assert eng._on_token is None
