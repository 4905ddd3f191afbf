"""Port serving engine vs the JAX ContinuousBatchingEngine on the CPU:
paged, int8 and int4, greedy — token-exact, with equal finish reasons,
logprobs and stats, through refill, eos and stop sequences, chunked
prefill and shared prefixes; plus the engine's own admission control
(shared prefix pages included) and the arguments this port refuses by
name."""

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
from sparkdl_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, chunk=4, page_size=8, quant="int8")
# int4 at group 32, so each d_model row of a projection spans 2 groups
GROUP = 32


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, n_layers=1,
                                      max_cache_len=64, quant_group=GROUP)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, n_layers=1,
                                     max_cache_len=64, quant_group=GROUP)
    tmodel = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                             jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _requests(vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    return prompts, [5, 2, 4]


def _serve_both(models, eos_id=None, stops=None, engine=ENGINE,
                requests=None, prefix=None):
    """The same requests through both engines. ``prefix``: registered
    on both first; then every prompt that extends it is submitted with
    its ``prefix_id``."""
    jmodel, params, tmodel = models
    prompts, budgets = requests or _requests(tmodel.cfg.vocab_size)
    stops = stops or [None] * len(prompts)
    jeng = jax_serving.ContinuousBatchingEngine(
        jmodel, params, eos_id=eos_id, quant_kernel="off", **engine)
    teng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(),
                                    eos_id=eos_id, device="cpu", **engine)
    out = []
    for eng in (jeng, teng):
        pid = eng.register_prefix(prefix) if prefix is not None else None
        rids = [eng.submit(p, b, stop=st, prefix_id=(
            pid if pid is not None and len(p) > len(prefix)
            and np.array_equal(p[:len(prefix)], prefix) else None))
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
    # the JAX engine adds prefill_tokens_saved at its first prefix use
    for key in ("steps", "active_slot_steps", "total_slot_steps",
                "prefill_segments", "prefill_tokens_saved",
                "utilization"):
        assert tstats[key] == jstats.get(key, 0), key


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


@pytest.mark.parametrize("kwargs,exc,name", [
    # mesh and rules are ported: the JAX engine's axes check
    (dict(mesh=Mesh(("data", "seq"), (1, 1))), ValueError,
     r"TP serving needs mesh axes 'model' and 'fsdp' \(missing \['fsdp', "
     r"'model'\]\)"),
    (dict(quant="int8", quant_kernel="off"), NotImplementedError,
     "quant_kernel"),
    (dict(quant="int4", quant_kernel="force_interpret"), NotImplementedError,
     "quant_kernel"),
    (dict(quant_kernel="auto"), NotImplementedError, "quant_kernel"),
    # the dense slot cache is ported; chunked prefill over it is refused
    # as the JAX engine refuses it
    (dict(page_size=0, prefill_chunk=4), ValueError,
     "prefill_chunk requires the paged cache"),
])
def test_unported_engine_arguments_raise_by_name(models, kwargs, exc, name):
    tmodel = models[2]
    args = dict(n_slots=2, page_size=8, device="cpu")
    args.update(kwargs)
    with pytest.raises(exc, match=name):
        ContinuousBatchingEngine(tmodel, tmodel.state_dict(), **args)


def test_unported_request_features_raise_by_name(models):
    """adapter_id is ported: on a single-adapter engine it raises the
    JAX engine's ValueError."""
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    with pytest.raises(ValueError, match="requires a multi_lora model"):
        eng.submit([1, 2, 3], 2, adapter_id=1)
    with pytest.raises(ValueError, match="requires a multi_lora model"):
        eng.register_prefix([1, 2, 3], adapter_id=1)


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


# -- int4, chunked prefill, shared prefixes --------------------------------


def test_int4_engine_token_exact(models):
    """quant="int4" quantizes the dense dict at construction (group 32)
    and serves token-exact against the JAX int4 engine."""
    jax_out, port_out = _serve_both(models,
                                    engine=dict(ENGINE, quant="int4"))
    _assert_same(jax_out, port_out)
    assert [len(port_out[1][r]) for r in port_out[0]] == [5, 2, 4]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_chunked_prefill_token_exact(models, quant):
    """prefill_chunk=4: the 9- and 6-token prompts prefill in 3 and 2
    segments, interleaved with the other slot's decode chunks."""
    jax_out, port_out = _serve_both(
        models, engine=dict(ENGINE, quant=quant, prefill_chunk=4))
    _assert_same(jax_out, port_out)
    assert port_out[4]["prefill_segments"] == 1 + 3 + 2


def _prefix_requests(vocab, p_len):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, (p_len,)).astype(np.int32)
    suffixes = [rng.integers(0, vocab, (n,)).astype(np.int32)
                for n in (1, 6, 3)]
    prompts = [np.concatenate([prefix, s]) for s in suffixes]
    # a request without the prefix rides along
    prompts.append(rng.integers(0, vocab, (5,)).astype(np.int32))
    return prefix, (prompts, [4, 3, 5, 2])


@pytest.mark.parametrize("p_len,prefill_chunk", [(11, 0), (11, 4), (16, 0)])
def test_prefix_sharing_token_exact(models, p_len, prefill_chunk):
    """A registered prefix of 11 tokens (one full page of 8 shared, the
    3-token boundary page copied per slot) or of 16 (two full pages,
    nothing copied): every extending request prefills its suffix only,
    token-exact against JAX, prefill_tokens_saved included."""
    prefix, requests = _prefix_requests(models[2].cfg.vocab_size, p_len)
    jax_out, port_out = _serve_both(
        models, engine=dict(ENGINE, prefill_chunk=prefill_chunk),
        requests=requests, prefix=prefix)
    _assert_same(jax_out, port_out)
    assert port_out[4]["prefill_tokens_saved"] == 3 * p_len


def test_prefix_request_matches_whole_prompt(models):
    """A prefix request's tokens and logprobs equal those of the same
    prompt prefilled whole on the port's own engine."""
    tmodel = models[2]
    prefix, (prompts, budgets) = _prefix_requests(tmodel.cfg.vocab_size, 11)
    outs = []
    for use_prefix in (True, False):
        eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(),
                                       device="cpu", **ENGINE)
        pid = eng.register_prefix(prefix) if use_prefix else None
        rid = eng.submit(prompts[1], 6, prefix_id=pid)
        outs.append((eng.run()[rid], eng.logprobs[rid]))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-5)


def test_shared_prefix_pages_admit_a_request_that_would_not_fit(models):
    """Pages of 8, a pool of 2 prefix pages + 2 free: a request of 16
    prefix tokens + 3 + a budget of 5 spans 3 pages, but shares the
    prefix's 2 full pages, so it needs 1 fresh page; two such requests
    run side by side, and the free pages come back."""
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, n_pages=5, device="cpu")
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, (16,)).astype(np.int32)
    pid = eng.register_prefix(prefix)
    assert len(eng._free_pages) == 2
    prompts = [np.concatenate([prefix, rng.integers(0, 256, (3,))])
               for _ in range(2)]
    rids = [eng.submit(p, 5, prefix_id=pid) for p in prompts]
    assert eng._pages_needed(eng._queue[0]) == 1
    eng._fill_slots()
    assert all(s.active for s in eng._slots)  # both admitted at once
    assert eng._tables[0, :2].tolist() == eng._tables[1, :2].tolist()
    res = eng.run()
    assert [len(res[r]) for r in rids] == [5, 5]
    assert len(eng._free_pages) == 2
    assert eng.stats["prefill_tokens_saved"] == 32
    # without the prefix the same prompt needs 3 pages: a dead end
    eng.submit(prompts[0], 5)
    with pytest.raises(RuntimeError, match="pool exhausted"):
        eng.run()


def test_prefix_and_prefill_chunk_validation(models):
    tmodel = models[2]
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatchingEngine(tmodel, tmodel.state_dict(), page_size=8,
                                 prefill_chunk=-1, device="cpu")
    with pytest.raises(ValueError, match="unknown quant"):
        ContinuousBatchingEngine(tmodel, tmodel.state_dict(), page_size=8,
                                 quant="int2", device="cpu")
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    with pytest.raises(ValueError, match="empty prefix"):
        eng.register_prefix([])
    with pytest.raises(ValueError, match="shorter than max_cache_len"):
        eng.register_prefix(np.ones(64, np.int32))
    pid = eng.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1, 2, 3, 4], 2, prefix_id="prefix-9")
    with pytest.raises(ValueError, match="extend the registered prefix"):
        eng.submit([1, 2, 3], 2, prefix_id=pid)
    with pytest.raises(ValueError, match="extend the registered prefix"):
        eng.submit([1, 2, 4, 5], 2, prefix_id=pid)


def test_abort_clears_staged_prefills(models):
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, prefill_chunk=4,
                                   device="cpu")
    total = len(eng._free_pages)
    eng.submit(np.arange(1, 20, dtype=np.int32), 4)
    eng._fill_slots()
    assert eng._prefilling and not eng._slots[0].active
    eng.abort_requests()
    assert not eng._prefilling and len(eng._free_pages) == total
    assert eng.run() == {}


def test_worst_case_hook_sizes_reservations(models):
    tmodel = models[2]
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   page_size=8, device="cpu")
    assert eng._worst_case_tokens(9, 7) == 16
    assert eng.telemetry is None
    eng.submit(np.ones(9, np.int32), 8)
    assert eng._pages_needed(eng._queue[0]) == 3
