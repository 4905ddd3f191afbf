"""The port's dense slot cache, ``generate()`` and the ``page_size=0``
engine against the JAX package on the CPU, from the same weights: the
cache's slot-mapped and shared-index logits against the JAX decode
forward (a rewind over junk rows included), ``generate`` greedy tokens
and logprobs against JAX ``generate`` (eos and overflow too), and the
dense engine token-exact against the JAX engine, with and without a
shared prefix."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import generate as jax_generate
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.models import speculative as jax_spec
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.generate import generate
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.models.speculative import set_cache_index

torch.set_num_threads(2)

L = 48


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, n_layers=2,
                                      max_cache_len=L)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    # wider weights than the init's, so that greedy tokens vary
    params = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, n_layers=2,
                                     max_cache_len=L)
    tmodel = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                             jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _jax_decode(models):
    jmodel, params, _ = models
    return jax_llama.Llama(dataclasses.replace(jmodel.cfg, decode=True))


def _port_decode(models):
    tmodel = models[2]
    return pt_llama.Llama.from_params(
        dataclasses.replace(tmodel.cfg, decode=True), tmodel.state_dict(),
        device="cpu")


def _close(port, jax_out, atol=1e-4):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


def test_slot_mapped_logits_match_the_jax_decode_forward(models):
    """Two rows at their own positions: a prefill of 6 and 9 tokens
    (row 0's tail is junk past its end), then two single-token steps at
    positions (B,) and (B, 1)."""
    jdec, params = _jax_decode(models), models[1]
    tdec = _port_decode(models)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    cache = jdec.init(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
                      positions=jnp.zeros((2, 1), jnp.int32))["cache"]
    jl, st = jdec.apply({"params": params, "cache": cache}, toks,
                        positions=pos, mutable=["cache"])
    tc = tdec.init_cache(batch=2)
    tl = tdec(torch.as_tensor(toks), torch.as_tensor(pos), cache=tc)
    _close(tl, jl)
    for step, shape in ((0, (2,)), (1, (2, 1))):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        p = np.array([[6 + step], [9 + step]], np.int32)
        jl, st = jdec.apply({"params": params, "cache": st["cache"]}, nxt,
                            positions=p, mutable=["cache"])
        tl = tdec(torch.as_tensor(nxt), torch.as_tensor(p.reshape(shape)),
                  cache=tc)
        _close(tl, jl)
    assert tc.index == 0  # slot-mapped calls leave the shared index


def test_shared_index_logits_and_rewind_over_junk(models):
    """A prefill of 7, 3 junk steps, a rewind to 7 (the JAX
    ``set_cache_index``), then the true next token: its logits equal the
    JAX run's and a run that never wrote the junk."""
    jdec, params = _jax_decode(models), models[1]
    tdec = _port_decode(models)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, (2, 7)).astype(np.int32)
    junk = rng.integers(0, 256, (3, 2, 1)).astype(np.int32)
    nxt = rng.integers(0, 256, (2, 2)).astype(np.int32)

    jl, st = jdec.apply({"params": params}, prompt, mutable=["cache"])
    tc = tdec.init_cache(batch=2)
    _close(tdec(torch.as_tensor(prompt), cache=tc), jl)
    jc = st["cache"]
    for j in junk:
        _, st = jdec.apply({"params": params, "cache": jc}, j,
                           mutable=["cache"])
        jc = st["cache"]
        tdec(torch.as_tensor(j), cache=tc)
    assert tc.index == 10
    jl, _ = jdec.apply({"params": params,
                        "cache": jax_spec.set_cache_index(jc, 7)}, nxt,
                       mutable=["cache"])
    tl = tdec(torch.as_tensor(nxt), cache=set_cache_index(tc, 7))
    _close(tl, jl)
    assert tc.index == 9
    clean = tdec.init_cache(batch=2)
    tdec(torch.as_tensor(prompt), cache=clean)
    torch.testing.assert_close(tl, tdec(torch.as_tensor(nxt), cache=clean),
                               atol=1e-5, rtol=0)


def test_dense_cache_contract(models):
    tdec = _port_decode(models)
    with pytest.raises(ValueError, match="batch"):
        tdec.init_cache()
    tc = tdec.init_cache(batch=1)
    assert tuple(tc.k.shape) == (2, 1, L, 2, 16) and tc.index == 0
    with pytest.raises(ValueError, match="needs a cache"):
        tdec(torch.zeros(1, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="block_tables belong"):
        tdec(torch.zeros(1, 3, dtype=torch.long), torch.arange(3)[None],
             torch.zeros(1, 1, dtype=torch.int32), tc)
    set_cache_index(tc, L - 2)
    with pytest.raises(ValueError, match="exceeds max_cache_len"):
        tdec(torch.zeros(1, 3, dtype=torch.long), cache=tc)


def test_generate_greedy_tokens_and_logprobs_match_jax(models):
    jmodel, params, tmodel = models
    prompt = np.random.default_rng(2).integers(0, 256, (2, 5)).astype(
        np.int32)
    jout, jlp = jax_generate.generate(jmodel, params, prompt,
                                      max_new_tokens=9,
                                      return_logprobs=True)
    tout, tlp = generate(tmodel, tmodel.state_dict(), prompt,
                         max_new_tokens=9, return_logprobs=True,
                         device="cpu")
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (2, 14)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    _close(tlp, jlp)
    # params=None: the model's own weights
    np.testing.assert_array_equal(
        generate(tmodel, None, prompt, max_new_tokens=9,
                 device="cpu").numpy(), np.asarray(jout))


def test_generate_eos_cut_and_overflow_match_jax(models):
    jmodel, params, tmodel = models
    prompt = np.random.default_rng(3).integers(0, 256, (1, 6)).astype(
        np.int32)
    full = np.asarray(jax_generate.generate(jmodel, params, prompt,
                                            max_new_tokens=10))
    # the prefill token is exempt; a later one ends the loop
    lengths = []
    for e in (int(full[0, 6 + 3]), int(full[0, 6])):
        jout = np.asarray(jax_generate.generate(
            jmodel, params, prompt, max_new_tokens=10, eos_id=e))
        tout = generate(tmodel, None, prompt, max_new_tokens=10, eos_id=e,
                        device="cpu")
        np.testing.assert_array_equal(tout.numpy(), jout)
        lengths.append(tout.shape[1])
    # cut after the fourth new token (unless an earlier one is eos too)
    assert lengths[0] <= 6 + 4
    with pytest.raises(ValueError, match="exceeds max_cache_len"):
        generate(tmodel, None, prompt, max_new_tokens=L - 5, device="cpu")


def test_generate_sampling_is_seeded_and_top_k_one_is_greedy(models):
    tmodel = models[2]
    prompt = np.random.default_rng(4).integers(0, 256, (2, 4))
    greedy = generate(tmodel, None, prompt, max_new_tokens=6, device="cpu")
    outs = [generate(tmodel, None, prompt, max_new_tokens=6,
                     temperature=0.9, top_p=0.9, device="cpu",
                     generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1])
    topk1 = generate(tmodel, None, prompt, max_new_tokens=6,
                     temperature=0.7, top_k=1, device="cpu",
                     generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(topk1, greedy)


def _requests(vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    return prompts, [5, 2, 4]


def _serve_both(models, engine, prefix=None, eos_id=None):
    jmodel, params, tmodel = models
    prompts, budgets = _requests(256)
    if prefix is not None:
        prompts = [np.concatenate([prefix, p]) for p in prompts[:2]] \
            + prompts[2:]
    jeng = jax_serving.ContinuousBatchingEngine(
        jmodel, params, eos_id=eos_id,
        **({"quant_kernel": "off"} if engine.get("quant") else {}),
        **engine)
    teng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(),
                                    eos_id=eos_id, device="cpu", **engine)
    out = []
    for eng in (jeng, teng):
        pid = eng.register_prefix(prefix) if prefix is not None else None
        rids = [eng.submit(p, b, prefix_id=(
            pid if prefix is not None and i < 2 else None))
            for i, (p, b) in enumerate(zip(prompts, budgets))]
        res = eng.run()
        out.append(([res[r] for r in rids], dict(eng.finish_reasons),
                    [eng.logprobs[r] for r in rids], dict(eng.stats)))
    (jt, jr, jlp, js), (tt, tr, tlp, ts) = out
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t, np.asarray(j))
    for j, t in zip(jlp, tlp):
        np.testing.assert_allclose(t, j, atol=1e-4)
    assert tr == jr
    for key in ("steps", "active_slot_steps", "total_slot_steps",
                "prefill_segments", "prefill_tokens_saved", "utilization"):
        assert ts[key] == js.get(key, 0), key
    return out


@pytest.mark.parametrize("quant", ["", "int8"])
def test_dense_engine_token_exact(models, quant):
    """3 requests through 2 dense slots: the third is prefilled into a
    freed slot whose rows still hold the earlier request's K/V."""
    out = _serve_both(models, dict(n_slots=2, chunk=4, quant=quant))
    assert [len(t) for t in out[1][0]] == [5, 2, 4]


def test_dense_engine_with_prefix_and_eos_token_exact(models):
    prefix = np.random.default_rng(12).integers(0, 256, (11,)).astype(
        np.int32)
    _, port = _serve_both(models, dict(n_slots=2, chunk=4), prefix=prefix)
    assert port[3]["prefill_tokens_saved"] == 2 * 11
    eos = int(port[0][0][2])
    _, port = _serve_both(models, dict(n_slots=2, chunk=4), prefix=prefix,
                          eos_id=eos)
    assert "eos" in port[1].values()


def test_dense_engine_refuses_prefill_chunk(models):
    tmodel = models[2]
    with pytest.raises(ValueError, match="requires the paged cache"):
        ContinuousBatchingEngine(tmodel, tmodel.state_dict(),
                                 prefill_chunk=4, device="cpu")
