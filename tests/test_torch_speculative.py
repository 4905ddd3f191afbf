"""The port's speculative decoding against the JAX package on the CPU:
``speculative_generate`` and ``SpeculativeBatchingEngine`` greedy
token-exact against the JAX ones from the same weights (same-weight,
perturbed, int8 and int4 drafts; dense and paged targets; prefix
caching; the k-token scratch reservation; stop sequences), with equal
round statistics; ``spec_sample_tokens``' output distribution exact;
the sampling rounds' plumbing; and the HTTP frontend answering over a
speculative engine."""

import dataclasses
import json
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
from sparkdl_tpu.models import speculative as jax_spec
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models import speculative as pt_spec
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.generate import generate
from sparkdl_tpu_torch.models.quant import quantize_llama_params
from sparkdl_tpu_torch.models.serving import (
    ContinuousBatchingEngine,
    SpeculativeBatchingEngine,
)
from sparkdl_tpu_torch.models.server import ServingFrontend

torch.set_num_threads(2)

L = 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, max_cache_len=L)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, max_cache_len=L)
    tmodel = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                             jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _draft(setup, kind):
    """(JAX draft model, JAX draft params, port draft model, port draft
    state dict) for a draft of ``kind``: the target's own weights, the
    weights perturbed (a draft that disagrees often), int8 or int4."""
    jmodel, params, tmodel = setup
    if kind in ("same", "noisy"):
        if kind == "noisy":
            params = jax.tree.map(
                lambda x: x + 0.3 * jax.random.normal(
                    jax.random.PRNGKey(99), x.shape, x.dtype)
                if x.ndim >= 2 else x, params)
        port = load_jax_params(pt_llama.Llama(tmodel.cfg, device="cpu"),
                               jax.tree.map(np.asarray, params))
        return jmodel, params, port, port.state_dict()
    bits = 8 if kind == "int8" else 4
    jq = jax_quant.quantize_llama_params(params, bits=bits)
    jd = jax_llama.Llama(dataclasses.replace(jmodel.cfg, quant=kind,
                                             quant_kernel="off"))
    tq = quantize_llama_params(tmodel.state_dict(), bits=bits, device="cpu")
    td = pt_llama.Llama(dataclasses.replace(tmodel.cfg, quant=kind),
                        device="meta")
    return jd, jq, td, tq


def _requests(seed=13):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 9, 7)]
    return prompts, [6, 20, 9]


def _engines_both(setup, kind, requests, prefix=None, stops=None, **kw):
    """The same requests through the JAX and the port speculative
    engines; asserts equal tokens, finish reasons and round statistics
    and returns the port engine and its tokens."""
    jmodel, params, tmodel = setup
    jd, jdp, td, tdp = _draft(setup, kind)
    prompts, budgets = requests
    stops = stops or [None] * len(prompts)
    engines = (jax_serving.SpeculativeBatchingEngine(
                   jmodel, params, jdp, draft_model=jd, n_slots=2, **kw),
               SpeculativeBatchingEngine(
                   tmodel, tmodel.state_dict(), tdp, draft_model=td,
                   n_slots=2, device="cpu", **kw))
    outs = []
    for eng in engines:
        pid = eng.register_prefix(prefix) if prefix is not None else None
        rids = [eng.submit(p, b, stop=st, prefix_id=(
            pid if pid is not None and np.array_equal(p[:len(prefix)],
                                                      prefix) else None))
            for p, b, st in zip(prompts, budgets, stops)]
        res = eng.run()
        outs.append(([res[r] for r in rids],
                     [eng.finish_reasons[r] for r in rids],
                     [eng.logprobs[r] for r in rids]))
    (jt, jr, jlp), (tt, tr, tlp) = outs
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t, np.asarray(j))
    for j, t in zip(jlp, tlp):
        np.testing.assert_allclose(t, j, atol=1e-4)
    assert tr == jr
    jeng, teng = engines
    for key in ("rounds", "proposed", "accepted", "acceptance_rate", "steps",
                "prefill_tokens_saved"):
        assert teng.stats[key] == jeng.stats.get(key, 0), key
    return teng, tt


def _plain(tmodel, requests, page_size=0, stops=None):
    eng = ContinuousBatchingEngine(tmodel, tmodel.state_dict(), n_slots=2,
                                   chunk=4, page_size=page_size, device="cpu")
    prompts, budgets = requests
    stops = stops or [None] * len(prompts)
    rids = [eng.submit(p, b, stop=s) for p, b, s in zip(prompts, budgets,
                                                        stops)]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind,page_size", [
    ("same", 0), ("noisy", 0), ("int8", 16), ("int4", 0)])
def test_engine_token_exact_against_jax_and_the_plain_engine(setup, kind,
                                                             page_size):
    """Three requests through two slots; the 20-token budget crosses a
    16-token page boundary on the paged target. The same-weight draft
    accepts everything; the perturbed one is mostly rejected; the
    output is the plain engine's either way."""
    requests = _requests()
    teng, toks = _engines_both(setup, kind, requests, k=3,
                               page_size=page_size)
    for t, want in zip(toks, _plain(setup[2], requests, page_size)):
        np.testing.assert_array_equal(t, want)
    if kind == "same":
        assert teng.stats["acceptance_rate"] == 1.0
    if kind == "noisy":
        assert teng.stats["acceptance_rate"] < 1.0
    if page_size:
        assert len(teng._free_pages) == teng.cfg.n_pages - 1


@pytest.mark.parametrize("page_size", [0, 16])
def test_prefix_caching_on_both_sides_is_exact(setup, page_size):
    """A registered 11-token prefix: the prefixed requests prefill only
    their suffix on the target and the draft; a perfect draft keeps
    acceptance at 1.0, which a draft prefix cache off by a position
    would break."""
    rng = np.random.default_rng(59)
    system = rng.integers(0, 256, (11,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 256, (n,))]).astype(
        np.int32) for n in (4, 6)]
    teng, toks = _engines_both(setup, "same", (prompts, [8, 8]),
                               prefix=system, k=3, page_size=page_size)
    assert teng.stats["prefill_tokens_saved"] == 2 * 11
    assert teng.stats["acceptance_rate"] == 1.0
    for t, want in zip(toks, _plain(setup[2], (prompts, [8, 8]))):
        np.testing.assert_array_equal(t, want)


def test_stop_sequences_and_eos_match_jax(setup):
    prompts, budgets = _requests(61)
    ref = _plain(setup[2], (prompts, budgets))
    stops = [[[int(ref[0][2]), int(ref[0][3])]], None, None]
    teng, toks = _engines_both(setup, "noisy", (prompts, budgets),
                               stops=stops, k=3)
    assert teng.finish_reasons[0] == "stop"
    np.testing.assert_array_equal(toks[0], ref[0][:4])
    _engines_both(setup, "int8", (prompts, budgets), k=2,
                  eos_id=int(ref[1][5]))


def test_scratch_reservation_and_capacity_guard(setup):
    """Page accounting includes the k-token verify scratch: 16 + 16
    tokens fill 2 pages of 16 exactly, and the scratch needs a third; a
    request that fits the cache only without the scratch is refused."""
    tmodel = setup[2]
    sd = tmodel.state_dict()
    eng = SpeculativeBatchingEngine(tmodel, sd, sd, n_slots=1, k=4,
                                    page_size=16, device="cpu")
    assert eng._pages_needed((0, np.zeros(16, np.int32), 16, None, 0)) == 3
    assert eng._worst_case_tokens(16, 16) == 36
    with pytest.raises(ValueError, match="speculation scratch"):
        eng.submit(np.zeros(5, np.int32), L - 5)
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeBatchingEngine(tmodel, sd, sd, k=0, device="cpu")
    multi = pt_llama.Llama(dataclasses.replace(tmodel.cfg, lora_rank=2,
                                               multi_lora=2), device="meta")
    with pytest.raises(ValueError, match="single-adapter only"):
        SpeculativeBatchingEngine(multi, {}, sd, device="cpu")


@pytest.mark.parametrize("kind", ["int8", "noisy"])
def test_speculative_generate_matches_jax(setup, kind):
    jmodel, params, tmodel = setup
    jd, jdp, td, tdp = _draft(setup, kind)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 6)).astype(
        np.int32)
    jout, jstats = jax_spec.speculative_generate(
        jmodel, params, jdp, prompt, max_new_tokens=14, k=3, draft_model=jd)
    tout, tstats = pt_spec.speculative_generate(
        tmodel, tmodel.state_dict(), tdp, prompt, max_new_tokens=14, k=3,
        draft_model=td, device="cpu")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tstats == jstats
    np.testing.assert_array_equal(
        tout.numpy(), generate(tmodel, None, prompt, max_new_tokens=14,
                               device="cpu").numpy())
    eos = int(tout[0, 6 + 5])
    jout, _ = jax_spec.speculative_generate(
        jmodel, params, jdp, prompt, max_new_tokens=14, k=3, draft_model=jd,
        eos_id=eos)
    tout, _ = pt_spec.speculative_generate(
        tmodel, None, tdp, prompt, max_new_tokens=14, k=3, draft_model=td,
        eos_id=eos, device="cpu")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    with pytest.raises(ValueError, match="speculation scratch"):
        pt_spec.speculative_generate(tmodel, None, tdp, prompt,
                                     max_new_tokens=L - 6, draft_model=td,
                                     device="cpu")


def _jax_marginal(q, p, k_pos=0):
    """The first output token's distribution under the JAX rule
    (``u * q(x) < p(x)`` accepts x ~ q; else a draw from the normalised
    max(p - q, 0)), in numpy from its definition."""
    accept = np.minimum(1.0, p[k_pos] / q[k_pos])
    resid = np.maximum(p[k_pos] - q[k_pos], 0.0)
    resid = resid / max(resid.sum(), 1e-30)
    return q[k_pos] * accept + (q[k_pos] * (1 - accept)).sum() * resid


def test_spec_sample_tokens_marginals_are_exact():
    """For every proposal x of the first step, the port's acceptance
    probability and residual give the first token's distribution
    sum_x q(x) [a(x) 1_x + (1 - a(x)) r] — equal to the target p to
    1e-6, and to the JAX rule's; then the sampler's draws hold that
    distribution."""
    V, k = 6, 2
    rng = np.random.default_rng(0)
    q0 = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal(V)) * 1.5),
                    np.float64)
    p0 = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal(V)) * 1.5),
                    np.float64)
    q = torch.as_tensor(np.stack([q0, q0]))[None].repeat(V, 1, 1)   # (V,k,V)
    p = torch.as_tensor(np.stack([p0, p0, p0]))[None].repeat(V, 1, 1)
    props = torch.arange(V)[:, None].repeat(1, k)  # row x proposes x
    accept, resid = pt_spec.spec_acceptance(q, p, props)
    a = accept[:, 0].numpy()
    marginal = q0 * a + (q0 * (1 - a)) @ resid[:, 0].numpy()
    np.testing.assert_allclose(marginal, p0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(marginal, _jax_marginal(
        np.stack([q0, q0]), np.stack([p0, p0, p0])), atol=1e-6, rtol=0)

    trials = 40_000
    gen = torch.Generator().manual_seed(42)
    qf = q[:1].float().repeat(trials, 1, 1)
    pf = p[:1].float().repeat(trials, 1, 1)
    proposals = torch.multinomial(qf.reshape(-1, V), 1, generator=gen
                                  ).reshape(trials, k)
    tokens, counts = pt_spec.spec_sample_tokens(qf, pf, proposals, gen)
    hist = np.bincount(tokens[:, 0].numpy(), minlength=V) / trials
    np.testing.assert_allclose(hist, p0, atol=0.015)
    overlap = float(np.minimum(p0, q0).sum())
    assert abs(float((counts >= 2).float().mean()) - overlap) < 0.02


def test_spec_sample_tokens_extremes_and_assemble_round_match_jax():
    """An identical draft accepts all k and draws the bonus; a disjoint
    one is rejected at once and resamples from p; assemble_round packs
    as the JAX one."""
    V, k, b = 8, 3, 64
    gen = torch.Generator().manual_seed(7)
    p = torch.softmax(torch.randn(b, k + 1, V, generator=gen), -1)
    props = torch.multinomial(p[:, :k].reshape(-1, V), 1,
                              generator=gen).reshape(b, k)
    tokens, counts = pt_spec.spec_sample_tokens(p[:, :k], p, props, gen)
    assert (counts == k + 1).all()
    torch.testing.assert_close(tokens[:, :k], props.to(torch.int32))
    p0 = torch.tensor([0.5, 0.5, 0.0, 0.0])
    q0 = torch.tensor([0.0, 0.0, 0.5, 0.5])
    props = torch.full((b, 2), 2)
    tokens, counts = pt_spec.spec_sample_tokens(
        q0.repeat(b, 2, 1), p0.repeat(b, 3, 1), props, gen)
    assert (counts == 1).all() and (tokens[:, 0] < 2).all()

    prop = np.array([[5, 6, 7], [1, 2, 3], [9, 9, 9]], np.int32)
    m = np.array([0, 3, 1], np.int32)
    final = np.array([40, 41, 42], np.int32)
    jt, jc = jax_spec.assemble_round(jnp.asarray(prop), jnp.asarray(m),
                                     jnp.asarray(final))
    tt, tc = pt_spec.assemble_round(torch.as_tensor(prop), torch.as_tensor(m),
                                    torch.as_tensor(final))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_sampling_rounds_hold_budgets_and_top_k_one_is_greedy(setup):
    """temperature > 0: rejection-sampling rounds over a perturbed draft
    keep budgets and the vocabulary; with top_k=1 both distributions
    collapse to their argmax and the output is the greedy one."""
    tmodel = setup[2]
    _, _, _, noisy = _draft(setup, "noisy")
    sd = tmodel.state_dict()
    prompts, budgets = _requests(29)
    eng = SpeculativeBatchingEngine(
        tmodel, sd, noisy, n_slots=2, k=3, temperature=0.8, device="cpu",
        generator=torch.Generator().manual_seed(1))
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    out = eng.run()
    for rid, b in zip(rids, budgets):
        assert len(out[rid]) == b and (out[rid] < 256).all()
    assert eng.stats["acceptance_rate"] < 1.0
    eng = SpeculativeBatchingEngine(tmodel, sd, noisy, n_slots=2, k=3,
                                    temperature=0.8, top_k=1, device="cpu")
    rid = eng.submit(prompts[0], 10)
    np.testing.assert_array_equal(eng.run()[rid],
                                  _plain(tmodel, ([prompts[0]], [10]))[0])


def test_http_frontend_serves_a_speculative_engine(setup):
    tmodel = setup[2]
    sd = tmodel.state_dict()
    eng = SpeculativeBatchingEngine(tmodel, sd, sd, n_slots=2, k=2,
                                    page_size=8, device="cpu")
    prompt = _requests()[0][1]
    want = _plain(tmodel, ([prompt], [7]))[0]
    fe = ServingFrontend(eng).start()
    try:
        url = f"http://{fe.address[0]}:{fe.address[1]}/generate"
        req = urllib.request.Request(url, data=json.dumps(
            {"tokens": prompt.tolist(), "max_new_tokens": 7}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        # the k scratch counts against the cache: one token too many
        req = urllib.request.Request(url, data=json.dumps(
            {"tokens": [1] * 10, "max_new_tokens": L - 11}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
    finally:
        fe.close()
    assert body["tokens"] == want.tolist()
    assert body["finish_reason"] == "length" and len(body["logprobs"]) == 7
