"""The port's multi-LoRA serving against the JAX package on the CPU: one
frozen base, adapters stacked by the JAX ``stack_lora_adapters`` and
carried over by ``from_jax`` (and stacked by the port's own from its
single-adapter state dicts), selected per request — token-exact against
the JAX engine, paged and dense, with an adapter-bound shared prefix;
the module against the JAX module; and the error contract."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.lora import (
    MultiLoRADense,
    stack_lora_adapters,
)
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

torch.set_num_threads(2)

CFG = dict(max_cache_len=96, lora_rank=4)


def _with_new_adapters(tree, seed):
    """tests/models/test_serving.py's second fine-tune: fresh lora_a and
    lora_b on the same frozen base."""
    k = jax.random.PRNGKey(seed)

    def leaf(path, x):
        nonlocal k
        if str(getattr(path[-1], "key", "")) in ("lora_a", "lora_b"):
            k, sub = jax.random.split(k)
            return jax.random.normal(sub, x.shape, x.dtype) * 0.05
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG)
    seedp = jnp.asarray(np.random.default_rng(12).integers(0, 256, (1, 8)),
                        jnp.int32)
    tree0 = jax_llama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                       seedp)["params"]
    # lora_b is zero at init: adapter 0 gets its own non-zero pair too
    trees = [_with_new_adapters(tree0, 3), _with_new_adapters(tree0, 1)]
    stacked = jax_lora.stack_lora_adapters(trees)
    jmulti = jax_llama.Llama(dataclasses.replace(jcfg, multi_lora=2))
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG)
    tmulti = load_jax_params(
        pt_llama.Llama(dataclasses.replace(tcfg, multi_lora=2),
                       device="cpu"), jax.tree.map(np.asarray, stacked))
    singles = [load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                               jax.tree.map(np.asarray, t)) for t in trees]
    return jmulti, stacked, tmulti, singles


def _solo(single, prompt, n):
    eng = ContinuousBatchingEngine(single, single.state_dict(), n_slots=1,
                                   chunk=4, device="cpu")
    rid = eng.submit(prompt, n)
    return eng.run()[rid]


def _both(setup, page_size, requests, prefix=None):
    """The same requests ((prompt, adapter, uses prefix) triples) through
    the JAX and the port multi-LoRA engines; returns the port's tokens
    and its engine after asserting the JAX engine's tokens equal them."""
    jmulti, stacked, tmulti, _ = setup
    outs, engines = [], []
    for eng in (jax_serving.ContinuousBatchingEngine(
                    jmulti, stacked, n_slots=2, chunk=4, page_size=page_size),
                ContinuousBatchingEngine(tmulti, tmulti.state_dict(),
                                         n_slots=2, chunk=4,
                                         page_size=page_size, device="cpu")):
        pid = (eng.register_prefix(prefix[0], adapter_id=prefix[1])
               if prefix is not None else None)
        rids = [eng.submit(p, 8, adapter_id=a,
                           prefix_id=pid if use else None)
                for p, a, use in requests]
        res = eng.run()
        outs.append([res[r] for r in rids])
        engines.append(eng)
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, np.asarray(j))
    return outs[1], engines[1]


@pytest.mark.parametrize("page_size", [0, 8])
def test_multi_lora_serving_matches_jax_and_per_adapter_engines(setup,
                                                                page_size):
    """tests/models/test_serving.py:397 on the port: one engine, one
    frozen base, adapters chosen per request, token-exact against the
    JAX engine on the same stacked weights, and each request equal to a
    single-adapter engine running its adapter."""
    singles = setup[3]
    rng = np.random.default_rng(12)
    rng.integers(0, 256, (1, 8))  # the JAX test's seed prompt comes first
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 7, 6)]
    adapters = [0, 1, 1]
    got, eng = _both(setup, page_size,
                     [(p, a, False) for p, a in zip(prompts, adapters)])
    for p, a, toks in zip(prompts, adapters, got):
        np.testing.assert_array_equal(toks, _solo(singles[a], p, 8),
                                      err_msg=f"adapter {a}")
    assert not np.array_equal(_solo(singles[0], prompts[1], 8), got[1])
    with pytest.raises(ValueError, match="outside the stacked range"):
        eng.submit(prompts[0], 4, adapter_id=5)
    with pytest.raises(ValueError, match="outside the stacked range"):
        eng.register_prefix(prompts[0], adapter_id=-1)


@pytest.mark.parametrize("page_size", [0, 8])
def test_prefix_multi_lora_compose(setup, page_size):
    """tests/models/test_serving.py:448 on the port: a prefix bound to
    adapter 1 shared by two adapter-1 requests, beside a plain adapter-0
    request; a request of adapter 0 may not use the prefix."""
    singles = setup[3]
    rng = np.random.default_rng(13)
    system = rng.integers(0, 256, (11,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 256, (n,))]).astype(
        np.int32) for n in (4, 6)]
    plain = rng.integers(0, 256, (6,)).astype(np.int32)
    requests = [(prompts[0], 1, True), (prompts[1], 1, True), (plain, 0, False)]
    got, eng = _both(setup, page_size, requests, prefix=(system, 1))
    for (p, a, _), toks in zip(requests, got):
        np.testing.assert_array_equal(toks, _solo(singles[a], p, 8))
    assert eng.stats["prefill_tokens_saved"] == 2 * 11
    with pytest.raises(ValueError, match="bound to adapter 1"):
        eng.submit(prompts[0], 4, prefix_id="prefix-0", adapter_id=0)


def test_port_stack_equals_the_carried_jax_stack(setup):
    """The port's stack_lora_adapters over its single-adapter state dicts
    (one of them trained: parameters that require grad) gives the tensors
    from_jax carried from the JAX stack, the base tensors not copied."""
    _, _, tmulti, singles = setup
    dicts = [s.state_dict(keep_vars=True) for s in singles]
    for name, p in dicts[0].items():
        if name.endswith("lora_a"):
            assert p.requires_grad
    stacked = stack_lora_adapters(dicts)
    want = tmulti.state_dict()
    assert set(stacked) == set(want)
    for name, t in stacked.items():
        torch.testing.assert_close(t.detach(), want[name], atol=0, rtol=0)
    assert stacked["embed.embedding"] is dicts[0]["embed.embedding"]
    assert stacked["layers.0.attn.q_proj.lora_a"].shape == (2, 64, 4)
    model = pt_llama.Llama.from_params(tmulti.cfg, stacked, device="cpu")
    assert isinstance(model.layers[1].attn.v_proj, MultiLoRADense)

    other = dict(singles[1].state_dict())
    other["layers.0.mlp.up_proj.kernel"] = other[
        "layers.0.mlp.up_proj.kernel"] + 1.0
    with pytest.raises(ValueError, match="base param layers.0.mlp.up_proj"
                                         ".kernel differs across adapter"):
        stack_lora_adapters([singles[0].state_dict(), other])


def test_multi_lora_dense_matches_the_jax_module():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    ids = np.array([2, 0, 2], np.int32)
    mod = jax_lora.MultiLoRADense(features=8, rank=4, alpha=16.0,
                                  n_adapters=3, dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                      jnp.asarray(ids))["params"]
    params = dict(params, lora_b=jax.random.normal(
        jax.random.PRNGKey(2), params["lora_b"].shape))
    want = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ids))
    port = MultiLoRADense(16, 8, 4, 16.0, 3, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("kernel", "lora_a", "lora_b"):
            getattr(port, name).copy_(torch.from_numpy(
                np.array(params[name])))
    got = port(torch.from_numpy(x), torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_multi_lora_logits_equal_each_single_adapter_model(setup):
    """Each row's logits through its adapter equal that adapter's own
    model's; a forward without adapter_ids takes adapter 0 (training
    and plain generation paths)."""
    _, _, tmulti, singles = setup
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 256, (2, 7)))
    got = tmulti(tokens, adapter_ids=torch.tensor([1, 0]))
    for row, a in ((0, 1), (1, 0)):
        torch.testing.assert_close(got[row], singles[a](tokens[row:row + 1])[0],
                                   atol=1e-5, rtol=0)
    torch.testing.assert_close(tmulti(tokens), singles[0](tokens), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match=r"adapter_ids must be \(2,\)"):
        tmulti(tokens, adapter_ids=torch.tensor([1]))


@pytest.mark.parametrize("kw,match", [
    (dict(lora_rank=4, lora_targets=("q_proj", "up_proj")),
     "attention adapter targets only"),
    (dict(quant="int8"), "mutually exclusive"),
    (dict(lora_rank=0), "requires lora_rank > 0"),
])
def test_multi_lora_config_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        pt_llama.LlamaConfig.tiny(multi_lora=2, **kw)
