"""Port Llama vs the JAX Llama on the CPU: RoPE tables, RMSNorm,
sampling, the paged decode model's logits from the same weights
(prefill, then single-token steps), dense and int8, and the training
forward with LoRA (the adapters, their mask and merge, logits and
hidden states)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import generate as jax_gen
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.models.quant import quantize_llama_params as jax_quantize
from sparkdl_tpu.ops.attention import flash_attention as jax_flash_attention
from sparkdl_tpu_torch.models import generate as pt_gen
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models import lora as pt_lora
from sparkdl_tpu_torch.models.from_jax import (
    flatten_jax_tree,
    load_jax_params,
)
from sparkdl_tpu_torch.models.quant import quantize_llama_params

torch.set_num_threads(2)

PAGE, N_PAGES, MAX_LEN = 8, 9, 32


@pytest.mark.parametrize("scaling", [
    None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 16)])
def test_rope_freqs_match(scaling):
    jc, js = jax_llama.rope_freqs(16, 64, 10000.0, scaling)
    tc, ts = pt_llama.rope_freqs(16, 64, 10000.0, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


def test_apply_rope_and_rmsnorm_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 5))
    jc, js = jax_llama.rope_freqs(16, 64, 500000.0)
    tc, ts = pt_llama.rope_freqs(16, 64, 500000.0)
    ref = jax_llama.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
    out = pt_llama.apply_rope(torch.from_numpy(x), tc, ts,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    scale = rng.standard_normal(16).astype(np.float32)
    jnorm = jax_llama.RMSNorm(1e-5)
    ref = jnorm.apply({"params": {"scale": jnp.asarray(scale)}},
                      jnp.asarray(x))
    norm = pt_llama.RMSNorm(16, 1e-5, "cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    np.testing.assert_allclose(norm(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.7),
                                         (7, 0.5)])
def test_restrict_logits_matches(top_k, top_p):
    logits = np.random.default_rng(top_k).standard_normal(
        (3, 40)).astype(np.float32)
    ref = jax_gen.restrict_logits(jnp.asarray(logits), top_k=top_k,
                                  top_p=top_p)
    out = pt_gen.restrict_logits(torch.from_numpy(logits), top_k=top_k,
                                 top_p=top_p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_greedy_sample_with_logprob_matches():
    logits = np.random.default_rng(3).standard_normal(
        (4, 50)).astype(np.float32)
    jt, jl = jax_gen.sample_logits_with_lp(
        jnp.asarray(logits), jax.random.PRNGKey(0), temperature=0.0)
    tt, tl = pt_gen.sample_logits_with_lp(torch.from_numpy(logits),
                                          temperature=0.0)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)


def test_temperature_sampling_follows_generator():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 30)).astype(np.float32))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        tok, lp = pt_gen.sample_logits_with_lp(logits, g, temperature=0.8,
                                               top_k=5)
        draws.append(tok)
        # every draw lies in the top-5 support, with a finite logprob
        top5 = torch.topk(logits, 5, dim=-1).indices
        assert bool((top5 == tok[:, None].long()).any(dim=-1).all())
        assert bool(torch.isfinite(lp).all())
    assert torch.equal(draws[0], draws[1])


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = jax_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    # spread the weights so int8 quantization is non-trivial
    return jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_paged_model_logits_match_jax(jax_params, quant):
    """Prefill 7 tokens into two rows' pages, then 3 single-token steps
    (the port's paged decode op on CPU tensors vs the JAX gather path)
    from the same weights: logits within 1e-4."""
    params = jax_quantize(jax_params) if quant else jax_params
    jcfg = jax_llama.LlamaConfig.tiny(
        dtype=jnp.float32, decode=True, page_size=PAGE, n_pages=N_PAGES,
        max_cache_len=MAX_LEN, paged_kernel="off", quant_kernel="off",
        quant=quant)
    tcfg = pt_llama.LlamaConfig.tiny(
        dtype=torch.float32, decode=True, page_size=PAGE, n_pages=N_PAGES,
        max_cache_len=MAX_LEN, quant=quant)
    tables = np.array([[3, 1, 4, 0], [2, 8, 5, 0]], np.int32)
    rng = np.random.default_rng(0)
    jm = jax_llama.Llama(jcfg)
    cache = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
                    positions=jnp.zeros((2, 1), jnp.int32),
                    block_tables=jnp.asarray(tables))["cache"]
    tm = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                         jax.tree.map(np.asarray, params))
    tcache = tm.init_cache()

    steps = [(rng.integers(0, 256, (2, 7)),
              np.broadcast_to(np.arange(7), (2, 7)))]
    steps += [(rng.integers(0, 256, (2, 1)), np.full((2, 1), 7 + i))
              for i in range(3)]
    for toks, pos in steps:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        ref, st = jm.apply({"params": params, "cache": cache},
                           jnp.asarray(toks), positions=jnp.asarray(pos),
                           block_tables=jnp.asarray(tables),
                           mutable=["cache"])
        cache = st["cache"]
        with torch.no_grad():
            out = tm(torch.from_numpy(toks), torch.from_numpy(pos),
                     torch.from_numpy(tables), tcache)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_from_params_shares_and_quantizes(jax_params):
    """The engine's construction path: a dense state dict → int8 dict
    (quantized like the JAX tree) → a model whose weights ARE those
    tensors."""
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32)
    dense = load_jax_params(pt_llama.Llama(cfg, device="cpu"),
                            jax.tree.map(np.asarray, jax_params))
    q = quantize_llama_params(dense.state_dict(), device="cpu")
    jq = flatten_jax_tree(jax.tree.map(np.asarray, jax_quantize(jax_params)))
    assert set(q) == set(jq)
    for name, value in jq.items():
        np.testing.assert_array_equal(q[name].numpy(), value, err_msg=name)
    qcfg = dataclasses.replace(cfg, quant="int8")
    model = pt_llama.Llama.from_params(qcfg, q, device="cpu")
    w = model.layers[1].mlp.down_proj.kernel_q
    assert w.dtype == torch.int8
    assert w.data_ptr() == q["layers.1.mlp.down_proj.kernel_q"].data_ptr()
    assert model.device == torch.device("cpu")


def test_loaders_reject_mismatched_trees(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    model = pt_llama.Llama(pt_llama.LlamaConfig.tiny(dtype=torch.float32),
                           device="cpu")
    broken = dict(tree)
    del broken["final_norm"]
    with pytest.raises(ValueError, match="missing.*final_norm"):
        load_jax_params(model, broken)
    state = dict(model.state_dict())
    state["lm_head.kernel"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="lm_head.kernel: shape"):
        pt_llama.Llama.from_params(model.cfg, state, device="cpu")


def test_only_the_paged_path_is_ported():
    with pytest.raises(NotImplementedError, match="int4"):
        pt_llama.LlamaConfig.tiny(quant="int4")
    with pytest.raises(ValueError, match="unknown quant"):
        pt_llama.LlamaConfig.tiny(quant="int2")
    model = pt_llama.Llama(pt_llama.LlamaConfig.tiny(n_layers=1),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        model(torch.zeros(1, 4, dtype=torch.long), torch.arange(4)[None],
              torch.zeros(1, 1, dtype=torch.int32), None)
    with pytest.raises(NotImplementedError, match="paged"):
        model.init_cache()


def test_llama3_8b_config_widths():
    cfg = pt_llama.LlamaConfig.llama3_8b()
    ref = jax_llama.LlamaConfig.llama3_8b()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "rope_theta", "rms_eps", "max_cache_len"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.dtype == torch.bfloat16
    assert pt_llama.LlamaConfig.llama3_8b(n_layers=2).n_layers == 2


# --- training forward and LoRA --------------------------------------------


def _spread_lora(params, seed=1):
    """A JAX LoRA tree with non-zero ``lora_b`` (the init zeros it), so
    both adapters carry signal and gradients."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "lora_b":
            return jnp.asarray(
                0.05 * rng.standard_normal(leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def lora_params():
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    params = jax.jit(jax_llama.Llama(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return _spread_lora(params)


def test_lora_dense_forward_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = {"kernel": rng.standard_normal((12, 10)).astype(np.float32),
         "lora_a": rng.standard_normal((12, 3)).astype(np.float32),
         "lora_b": rng.standard_normal((3, 10)).astype(np.float32)}
    g = rng.standard_normal((2, 5, 10)).astype(np.float32)
    jm = jax_lora.LoRADense(features=10, rank=3, alpha=6.0,
                            dtype=jnp.float32)

    def jax_loss(p, x_):
        return jnp.sum(jm.apply({"params": p}, x_) * g)

    jp = {k: jnp.asarray(v) for k, v in w.items()}
    ref = jm.apply({"params": jp}, jnp.asarray(x))
    jgrads, jgx = jax.grad(jax_loss, argnums=(0, 1))(jp, jnp.asarray(x))

    tm = pt_lora.LoRADense(12, 10, 3, 6.0, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in w.items():
            getattr(tm, k).copy_(torch.from_numpy(v))
    assert not tm.kernel.requires_grad
    assert tm.lora_a.requires_grad and tm.lora_b.dtype == torch.float32
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)
    for k in ("lora_a", "lora_b"):
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                   np.asarray(jgrads[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert tm.kernel.grad is None


@pytest.mark.parametrize("extra", [(), ("final_norm",), ("layer_1",)])
def test_lora_mask_marks_the_jax_leaves(lora_params, extra):
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4)
    model = pt_llama.Llama(cfg, device="cpu")
    ref = flatten_jax_tree(jax_lora.lora_mask(lora_params, extra))
    mask = pt_lora.lora_mask(model, extra)
    assert set(mask) == set(ref)
    assert mask == {k: bool(v) for k, v in ref.items()}
    assert sum(mask.values()) >= 8


def test_merge_lora_with_matches_jax(lora_params):
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4)
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu"),
                            jax.tree.map(np.asarray, lora_params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    merged = pt_lora.merge_lora_with(model, alpha=16.0, rank=4)
    ref = flatten_jax_tree(jax.tree.map(
        np.asarray, jax_lora.merge_lora_with(lora_params, 16.0, 4)))
    assert set(merged) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(merged[name].numpy(), value, atol=1e-6,
                                   err_msg=name)
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]), name


def _jax_flash_fn(q, k, v):
    return jax_flash_attention(q, k, v, causal=True, interpret=True)


@pytest.mark.parametrize("jax_attention", ["flash", "reference"])
def test_training_logits_and_hidden_match_jax(lora_params, jax_attention):
    """The training forward (attention="flash", the plain versions on
    the CPU) against the JAX model run through its flash kernel in
    interpret mode, and through its dense attention."""
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    jm = jax_llama.Llama(
        jcfg, attention_fn=_jax_flash_fn if jax_attention == "flash"
        else None)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4,
                                     attention="flash")
    tm = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                         jax.tree.map(np.asarray, lora_params))
    tokens = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(
        np.int32)
    apply = jax.jit(jm.apply, static_argnames="return_hidden")
    for hidden in (False, True):
        ref = apply({"params": lora_params}, jnp.asarray(tokens),
                    return_hidden=hidden)
        with torch.no_grad():
            out = tm(torch.from_numpy(tokens), return_hidden=hidden)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_reference_attention_and_remat_give_the_same_logits(lora_params):
    tree = jax.tree.map(np.asarray, lora_params)
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, 256, (2, 24)))
    outs = []
    for kw in ({"attention": "flash"}, {"attention": "reference"},
               {"attention": "flash", "remat": True}):
        cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4,
                                        **kw)
        model = load_jax_params(pt_llama.Llama(cfg, device="cpu"), tree)
        outs.append(model(tokens))
        outs[-1].sum().backward()
        outs[-1] = (outs[-1].detach(),
                    model.layers[0].attn.q_proj.lora_a.grad.clone())
    # dense vs flash: fp32, another summation order (logits and the
    # gradients of their sum up to ~40)
    for logits, grad in outs[1:]:
        np.testing.assert_allclose(logits.numpy(), outs[0][0].numpy(),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), outs[0][1].numpy(),
                                   atol=1e-4, rtol=1e-5)
    # remat recomputes the same ops: the same values exactly
    assert torch.equal(outs[2][0], outs[0][0])
    assert torch.equal(outs[2][1], outs[0][1])


def test_lora_targets_and_frozen_base():
    cfg = pt_llama.LlamaConfig.tiny(lora_rank=4, lora_targets=("k_proj",
                                                               "up_proj"))
    model = pt_llama.Llama(cfg, device="cpu")
    attn, mlp = model.layers[0].attn, model.layers[0].mlp
    assert isinstance(attn.k_proj, pt_lora.LoRADense)
    assert isinstance(mlp.up_proj, pt_lora.LoRADense)
    assert not isinstance(attn.q_proj, pt_lora.LoRADense)
    assert attn.k_proj.kernel.dtype == torch.bfloat16
    assert attn.k_proj.lora_a.dtype == torch.float32
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained == {n for n, m in pt_lora.lora_mask(model).items() if m}


def test_init_weights_follows_the_generator():
    cfg = pt_llama.LlamaConfig.tiny(lora_rank=4, d_model=128)
    models = [pt_llama.init_weights(pt_llama.Llama(cfg, device="cpu"),
                                    torch.Generator().manual_seed(3))
              for _ in range(2)]
    for (name, a), b in zip(models[0].state_dict().items(),
                            models[1].state_dict().values()):
        assert torch.equal(a, b), name
    layer = models[0].layers[0]
    assert bool((layer.attn_norm.scale == 1).all())
    assert bool((layer.attn.v_proj.lora_b == 0).all())
    w = layer.mlp.up_proj.kernel.float()
    assert abs(w.std().item() - 0.02) < 0.002 and abs(w.mean().item()) < 1e-3


def test_unported_training_options_raise_by_name():
    for name, value in (("flash_block", 64), ("multi_lora", 2),
                        ("n_experts", 4)):
        with pytest.raises(NotImplementedError, match=name):
            pt_llama.LlamaConfig.tiny(**{name: value})
    with pytest.raises(ValueError, match="lora_rank=0"):
        pt_llama.LlamaConfig.tiny(quant="int8", lora_rank=4)
    with pytest.raises(ValueError, match="attention"):
        pt_llama.LlamaConfig.tiny(attention="ring")
    cfg = pt_llama.LlamaConfig.tiny(n_layers=1)
    for name in ("attention_fn", "paged_attention_fn"):
        with pytest.raises(NotImplementedError, match=name):
            pt_llama.Llama(cfg, device="cpu", **{name: _jax_flash_fn})
    model = pt_llama.Llama(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="adapter_ids"):
        model(torch.zeros(1, 4, dtype=torch.long),
              adapter_ids=torch.zeros(1))
