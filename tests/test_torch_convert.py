"""The port's HF Llama conversion (``sparkdl_tpu_torch.models.convert``)
against three oracles on one tiny ``transformers.LlamaForCausalLM``
built here from a seed (nothing is downloaded): HF's own forward and
``generate``, and the JAX package's ``params_from_hf`` and Llama.

Also: ``params_to_hf`` round-trips exactly and exports a tree HF runs;
the tied-embedding fallback; ``dtype=torch.bfloat16`` casts every
kernel, the head included; an unmapped tensor raises; ``rope_scaling``
translates as the JAX ``config_from_hf`` translates it; the converted
dict quantizes and serves through the int8 engine.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from sparkdl_tpu.models import convert as jax_convert
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu_torch.models import convert as pt_convert
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree
from sparkdl_tpu_torch.models.generate import generate
from sparkdl_tpu_torch.models.llama import Llama

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hf_pair():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-6,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).eval().float()
    with torch.no_grad():  # norms away from their ones, so each counts
        for name, p in hf_model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    cfg = pt_convert.config_from_hf(hf_cfg, dtype=torch.float32,
                                    max_cache_len=64)
    params = pt_convert.params_from_hf(hf_model.state_dict(), cfg)
    return hf_model, hf_cfg, cfg, params


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape)


def test_logits_match_hf_and_jax(hf_pair):
    hf_model, hf_cfg, cfg, params = hf_pair
    tokens = _tokens(0, (2, 12))
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(tokens)).logits.numpy()
        ours = Llama.from_params(cfg, params, device="cpu")(
            torch.from_numpy(tokens)).numpy()
    jcfg = jax_convert.config_from_hf(hf_cfg, dtype=jnp.float32,
                                      max_cache_len=64)
    jparams = jax_convert.params_from_hf(hf_model.state_dict(), jcfg)
    jax_logits = np.asarray(jax_llama.Llama(jcfg).apply(
        {"params": jparams}, jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours, jax_logits, atol=2e-4, rtol=2e-4)


def test_greedy_decode_matches_hf_generate(hf_pair):
    hf_model, _, cfg, params = hf_pair
    prompt = _tokens(1, (1, 7))
    with torch.no_grad():
        ref = hf_model.generate(torch.from_numpy(prompt), max_new_tokens=10,
                                do_sample=False, pad_token_id=0).numpy()
    model = Llama(cfg, device="meta")
    ours = generate(model, params, prompt, max_new_tokens=10,
                    temperature=0.0, device="cpu")
    np.testing.assert_array_equal(np.asarray(ours), ref)


def test_state_dict_is_the_jax_tree_flattened(hf_pair):
    hf_model, hf_cfg, cfg, params = hf_pair
    jcfg = jax_convert.config_from_hf(hf_cfg)
    want = flatten_jax_tree(jax_convert.params_from_hf(
        hf_model.state_dict(), jcfg))
    assert set(params) == set(want)
    assert set(params) == set(Llama(cfg, device="meta").state_dict())
    for name, value in params.items():
        assert value.dtype == torch.float32, name
        assert value.is_contiguous(), name
        np.testing.assert_array_equal(value.numpy(), want[name],
                                      err_msg=name)


def test_params_to_hf_round_trips_exactly_and_hf_runs_the_export(hf_pair):
    hf_model, _, cfg, params = hf_pair
    sd = hf_model.state_dict()
    back = pt_convert.params_to_hf(params, cfg)
    assert set(back) == set(sd)
    for name, value in back.items():
        assert torch.equal(value, sd[name]), name
    again = pt_convert.params_from_hf(back, cfg)
    for name, value in again.items():
        assert torch.equal(value, params[name]), name

    # a "fine-tune" of the port's model, exported, runs in HF
    model = Llama.from_params(
        cfg, {k: v.clone() for k, v in params.items()}, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 2:
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
    tuned = type(hf_model)(hf_model.config).eval()
    tuned.load_state_dict(pt_convert.params_to_hf(model.state_dict(), cfg))
    tokens = torch.from_numpy(_tokens(4, (2, 9)))
    with torch.no_grad():
        np.testing.assert_allclose(model(tokens).numpy(),
                                   tuned(tokens).logits.numpy(), atol=2e-4,
                                   rtol=2e-4)


def test_params_to_hf_casts_to_dtype(hf_pair):
    _, _, cfg, params = hf_pair
    out = pt_convert.params_to_hf(params, cfg, dtype=torch.bfloat16)
    assert {v.dtype for v in out.values()} == {torch.bfloat16}
    back = pt_convert.params_from_hf(out, cfg, dtype=torch.bfloat16)
    again = pt_convert.params_to_hf(back, cfg, dtype=torch.bfloat16)
    for name, value in out.items():  # bf16 in, bf16 out, bit for bit
        assert torch.equal(value, again[name]), name


def test_tied_embeddings_checkpoint(hf_pair):
    hf_model, _, cfg, _ = hf_pair
    sd = {k: v for k, v in hf_model.state_dict().items()
          if k != "lm_head.weight"}
    params = pt_convert.params_from_hf(sd, cfg)
    assert torch.equal(params["lm_head.kernel"],
                       params["embed.embedding"].t())
    assert params["lm_head.kernel"].is_contiguous()


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
def test_bfloat16_conversion_casts_every_kernel_the_head_included(
        hf_pair, tied):
    hf_model, _, cfg, _ = hf_pair
    sd = dict(hf_model.state_dict())
    if tied:
        del sd["lm_head.weight"]
    params = pt_convert.params_from_hf(sd, cfg, dtype=torch.bfloat16)
    for name, value in params.items():
        want = torch.float32 if name.endswith("scale") else torch.bfloat16
        assert value.dtype == want, name
    assert params["lm_head.kernel"].shape == (cfg.d_model, cfg.vocab_size)
    # a bf16 serving model over it tracks HF's fp32 forward
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    tokens = torch.from_numpy(_tokens(6, (1, 8)))
    with torch.no_grad():
        ours = Llama.from_params(bf16, params, device="cpu")(tokens)
        if tied:
            hf_model = type(hf_model)(hf_model.config).eval()
            hf_model.load_state_dict({**sd, "lm_head.weight":
                                      sd["model.embed_tokens.weight"]})
        ref = hf_model(tokens).logits
    err = (ours - ref).abs().max() / ref.abs().max()
    assert err < 3e-2, err


def test_an_unmapped_tensor_raises_and_harmless_buffers_pass(hf_pair):
    hf_model, _, cfg, _ = hf_pair
    sd = dict(hf_model.state_dict())
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    pt_convert.params_from_hf(sd, cfg)
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="q_proj.bias"):
        pt_convert.params_from_hf(sd, cfg)


def test_numpy_state_dicts_convert_too(hf_pair):
    hf_model, _, cfg, params = hf_pair
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    for name, value in pt_convert.params_from_hf(sd, cfg).items():
        assert torch.equal(value, params[name]), name


@pytest.mark.parametrize("scaling", [
    {"rope_type": "linear", "factor": 4.0},
    {"type": "linear", "factor": 2.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
], ids=["linear", "linear_legacy_key", "llama3"])
def test_rope_scaling_matches_jax(scaling):
    hf = types.SimpleNamespace(
        vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        intermediate_size=14336, rope_theta=500000.0, rms_norm_eps=1e-5,
        rope_scaling=scaling)
    ours = pt_convert.config_from_hf(hf)
    want = jax_convert.config_from_hf(hf)
    for field in ("rope_scaling", "vocab_size", "d_model", "n_layers",
                  "n_heads", "n_kv_heads", "d_ff", "rope_theta", "rms_eps"):
        assert getattr(ours, field) == getattr(want, field), field
    assert ours.dtype == torch.bfloat16


def test_unknown_rope_scaling_raises_as_in_jax():
    hf = types.SimpleNamespace(
        vocab_size=128, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=4, intermediate_size=96,
        rope_scaling={"rope_type": "yarn", "factor": 4.0})
    with pytest.raises(NotImplementedError, match="yarn"):
        pt_convert.config_from_hf(hf)
    with pytest.raises(NotImplementedError, match="yarn"):
        jax_convert.config_from_hf(hf)
    # no num_key_value_heads: MHA, as in JAX
    assert pt_convert.config_from_hf(types.SimpleNamespace(
        **{**vars(hf), "rope_scaling": None})).n_kv_heads == 4


def test_converted_checkpoint_serves_in_int8(hf_pair):
    """The path of chip_smoke.py phase 23d at a tiny width: the
    converted dict quantized by ``quantize_llama_params``, an int8
    model's logits within int8's error of HF's, and the paged engine's
    greedy tokens equal to ``generate()``'s on the same int8 model."""
    from sparkdl_tpu_torch.models.quant import quantize_llama_params
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    hf_model, _, cfg, params = hf_pair
    q = quantize_llama_params(params, device="cpu")
    cfg_q = dataclasses.replace(cfg, quant="int8")
    model = Llama.from_params(cfg_q, q, device="cpu")
    prompts = [_tokens(7 + i, (n,)) for i, n in enumerate((6, 11, 3))]
    with torch.no_grad():
        got = model(torch.from_numpy(prompts[1][None]))
        ref = hf_model(torch.from_numpy(prompts[1][None])).logits
    assert (got - ref).abs().max() / ref.abs().max() < 2e-2
    engine = ContinuousBatchingEngine(model, q, n_slots=2, chunk=4,
                                      page_size=8, device="cpu")
    rids = [engine.submit(p.astype(np.int32), 6) for p in prompts]
    results = engine.run()
    for rid, p in zip(rids, prompts):
        want = generate(model, None, p[None], max_new_tokens=6,
                        device="cpu")
        np.testing.assert_array_equal(np.asarray(results[rid]),
                                      np.asarray(want)[0, len(p):])
