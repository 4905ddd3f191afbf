"""Port training vs the JAX package on the CPU: both cross entropies,
the LM loss closure, and LoRA train steps (masked AdamW) from the same
weights and batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.parallel import train as jax_train
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import (
    flatten_jax_tree,
    load_jax_params,
)
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.parallel import train as pt_train

torch.set_num_threads(2)

VOCAB, SEQ = 256, 24


@pytest.mark.parametrize("ignore", [None, 3])
def test_cross_entropy_matches_jax(ignore):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    if ignore is not None:
        labels[0, :4] = ignore
    ref = jax_train.cross_entropy_loss(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       ignore_index=ignore)
    out = pt_train.cross_entropy_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      ignore_index=ignore)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


def test_cross_entropy_ignores_out_of_vocab_padding():
    logits = torch.randn(1, 4, 10, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, 2, -100, -100]])
    full = pt_train.cross_entropy_loss(logits[:, :2], labels[:, :2])
    assert torch.allclose(
        pt_train.cross_entropy_loss(logits, labels, ignore_index=-100), full)


@pytest.mark.parametrize("matmul_dtype", [None, "bf16"])
@pytest.mark.parametrize("ignore", [None, 5])
def test_fused_cross_entropy_matches_jax(ignore, matmul_dtype):
    """Value and hidden gradient, with a chunk (4) that does not divide
    S (10): the JAX function pads, the port takes a shorter last chunk."""
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 10, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 10)).astype(np.int32)
    if ignore is not None:
        labels[1, 6:] = ignore
    jdt = jnp.bfloat16 if matmul_dtype else None
    tdt = torch.bfloat16 if matmul_dtype else None

    def jax_loss(h, w_):
        return jax_train.fused_cross_entropy(
            h, w_, jnp.asarray(labels), chunk_size=4, ignore_index=ignore,
            matmul_dtype=jdt)

    ref, (rgh, rgw) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = pt_train.fused_cross_entropy(th, tw, torch.from_numpy(labels),
                                       chunk_size=4, ignore_index=ignore,
                                       matmul_dtype=tdt)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    for got, want in ((th.grad, rgh), (tw.grad, rgw)):
        want = np.asarray(want)
        # bf16 operands: the two frameworks round the backward's
        # products to bf16 at other points (JAX the logits' cotangent,
        # the port the product), a few bf16 ulps of the gradient's scale
        atol = 2.0 ** -5 * np.abs(want).max() if matmul_dtype else 1e-5
        np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_fused_cross_entropy_freezes_the_head():
    h = torch.randn(1, 6, 8, requires_grad=True)
    w = torch.randn(8, 12, requires_grad=True)
    out = pt_train.fused_cross_entropy(
        h, w, torch.zeros(1, 6, dtype=torch.long), chunk_size=4,
        freeze_head=True)
    out.backward()
    assert w.grad is None and h.grad is not None


def test_global_batch_and_param_count_match_jax(tree):
    ref = jax_train.global_batch(np.random.default_rng(4), VOCAB, 3, SEQ)
    out = pt_train.global_batch(np.random.default_rng(4), VOCAB, 3, SEQ)
    for k in ("inputs", "targets"):
        np.testing.assert_array_equal(out[k], ref[k])
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4)
    model = pt_llama.Llama(cfg, device="cpu")
    assert pt_train.param_count(model) == jax_train.param_count(tree)
    assert pt_train.param_count(model.state_dict()) == \
        jax_train.param_count(tree)


@pytest.fixture(scope="module")
def tree():
    """A tiny fp32 JAX LoRA tree with non-zero lora_b, so both adapters
    get gradients from the first step."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    params = jax.jit(jax_llama.Llama(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "lora_b":
            return 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, params)


def _batch(rows=4):
    return pt_train.global_batch(np.random.default_rng(2), VOCAB, rows, SEQ)


def _jax_run(tree, dtype, grad_accum, steps=3):
    cfg = jax_llama.LlamaConfig.tiny(dtype=dtype, lora_rank=4,
                                     attention="flash")
    model = jax_llama.Llama(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    mask = jax_lora.lora_mask(params)
    opt = optax.masked(optax.adamw(1e-3), mask)
    step = jax.jit(jax_train.make_train_step(
        jax_train.make_lm_loss_fn(model), opt, grad_accum=grad_accum,
        param_mask=mask))
    state = opt.init(params)
    batch = jax.tree.map(jnp.asarray, _batch())
    losses = []
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return losses, flatten_jax_tree(jax.tree.map(np.asarray, params))


def _port_run(tree, dtype, grad_accum=1, remat=False, cfg_remat=False,
              loss="logits", steps=3):
    cfg = pt_llama.LlamaConfig.tiny(dtype=dtype, lora_rank=4,
                                    attention="flash", remat=cfg_remat)
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu"), tree)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    mask = lora_mask(model)
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=1e-3,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = pt_train.make_train_step(
        pt_train.make_lm_loss_fn(model, loss=loss, chunk=10), opt,
        grad_accum=grad_accum, remat=remat, param_mask=mask, device="cpu")
    batch = _batch()
    losses = [step(batch)["loss"].item() for _ in range(steps)]
    return losses, model, start, mask


@pytest.fixture(scope="module")
def jax_runs(tree):
    return {ga: _jax_run(tree, jnp.float32, ga) for ga in (1, 2)}


@pytest.mark.parametrize("kwargs", [
    {}, {"grad_accum": 2}, {"cfg_remat": True}, {"remat": True},
    {"loss": "fused"}],
    ids=["plain", "grad_accum", "cfg_remat", "step_remat", "fused_loss"])
def test_lora_train_steps_match_jax(tree, jax_runs, kwargs):
    """3 masked-AdamW steps: per-step losses within 1e-5 relative, the
    adapters within 1e-5, every frozen weight bit-identical to its start.
    Remat and the fused loss compute the same values as the plain path,
    so they meet the JAX run's numbers too."""
    ref_losses, ref_params = jax_runs[kwargs.get("grad_accum", 1)]
    losses, model, start, mask = _port_run(tree, torch.float32, **kwargs)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for name, value in model.state_dict().items():
        if mask[name]:
            np.testing.assert_allclose(value.numpy(), ref_params[name],
                                       atol=1e-5, err_msg=name)
            assert not torch.equal(value, start[name]), name
        else:
            assert torch.equal(value, start[name]), name


def test_lora_train_steps_bf16_loss_matches_jax(tree):
    """bf16 activations and base weights, fp32 adapters and head on both
    sides: the losses within 2e-2 relative (bf16 rounds at other points
    in the two frameworks); a wrong master or head dtype moves them
    further."""
    ref_losses, _ = _jax_run(tree, jnp.bfloat16, 1)
    losses, model, _, _ = _port_run(tree, torch.bfloat16)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    attn = model.layers[0].attn
    assert attn.q_proj.kernel.dtype == torch.bfloat16
    assert attn.q_proj.lora_a.dtype == torch.float32
    assert model.lm_head.kernel.dtype == torch.float32


def test_train_step_argument_checks(tree):
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4)
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu"), tree)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    loss_fn = pt_train.make_lm_loss_fn(model)
    mask = lora_mask(model)
    with pytest.raises(ValueError, match="needs the model"):
        pt_train.make_train_step(lambda b: loss_fn(b), opt, param_mask=mask,
                                 device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        pt_train.make_train_step(loss_fn, opt, param_mask={"x": True},
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown loss"):
        pt_train.make_lm_loss_fn(model, loss="chunked")
    step = pt_train.make_train_step(loss_fn, opt, grad_accum=3,
                                    param_mask=mask, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(_batch(4))
    cfg2 = dataclasses.replace(cfg, n_layers=1)
    assert pt_train.param_count(pt_llama.Llama(cfg2, device="meta")) < \
        pt_train.param_count(model)
