"""The port's mixture of experts against the JAX package on the CPU, fp32
at the JAX tests' sizes (``tests/models/test_moe.py``,
``test_moe_llama.py``): the gates, the load-balance and aux losses (exact
ties included: the port selects JAX's experts), ``MoEMLP`` outputs and
gradients, E = 1 against the dense MLP, the MoE Llama forward at
``moe_every`` 1 and 2, the intermediates tree and the aux loss's
gradient with and without ``remat``, LoRA on an MoE model, greedy
``generate()``, the engine paged and dense, int8 and int4 and with
stacked adapters, token-exact against the JAX engine, the sharding rules of the expert leaves, and
training with the aux loss. The expert-parallel binders and the
tensor-parallel MoE engine are held in ``tests/test_torch_moe_parallel.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import generate as jax_generate
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import moe as jax_moe
from sparkdl_tpu.models import quant as jax_quant
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel import sharding as jax_sharding
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models import moe as pt_moe
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree, load_jax_params
from sparkdl_tpu_torch.models.generate import generate
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.models.quant import quantize_llama_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.parallel import sharding as pt_sharding
from sparkdl_tpu_torch.parallel import train as pt_train
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh

torch.set_num_threads(2)

MOE = dict(d_model=16, d_ff=32, n_experts=4, top_k=2)
LLAMA = dict(n_experts=4, moe_top_k=2, max_cache_len=48, quant_group=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _boost_router(tree):
    """test_moe_llama.py's boost: the router weights x 40, so routing is
    decisive (a fresh router is near-uniform and top-k membership would
    tie-break on float noise between computation orders)."""
    def leaf(path, x):
        keys = [str(getattr(p, "key", "")) for p in path]
        return x * 40.0 if "router" in keys and keys[-1] == "kernel" else x

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def mlp():
    """A JAX MoEMLP, its params and input (test_moe.py's), and the
    port's module loaded from them."""
    cfg = jax_moe.MoEConfig(**MOE)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 16), jnp.float32)
    params = jax_moe.MoEMLP(cfg).init(jax.random.PRNGKey(0), x)["params"]
    port = load_jax_params(pt_moe.MoEMLP(pt_moe.MoEConfig(**MOE), "cpu"),
                           _np(params))
    return cfg, params, x, port


def _jax_cfg(**kw):
    return jax_llama.LlamaConfig.tiny(dtype=jnp.float32,
                                      **{**LLAMA, **kw})


def _pt_cfg(**kw):
    return pt_llama.LlamaConfig.tiny(dtype=torch.float32, **{**LLAMA, **kw})


@pytest.fixture(scope="module")
def trees():
    """JAX MoE Llama trees: as initialised, with the router boosted, at
    moe_every 2, and with LoRA adapters (non-zero lora_b)."""
    tokens = jnp.zeros((1, 8), jnp.int32)
    key = jax.random.PRNGKey(0)
    raw = jax_llama.Llama(_jax_cfg()).init(key, tokens)["params"]
    every2 = jax_llama.Llama(_jax_cfg(moe_every=2)).init(key,
                                                         tokens)["params"]
    lora = jax_llama.Llama(_jax_cfg(lora_rank=4)).init(key,
                                                       tokens)["params"]
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 if str(getattr(p[-1], "key", "")) == "lora_b"
        else x, lora)
    return {"raw": raw, "boosted": _boost_router(raw), "every2": every2,
            "lora": lora}


def _port(tree, **kw):
    return load_jax_params(pt_llama.Llama(_pt_cfg(**kw), device="cpu"),
                           _np(tree))


def _tokens(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# -- gates and losses -------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_gates_and_load_balance_loss_match_jax(top_k):
    logits = np.random.default_rng(top_k).standard_normal(
        (3, 7, 8)).astype(np.float32)
    want = np.asarray(jax_moe.moe_gates(jnp.asarray(logits), top_k))
    got = pt_moe.moe_gates(torch.from_numpy(logits), top_k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ((got > 0).sum(-1) == top_k).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    np.testing.assert_allclose(
        float(pt_moe.load_balance_loss(torch.from_numpy(np.asarray(probs)),
                                       top_k)),
        float(jax_moe.load_balance_loss(probs, top_k)), rtol=1e-6)


@pytest.mark.parametrize("probs", [
    np.full((4,), 0.25), np.full((64,), 1 / 64),
    np.array([[0.1, 0.3, 0.3, 0.3], [0.2, 0.2, 0.4, 0.2],
              [0.25, 0.25, 0.25, 0.25]])],
    ids=["uniform4", "uniform64", "partial_ties"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_exact_ties_select_the_experts_jax_selects(probs, top_k):
    """On equal probabilities the lower expert index wins, as
    ``jax.lax.top_k`` orders them (``torch.topk`` picks others)."""
    p = probs.astype(np.float32)
    want = np.asarray(jax_moe.gates_from_probs(jnp.asarray(p), top_k))
    got = pt_moe.gates_from_probs(torch.from_numpy(p), top_k).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        float(pt_moe.load_balance_loss(torch.from_numpy(p), top_k)),
        float(jax_moe.load_balance_loss(jnp.asarray(p), top_k)), rtol=1e-6)
    if p.ndim == 1:
        assert np.flatnonzero(got).tolist() == list(range(top_k))


def test_balanced_router_aux_equals_top_k_and_collapse_is_e():
    probs = torch.tensor([[0.5, 0.5, 0.0, 0.0],
                          [0.0, 0.0, 0.5, 0.5]]).repeat(8, 1)
    assert float(pt_moe.load_balance_loss(probs, 2)) == pytest.approx(2.0)
    collapsed = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(16, 1)
    assert float(pt_moe.load_balance_loss(collapsed, 1)) == \
        pytest.approx(4.0)


def test_aux_loss_sums_every_layer_and_requires_router_probs():
    rng = np.random.default_rng(5)
    p = [jax.nn.softmax(jnp.asarray(rng.standard_normal((2, 6, 4)),
                                    jnp.float32)) for _ in range(2)]
    jtree = {"layer_0": {"moe_mlp": {"router_probs": (p[0],)}},
             "layer_2": {"moe_mlp": {"router_probs": (p[1],)}}}
    ttree = {k: {"moe_mlp": {"router_probs": (torch.from_numpy(
        np.asarray(v["moe_mlp"]["router_probs"][0])),)}}
        for k, v in jtree.items()}
    np.testing.assert_allclose(float(pt_moe.moe_aux_loss(ttree, 2)),
                               float(jax_moe.moe_aux_loss(jtree, 2)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="router_probs"):
        pt_moe.moe_aux_loss({"layer_0": {}}, top_k=2)


# -- MoEMLP ---------------------------------------------------------------

def test_moe_mlp_outputs_and_gradients_match_jax(mlp):
    cfg, params, x, port = mlp
    model = jax_moe.MoEMLP(cfg)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(x.shape),
                    jnp.float32)
    want, (g_p, g_x) = jax.value_and_grad(
        lambda p, x_: (model.apply({"params": p}, x_) * w).sum(),
        argnums=(0, 1))(params, x)
    for p in port.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(np.asarray(x)).requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(model.apply({"params": params}, x)),
        atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(np.asarray(w))).sum().backward()
    flat = flatten_jax_tree(_np(g_p))
    grads = dict(port.named_parameters())
    assert set(flat) == set(grads)
    for name, g in flat.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x),
                               atol=1e-5, rtol=1e-5)
    assert np.abs(flat["router.kernel"]).max() > 0


def test_single_expert_equals_the_dense_mlp():
    """E = 1, top-1 routing is the identity: the MoE Llama gives the
    dense Llama's logits with the same (unstacked) MLP weights, and the
    JAX MoE Llama's."""
    cfg = jax_llama.LlamaConfig.tiny(n_experts=1, moe_top_k=1,
                                     dtype=jnp.float32)
    tokens = _tokens(1, (2, 8))
    tree = _np(jax_llama.Llama(cfg).init(jax.random.PRNGKey(0),
                                         jnp.asarray(tokens))["params"])
    moe = load_jax_params(pt_llama.Llama(pt_llama.LlamaConfig.tiny(
        n_experts=1, moe_top_k=1, dtype=torch.float32), device="cpu"), tree)
    dense_tree = {k: dict(v) if isinstance(v, dict) else v
                  for k, v in tree.items()}
    for layer in [k for k in tree if k.startswith("layer_")]:
        e = dense_tree[layer].pop("moe_mlp")
        dense_tree[layer]["mlp"] = {
            "gate_proj": {"kernel": e["w_gate"][0]},
            "up_proj": {"kernel": e["w_up"][0]},
            "down_proj": {"kernel": e["w_down"][0]}}
    dense = load_jax_params(pt_llama.Llama(pt_llama.LlamaConfig.tiny(
        dtype=torch.float32), device="cpu"), dense_tree)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        got = moe(t).numpy()
        np.testing.assert_allclose(got, dense(t).numpy(), atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax_llama.Llama(cfg).apply({"params": tree},
                                                   jnp.asarray(tokens))),
        atol=1e-4)


# -- the MoE Llama ----------------------------------------------------------

@pytest.mark.parametrize("every", [1, 2])
def test_moe_llama_forward_matches_jax(trees, every):
    tree = trees["every2" if every == 2 else "boosted"]
    kw = {"moe_every": every}
    port = _port(tree, **kw)
    if every == 2:
        assert hasattr(port.layers[0], "mlp") and not hasattr(
            port.layers[0], "moe_mlp")
        assert hasattr(port.layers[1], "moe_mlp")
    tokens = _tokens(3)
    want = jax_llama.Llama(_jax_cfg(**kw)).apply({"params": tree},
                                                 jnp.asarray(tokens))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))
    assert tuple(got.shape) == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_intermediates_and_aux_gradient_match_jax(trees, remat):
    """The tree has JAX's keys and probabilities, one record a layer
    under remat too, and the aux loss's gradient reaches every router
    (and the weights before it) as JAX's does."""
    tree = trees["raw"]
    tokens = _tokens(4)
    model = jax_llama.Llama(_jax_cfg(remat=remat))
    logits, state = model.apply({"params": tree}, jnp.asarray(tokens),
                                mutable=["intermediates"])
    jinter = state["intermediates"]
    jaux = jax_moe.moe_aux_loss(jinter, 2)
    jgrad = flatten_jax_tree(_np(jax.grad(lambda p: jax_moe.moe_aux_loss(
        model.apply({"params": p}, jnp.asarray(tokens),
                    mutable=["intermediates"])[1]["intermediates"], 2))(
        tree)))
    port = _port(tree, remat=remat)
    for p in port.parameters():
        p.requires_grad_(True)
    out, inter = port(torch.from_numpy(tokens), return_intermediates=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=1e-4)
    assert set(inter) == set(jinter) == {"layer_0", "layer_1"}
    for layer, sub in inter.items():
        assert set(sub) == {"moe_mlp"} and set(sub["moe_mlp"]) == {
            "router_probs"}
        (probs,) = sub["moe_mlp"]["router_probs"]
        np.testing.assert_allclose(
            probs.detach().numpy(),
            np.asarray(jinter[layer]["moe_mlp"]["router_probs"][0]),
            atol=1e-5)
    aux = pt_moe.moe_aux_loss(inter, 2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    aux.backward()
    # the recompute of each checkpointed block recorded nothing again
    assert all(len(s["moe_mlp"]["router_probs"]) == 1
               for s in inter.values())
    params = dict(port.named_parameters())
    for name in ("layers.0.moe_mlp.router.kernel",
                 "layers.1.moe_mlp.router.kernel",
                 "layers.1.moe_mlp.router.bias",
                 "layers.0.attn.q_proj.kernel", "embed.embedding"):
        got = params[name].grad
        assert got is not None and float(got.abs().max()) > 0, name
        np.testing.assert_allclose(got.numpy(), jgrad[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_lora_on_an_moe_model_matches_jax(trees):
    """LoRA on q and v of an MoE model: the loss CE + 0.01 aux and its
    adapter gradients, as the JAX model's."""
    tree = trees["lora"]
    tokens = _tokens(6, (2, 13))
    model = jax_llama.Llama(_jax_cfg(lora_rank=4))

    def jloss(p):
        logits, st = model.apply({"params": p}, jnp.asarray(tokens[:, :-1]),
                                 mutable=["intermediates"])
        from sparkdl_tpu.parallel.train import cross_entropy_loss

        return (cross_entropy_loss(logits, jnp.asarray(tokens[:, 1:]))
                + 0.01 * jax_moe.moe_aux_loss(st["intermediates"], 2))

    jval, jgrad = jax.value_and_grad(jloss)(tree)
    jgrad = flatten_jax_tree(_np(jgrad))
    port = _port(tree, lora_rank=4)
    mask = lora_mask(port)
    for name, p in port.named_parameters():
        p.requires_grad_(mask[name])
    logits, inter = port(torch.from_numpy(tokens[:, :-1]),
                         return_intermediates=True)
    loss = (pt_train.cross_entropy_loss(logits,
                                        torch.from_numpy(tokens[:, 1:]))
            + 0.01 * pt_moe.moe_aux_loss(inter, 2))
    np.testing.assert_allclose(float(loss), float(jval), rtol=1e-5)
    loss.backward()
    n = 0
    for name, p in port.named_parameters():
        if mask[name]:
            n += 1
            np.testing.assert_allclose(p.grad.numpy(), jgrad[name],
                                       atol=1e-5, rtol=1e-4, err_msg=name)
        else:
            assert p.grad is None, name
    assert n == 8  # lora_a, lora_b of q and v, 2 layers


def test_greedy_generate_matches_jax(trees):
    tree = trees["boosted"]
    prompt = _tokens(7, (2, 6))
    jout = jax_generate.generate(jax_llama.Llama(_jax_cfg()), tree, prompt,
                                 max_new_tokens=8, temperature=0.0)
    port = _port(tree)
    out = generate(port, None, prompt, max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # greedy decode agrees with argmax over the full forward
    with torch.no_grad():
        full = port(out[:, :-1].long())
    np.testing.assert_array_equal(out[:, 6:].numpy(),
                                  full[:, 5:].argmax(-1).numpy())


ENGINES = {"paged": dict(page_size=8), "paged_int8": dict(
    page_size=8, quant="int8"), "paged_int4": dict(page_size=8,
                                                    quant="int4"),
           "dense": dict(page_size=0), "dense_int8": dict(page_size=0,
                                                          quant="int8")}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_tokens_match_the_jax_engine(trees, case):
    """3 requests through 2 slots (the third refills a freed slot) on
    the boosted-router weights: token-exact, equal finish reasons,
    logprobs and steps."""
    tree = trees["boosted"]
    kwargs = ENGINES[case]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    budgets = [6, 3, 5]
    jeng = jax_serving.ContinuousBatchingEngine(
        jax_llama.Llama(_jax_cfg()), tree, n_slots=2, chunk=4,
        **({"quant_kernel": "off"} if "quant" in kwargs else {}), **kwargs)
    port = _port(tree)
    teng = ContinuousBatchingEngine(port, port.state_dict(), n_slots=2,
                                    chunk=4, device="cpu", **kwargs)
    runs = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        res = eng.run()
        runs.append(([np.asarray(res[r]).tolist() for r in rids],
                     [eng.finish_reasons[r] for r in rids],
                     [np.asarray(eng.logprobs[r]) for r in rids],
                     eng.stats["steps"]))
    (jt, jr, jl, js), (tt, tr, tl, ts) = runs
    assert tt == jt and tr == jr and ts == js
    assert [len(t) for t in tt] == budgets
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-4)
    if "quant" in kwargs:
        # the experts and the router stay dense (the JAX rule)
        state = teng._model.state_dict()
        assert state["layers.0.moe_mlp.w_gate"].dtype == torch.float32
        assert "layers.0.moe_mlp.router.kernel" in state
        assert "layers.0.attn.q_proj.kernel_q" in state or \
            "layers.0.attn.q_proj.kernel_q4" in state


def test_multi_lora_moe_engine_matches_jax(trees):
    """Two adapters on q and v stacked on one MoE base, a request each
    way: the JAX multi-LoRA engine's tokens, paged."""
    from sparkdl_tpu.models import lora as jax_lora

    base = _boost_router(trees["lora"])
    key = [jax.random.PRNGKey(3)]

    def fresh(path, x):
        if str(getattr(path[-1], "key", "")) in ("lora_a", "lora_b"):
            key[0], sub = jax.random.split(key[0])
            return jax.random.normal(sub, x.shape, x.dtype) * 0.05
        return x

    stacked = jax_lora.stack_lora_adapters(
        [jax.tree_util.tree_map_with_path(fresh, base) for _ in range(2)])
    jeng = jax_serving.ContinuousBatchingEngine(
        jax_llama.Llama(_jax_cfg(lora_rank=4, multi_lora=2)), stacked,
        n_slots=2, chunk=4, page_size=8)
    port = _port(stacked, lora_rank=4, multi_lora=2)
    teng = ContinuousBatchingEngine(port, port.state_dict(), n_slots=2,
                                    chunk=4, page_size=8, device="cpu")
    prompts = [_tokens(s, (n,)) for s, n in ((12, 5), (13, 9), (14, 4))]
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, 6, adapter_id=i % 2)
                for i, p in enumerate(prompts)]
        res = eng.run()
        outs.append([np.asarray(res[r]).tolist() for r in rids])
    assert outs[1] == outs[0]
    assert all(len(t) == 6 for t in outs[1])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_leaves_the_experts_and_the_router_as_jax_does(trees,
                                                               bits):
    tree = _np(trees["raw"])
    want = flatten_jax_tree(_np(jax_quant.quantize_llama_params(
        tree, bits=bits, group=32)))
    got = quantize_llama_params(flatten_jax_tree(tree), bits=bits, group=32,
                                device="cpu")
    assert set(got) == set(want)
    for name in ("layers.0.moe_mlp.w_gate", "layers.1.moe_mlp.w_down",
                 "layers.0.moe_mlp.router.kernel",
                 "layers.0.moe_mlp.router.bias"):
        np.testing.assert_array_equal(np.asarray(got[name]), want[name])


def test_expert_leaves_shard_by_the_jax_rule(trees):
    """param_sharding of an MoE tree is the JAX specs leaf for leaf; the
    tensor-parallel layout splits each expert stack on dim 0, leaves the
    router whole with no projection role, and the ranks' slices rebuild
    the stack."""
    tree = trees["raw"]
    spec = jax_mesh.MeshSpec(data=2, model=4)
    jspecs = jax_sharding.param_sharding(tree, jax_sharding.TRANSFORMER_RULES,
                                         jax_mesh.make_mesh(spec))
    flat = flatten_jax_tree(_np(tree))
    got = pt_sharding.param_sharding(flat, pt_sharding.TRANSFORMER_RULES,
                                     Mesh(AXES, spec.axis_sizes()))
    jflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"layers.{k[6:]}" if k.startswith("layer_") else k
            name = f"{prefix}.{name}" if prefix else name
            if isinstance(v, dict):
                walk(v, name)
            else:
                jflat[name] = tuple(v.spec)

    walk(jspecs, "")
    assert got == jflat
    assert got["layers.0.moe_mlp.w_gate"] == ("model", "fsdp")
    assert got["layers.0.moe_mlp.router.kernel"] == ()
    tp2 = [Mesh(AXES, (1, 1, 1, 2), rank=r) for r in range(2)]
    layout = pt_sharding.tp_layout(flat, pt_sharding.TRANSFORMER_RULES,
                                   tp2[0])
    roles = pt_sharding.projection_roles(layout, tp2[0])
    assert "layers.0.moe_mlp.router" not in roles
    assert roles["layers.0.attn.o_proj"] == "row"
    shards = [pt_sharding.shard_params(flat, layout, m) for m in tp2]
    for leaf in ("w_gate", "w_up", "w_down"):
        name = f"layers.1.moe_mlp.{leaf}"
        assert shards[0][name].shape[0] == 2
        np.testing.assert_array_equal(
            np.concatenate([s[name] for s in shards]), flat[name])
    assert shards[1]["layers.0.moe_mlp.router.kernel"] is \
        flat["layers.0.moe_mlp.router.kernel"]


def test_moe_trains_with_aux_loss(trees):
    """6 steps of CE + 0.01 aux, every weight trained with AdamW: the
    first loss is the JAX loss at the same weights, and the loss
    falls."""
    tree = trees["boosted"]
    tokens = _tokens(8, (2, 13))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    model = jax_llama.Llama(_jax_cfg())
    logits, st = model.apply({"params": tree}, jnp.asarray(batch["inputs"]),
                             mutable=["intermediates"])
    from sparkdl_tpu.parallel.train import cross_entropy_loss

    jloss = (cross_entropy_loss(logits, jnp.asarray(batch["targets"]))
             + 0.01 * jax_moe.moe_aux_loss(st["intermediates"], 2))
    port = _port(tree)

    def loss_fn(b):
        logits, inter = port(b["inputs"], return_intermediates=True)
        return (pt_train.cross_entropy_loss(logits, b["targets"])
                + 0.01 * pt_moe.moe_aux_loss(inter, port.cfg.moe_top_k))

    loss_fn.model = port
    opt = torch.optim.AdamW(port.parameters(), lr=3e-3, weight_decay=1e-4)
    step = pt_train.make_train_step(
        loss_fn, opt, param_mask={n: True for n, _ in
                                  port.named_parameters()}, device="cpu")
    losses = [float(step(batch)["loss"]) for _ in range(6)]
    np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-5)
    assert losses[-1] < losses[0], losses


def test_moe_config_checks_match_jax():
    for kw, match in ((dict(n_experts=1), "moe_top_k"),
                      (dict(n_experts=2, moe_every=0), "moe_every"),
                      (dict(n_experts=4, moe_top_k=0), "moe_top_k")):
        with pytest.raises(ValueError, match=match):
            jax_llama.LlamaConfig.tiny(**kw)
        with pytest.raises(ValueError, match=match):
            pt_llama.LlamaConfig.tiny(**kw)
    cfg = pt_llama.LlamaConfig.tiny(n_experts=8, moe_top_k=2, moe_every=2,
                                    n_layers=4)
    assert [cfg.use_moe(i) for i in range(4)] == [False, True, False, True]


def test_a_dense_model_returns_empty_intermediates():
    model = pt_llama.init_weights(pt_llama.Llama(pt_llama.LlamaConfig.tiny(
        n_layers=1), device="cpu"), torch.Generator().manual_seed(0))
    out, inter = model(torch.zeros((1, 4), dtype=torch.long),
                       return_intermediates=True)
    assert inter == {} and tuple(out.shape) == (1, 4, 256)
    with pytest.raises(ValueError, match="router_probs"):
        pt_moe.moe_aux_loss(inter, 2)


def test_remat_records_once_and_keeps_the_gradient():
    """A checkpointed block's recompute does not record again, and the
    remat model's aux-loss gradients equal the plain model's."""
    cfg = pt_llama.LlamaConfig.tiny(n_experts=4, dtype=torch.float32)
    base = pt_llama.init_weights(pt_llama.Llama(cfg, device="cpu"),
                                 torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_tokens(9, (2, 7))).long()
    grads = []
    for remat in (False, True):
        model = pt_llama.Llama.from_params(
            dataclasses.replace(cfg, remat=remat), base.state_dict(),
            device="cpu")
        calls = [0]
        router = model.layers[1].moe_mlp.router
        router.register_forward_hook(lambda *a: calls.__setitem__(
            0, calls[0] + 1))
        for p in model.parameters():
            p.requires_grad_(True)
        _, inter = model(tokens, return_intermediates=True)
        pt_moe.moe_aux_loss(inter, 2).backward()
        # remat: the router ran again in the recompute, recorded once
        assert calls[0] == (2 if remat else 1)
        assert len(inter["layer_1"]["moe_mlp"]["router_probs"]) == 1
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=1e-5, atol=1e-7)
