"""Expert parallelism of the port against the JAX package on the CPU,
fp32: the psum-combine binder (``expert_parallel_moe``) and the
all-to-all dispatch binder (``expert_parallel_moe_a2a``, at no-drop and
at tight capacity) forward and per-rank gradients against JAX's binders
on a two-device ``("expert",)`` mesh and its dense ``MoEMLP``; a TP=2
MoE engine's tokens against the JAX TP engine's; the divisibility
refusals by name; and the one-rank forms in process.

One gang of two ranks on gloo (``HorovodRunner(np=-2)``, bounded like
``tests/test_torch_pipeline.py``) on ``make_named_mesh("expert")`` and
``make_mesh(MeshSpec(model=2))`` returns every result to this process.
cloudpickle sends this module's functions (the workers' main) by value,
so a worker imports the port and torch, never JAX."""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import moe as jax_moe
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models import moe as pt_moe
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree, load_jax_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh, make_named_mesh

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

N = 2
# test_moe_a2a.py's layer: 8 experts, top-2, 16 tokens (8 a rank)
MOE = dict(d_model=16, d_ff=32, n_experts=8, top_k=2)
NO_DROP, TIGHT = MOE["n_experts"] / MOE["top_k"], 0.25
LLAMA = dict(n_experts=4, moe_top_k=2, max_cache_len=48)
ENGINES = {"paged": dict(page_size=8), "paged_int8": dict(page_size=8,
                                                          quant="int8"),
           "dense": dict(page_size=0)}


def _local(tree, rank):
    """This rank's experts (and the whole router) as torch tensors that
    require gradients."""
    e = tree["w_gate"].shape[0] // N
    out = {"router": {k: torch.from_numpy(v.copy()).requires_grad_()
                      for k, v in tree["router"].items()}}
    for k in pt_moe.EXPERT_WEIGHTS:
        out[k] = torch.from_numpy(
            tree[k][rank * e:(rank + 1) * e].copy()).requires_grad_()
    return out


def _grads(params, x):
    return {"router.kernel": params["router"]["kernel"].grad.numpy(),
            "router.bias": params["router"]["bias"].grad.numpy(),
            **{k: params[k].grad.numpy() for k in pt_moe.EXPERT_WEIGHTS},
            "x": x.grad.numpy()}


def _serve(engine, vocab=256):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    rids = [engine.submit(p, b) for p, b in zip(prompts, (6, 3, 5))]
    res = engine.run()
    return ([np.asarray(res[r]).tolist() for r in rids],
            [engine.finish_reasons[r] for r in rids],
            [np.asarray(engine.logprobs[r]).tolist() for r in rids],
            engine.stats["steps"])


def _port_engine(flat, case, mesh=None):
    model = load_jax_params(pt_llama.Llama(pt_llama.LlamaConfig.tiny(
        dtype=torch.float32, **LLAMA), device="cpu"), flat)
    return ContinuousBatchingEngine(model, model.state_dict(), n_slots=2,
                                    chunk=4, device="cpu", mesh=mesh,
                                    **ENGINES[case])


def _moe_main(tree, x, w, flat):
    """Every rank: both binders' forward and backward on this rank's
    share, then a TP=2 MoE engine a case; rank 0 returns both ranks'
    results."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    hvd.init()
    mesh = make_named_mesh("expert")
    rank = mesh.axis_index("expert")
    cfg = pt_moe.MoEConfig(**MOE)
    out = {"rank": rank}
    # psum form: every rank the same tokens, the same loss
    params = _local(tree, rank)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y = pt_moe.expert_parallel_moe(mesh, cfg)(params, xt)
    (y * torch.from_numpy(w)).sum().backward()
    out["psum"] = {"out": y.detach().numpy(), "grads": _grads(params, xt)}
    # a2a form: this rank's tokens, its share of the loss
    t = x.shape[0] // N
    cut = slice(rank * t, (rank + 1) * t)
    for name, cf in (("no_drop", NO_DROP), ("tight", TIGHT)):
        params = _local(tree, rank)
        xt = torch.from_numpy(x[cut].copy()).requires_grad_()
        f = pt_moe.expert_parallel_moe_a2a(mesh, cfg, capacity_factor=cf)
        y = f(params, xt)
        (y * torch.from_numpy(w[cut].copy())).sum().backward()
        out[name] = {"out": y.detach().numpy(), "grads": _grads(params, xt)}
    tp = make_mesh(MeshSpec(model=hvd.size()))
    for case in ENGINES:
        engine = _port_engine(flat, case, tp)
        assert engine._model.layers[0].moe_mlp.w_gate.shape[0] == 2
        out[case] = _serve(engine)
    return hvd.allgather_object(out)


@pytest.fixture(scope="module")
def layer():
    """test_moe_a2a.py's layer and tokens, and a loss weight."""
    cfg = jax_moe.MoEConfig(**MOE)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, MOE["d_model"])).astype(np.float32)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    params = jax_moe.MoEMLP(cfg).init(jax.random.PRNGKey(0),
                                      jnp.asarray(x))["params"]
    return cfg, jax.tree.map(np.asarray, params), x, w


@pytest.fixture(scope="module")
def llama_tree():
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **LLAMA)
    tree = jax_llama.Llama(cfg).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))["params"]

    def boost(path, v):  # decisive routing, as test_moe_llama.py
        keys = [str(getattr(p, "key", "")) for p in path]
        return v * 40.0 if "router" in keys and keys[-1] == "kernel" else v

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(boost, tree))


@pytest.fixture(scope="module")
def jax_runs(layer):
    """JAX's two binders on a two-device ``("expert",)`` mesh and the
    dense MoEMLP: outputs and the gradients of sum(out * w) for the
    params and x."""
    cfg, tree, x, w = layer
    mesh = JaxMesh(np.array(jax.devices()[:N]), ("expert",))
    dense = jax_moe.MoEMLP(cfg)
    fns = {"dense": lambda p, x_: dense.apply({"params": p}, x_),
           "psum": jax_moe.expert_parallel_moe(mesh, cfg),
           "no_drop": jax_moe.expert_parallel_moe_a2a(
               mesh, cfg, capacity_factor=NO_DROP),
           "tight": jax_moe.expert_parallel_moe_a2a(
               mesh, cfg, capacity_factor=TIGHT)}
    out = {}
    for name, fn in fns.items():
        y, (gp, gx) = jax.value_and_grad(
            lambda p, x_: (fn(p, x_) * w).sum(), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
        out[name] = (np.asarray(jax.jit(fn)(tree, jnp.asarray(x))),
                     {**flatten_jax_tree(jax.tree.map(np.asarray, gp)),
                      "x": np.asarray(gx)})
    return out


@pytest.fixture(scope="module")
def gang(layer, llama_tree):
    """Both ranks' results of one bounded gang: start within 60 s, end
    within 120 s."""
    _, tree, x, w = layer
    saved = (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
             launcher.ABORT_GRACE_S)
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 120.0
    launcher.ABORT_GRACE_S = 2.0
    try:
        return HorovodRunner(np=-2).run(_moe_main, tree=tree, x=x, w=w,
                                        flat=flatten_jax_tree(llama_tree))
    finally:
        (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
         launcher.ABORT_GRACE_S) = saved


def _rank_slice(name, want, rank, t):
    """The part of a whole-layer gradient that ``rank`` holds: its
    experts, its tokens (a2a x), or all of it (the router)."""
    if name in pt_moe.EXPERT_WEIGHTS:
        e = want.shape[0] // N
        return want[rank * e:(rank + 1) * e]
    if name == "x" and t is not None:
        return want[rank * t:(rank + 1) * t]
    return want


@pytest.mark.gang
@pytest.mark.parametrize("form", ["psum", "no_drop"])
def test_binders_match_jax_and_the_dense_layer(gang, jax_runs, form):
    """Outputs and each rank's gradients of the router, its expert
    slices and x: JAX's binder's, and the dense MoEMLP's (no token
    dropped)."""
    t = None if form == "psum" else 8
    for r in gang:
        got = r[form]
        rank = r["rank"]
        for ref in (form, "dense"):
            want_out, want_grads = jax_runs[ref]
            part = want_out if t is None else want_out[rank * t:
                                                      (rank + 1) * t]
            np.testing.assert_allclose(got["out"], part, atol=2e-5,
                                       rtol=2e-5)
            for name, g in got["grads"].items():
                np.testing.assert_allclose(
                    g, _rank_slice(name, want_grads[name], rank, t),
                    atol=5e-5, rtol=5e-5, err_msg=f"{ref} {name}")


@pytest.mark.gang
def test_tight_capacity_drops_not_corrupts(gang, jax_runs, layer):
    """Capacity 0.25: the outputs and gradients of JAX's binder, and
    every row whose chosen experts all won a slot equal to the dense
    layer's (a scrambled return exchange would corrupt them)."""
    cfg, tree, x, _ = layer
    t = x.shape[0] // N
    want_out, want_grads = jax_runs["tight"]
    got = np.concatenate([r["tight"]["out"] for r in
                          sorted(gang, key=lambda r: r["rank"])])
    np.testing.assert_allclose(got, want_out, atol=2e-5, rtol=2e-5)
    for r in gang:
        for name, g in r["tight"]["grads"].items():
            np.testing.assert_allclose(
                g, _rank_slice(name, want_grads[name], r["rank"], t),
                atol=5e-5, rtol=5e-5, err_msg=name)
    dense = jax_runs["dense"][0]
    assert not np.allclose(got, dense)  # something dropped
    C = max(1, int(np.ceil(t * cfg.top_k / cfg.n_experts * TIGHT)))
    logits = x @ tree["router"]["kernel"] + tree["router"]["bias"]
    gates = pt_moe.moe_gates(torch.from_numpy(logits), cfg.top_k).numpy()
    survived = np.zeros(x.shape[0], bool)
    for s in range(N):
        sel = gates[s * t:(s + 1) * t] > 0
        pos = np.cumsum(sel, axis=0) - 1
        survived[s * t:(s + 1) * t] = ((~sel) | (pos < C)).all(axis=1)
    assert survived.any()
    np.testing.assert_allclose(got[survived], dense[survived], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.gang
@pytest.mark.parametrize("case", list(ENGINES))
def test_tp2_moe_engine_gives_the_jax_tp_engines_tokens(gang, llama_tree,
                                                        case):
    """Each rank holds 2 of the 4 experts and all-reduces their combine:
    the JAX TP engine's tokens on ``MeshSpec(data=4, model=2)``, and the
    port's single-rank engine's, with both ranks identical."""
    kwargs = dict(ENGINES[case])
    if "quant" in kwargs:
        kwargs["quant_kernel"] = "off"
    jeng = jax_serving.ContinuousBatchingEngine(
        jax_llama.Llama(jax_llama.LlamaConfig.tiny(dtype=jnp.float32,
                                                   **LLAMA)),
        llama_tree, n_slots=2, chunk=4,
        mesh=jax_mesh.make_mesh(jax_mesh.MeshSpec(data=4, model=2)),
        **kwargs)
    jtoks, jreasons, _, jsteps = _serve(jeng)
    single = _serve(_port_engine(flatten_jax_tree(llama_tree), case))
    tp = gang[0][case]
    assert tp[0] == jtoks == single[0]
    assert tp[1] == jreasons == single[1]
    assert tp[3] == jsteps == single[3]
    np.testing.assert_allclose(np.concatenate(tp[2]),
                               np.concatenate(single[2]), atol=1e-4)
    assert gang[1][case] == tp


def test_experts_that_do_not_divide_raise_by_name():
    cfg = pt_moe.MoEConfig(n_experts=4)
    three = Mesh(("expert",), (3,))
    for bind in (pt_moe.expert_parallel_moe, pt_moe.expert_parallel_moe_a2a):
        with pytest.raises(ValueError, match=r"n_experts=4 not divisible "
                                             r"by the expert axis \(3\)"):
            bind(three, cfg)
    with pytest.raises(NotImplementedError, match="n_experts=3"):
        pt_llama.Llama(pt_llama.LlamaConfig.tiny(n_experts=3),
                       device="cpu", mesh=Mesh(AXES, (1, 1, 1, 2)))


def test_one_rank_binders_are_the_dense_layer(layer, jax_runs):
    """On a mesh of one rank (no process group) both binders hold every
    expert, exchange nothing and give the dense layer."""
    cfg, tree, x, w = layer
    mesh = make_named_mesh("expert")
    t = torch.from_numpy(x)
    assert mesh.all_to_all(t, "expert") is t
    for bind in (pt_moe.expert_parallel_moe,
                 lambda m, c: pt_moe.expert_parallel_moe_a2a(
                     m, c, capacity_factor=NO_DROP)):
        params = {"router": {k: torch.from_numpy(v) for k, v in
                             tree["router"].items()},
                  **{k: torch.from_numpy(tree[k])
                     for k in pt_moe.EXPERT_WEIGHTS}}
        got = bind(mesh, pt_moe.MoEConfig(**MOE))(params, t)
        np.testing.assert_allclose(got.numpy(), jax_runs["dense"][0],
                                   atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="params hold 4 experts"):
        pt_moe.expert_parallel_moe(mesh, pt_moe.MoEConfig(**MOE))(
            {**params, "w_gate": params["w_gate"][:4]}, t)
