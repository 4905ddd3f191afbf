"""ZeRO-3 parameter sharding (``fsdp > 1``) of the port against the JAX
package on the CPU.

One gang of four ranks on gloo (``HorovodRunner(np=-4)``, bounded like
``tests/test_torch_tp_train.py``) builds ``fsdp=4``, ``data=2 x fsdp=2``
and ``fsdp=2 x model=2`` meshes in turn and takes 2 steps of
``make_train_step`` on each, with LoRA on q, v and o and with every
weight trained; the JAX ``make_train_step`` takes the same steps from
the same weights and batch under GSPMD on the same meshes (the first 4
of ``tests/conftest.py``'s 8 CPU devices). The same gang checks
``cfg.remat``, the losses with unequally ignored labels (C8), one MoE
LoRA step, the MoE router's aux loss with each rank's rows routed
differently (C9), the collectives a step issues, ``Mesh.reduce_scatter`` and
the sharded-parameter gather, the serving engine's tokens (int8 and
int4, paged) against the JAX engine's on the same meshes, and a
``data=2 x fsdp=2`` checkpoint with its sidecar, restored inside the
gang onto ``fsdp=4`` and here onto one rank. The same gang runs BERT on
``data=2 x fsdp=2`` (``tests/test_torch_bert_parallel.py``'s rank
main): both heads' forwards with and without a padding mask and 2 QA
steps against the JAX GSPMD run.

cloudpickle sends this module's functions (the workers' main) by value,
so a worker imports the port and torch, never JAX."""

import hashlib
import sys
import threading

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel import sharding as jax_sharding
from sparkdl_tpu.parallel import train as jax_train
from sparkdl_tpu.utils import checkpoint as jax_ckpt
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree
from sparkdl_tpu_torch.parallel import sharding as pt_sharding
from sparkdl_tpu_torch.parallel import train as pt_train
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh
from sparkdl_tpu_torch.utils import checkpoint as pt_ckpt
from tests import test_torch_bert_parallel as bert_par
from tests.test_torch_bert_parallel import bert_rank_main

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(bert_par)

CFG = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=256)
LORA = dict(lora_rank=4, lora_targets=("q_proj", "v_proj", "o_proj"))
MOE = dict(n_experts=4, moe_top_k=2)
AUX_WEIGHT = 0.01
AUX_ROUTER_SCALE = 20.0
# the MoE aux cases (C9): (mesh, mode), the router trained in "full"
AUX_CASES = (("data2_fsdp2", "lora"), ("data2_fsdp2", "full"),
             ("fsdp2_model2", "lora"))
MESHES = {"fsdp4": dict(fsdp=4), "data2_fsdp2": dict(data=2, fsdp=2),
          "fsdp2_model2": dict(fsdp=2, model=2)}
MODES = ("lora", "full")
ROWS, SEQ, STEPS, LR = 4, 16, 2, 1e-3
IGNORE = -100
CKPT_STEP = 5
# serving: fp32, int4 group 16 (every K holds whole groups a rank)
SERVE_MESHES = {"fsdp4": dict(fsdp=4), "fsdp2_model2": dict(fsdp=2, model=2)}
SERVE_CFG = dict(max_cache_len=64, quant_group=16)
QUANTS = ("int8", "int4")


def _batch():
    return pt_train.global_batch(np.random.default_rng(2), CFG["vocab_size"],
                                 ROWS, SEQ)


def _ignored_batch():
    """The batch with row 0 (one rank's row on data=2 x fsdp=2) a quarter
    ignored and row 3 an eighth: the ranks keep unequal counts."""
    batch = _batch()
    targets = batch["targets"].copy()
    targets[0, ::4] = IGNORE
    targets[3, 3::8] = IGNORE
    return {"inputs": batch["inputs"], "targets": targets}


def _jax_tree(**kw):
    """A JAX tree with non-zero ``lora_b`` when it has adapters, so every
    adapter has a gradient at step 0; without them the full fine-tune's
    base of the same init."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG, **LORA, **kw)
    params = jax.jit(jax_llama.Llama(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "lora_b":
            return 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, params)


def _base(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _base(v) for k, v in tree.items()
            if k not in ("lora_a", "lora_b")}


def _serve_tree():
    """The dense serving tree, widened 1.7x as the TP serving tests do."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG, **SERVE_CFG)
    dense = jax_llama.Llama(cfg).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(lambda p: np.asarray(p * 1.7 if p.ndim == 2 else p),
                        dense)


def _requests():
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
               for n in (5, 9, 13)]
    return prompts, [6, 20, 7]


def _serve(engine):
    """(tokens, finish reasons, steps) of the requests through
    ``engine``."""
    prompts, budgets = _requests()
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    res = engine.run()
    return ([np.asarray(res[r]).tolist() for r in rids],
            [engine.finish_reasons[r] for r in rids], engine.stats["steps"])


# -- the gang ----------------------------------------------------------------

def _digest(arrays):
    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()


def _cfg(mode, **kw):
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(dtype=torch.float32, **CFG,
                            **(LORA if mode == "lora" else {}), **kw)


def _model(flat, mesh, mode, **cfg_kw):
    from sparkdl_tpu_torch.models.llama import Llama

    # a copy: a whole leaf of the model IS the tensor it is given
    return Llama.from_params(_cfg(mode, **cfg_kw),
                             {k: np.array(v) for k, v in flat.items()},
                             device="cpu", mesh=mesh)


def _mask(model, mode):
    from sparkdl_tpu_torch.models.lora import lora_mask

    return (lora_mask(model) if mode == "lora"
            else dict.fromkeys(model.state_dict(), True))


def _gathered(model, named):
    from sparkdl_tpu_torch.parallel.sharding import full_host_value

    return {n: full_host_value(x, model.tp_specs.get(n, ()),
                               model.mesh).numpy() for n, x in named}


def _port_steps(flat, mesh, mode, batch, step_kw=None, **cfg_kw):
    """2 AdamW steps of the mesh-aware step (``step_kw`` to
    ``make_train_step``): this rank's losses, the whole leaves after
    them, the model and this rank's local shapes."""
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        shard_batch,
    )

    model = _model(flat, mesh, mode, **cfg_kw)
    mask = _mask(model, mode)
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=LR,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device="cpu", **(step_kw or {}))
    mine = shard_batch(batch, mesh)
    losses = [step(mine)["loss"].item() for _ in range(STEPS)]
    shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    return losses, _gathered(model, model.state_dict().items()), model, \
        shapes


def _port_grads(flat, mesh, mode, batch, loss_fn=None, **cfg_kw):
    """One SGD step of the mesh-aware step (``loss_fn(model)`` makes the
    loss, default ``make_lm_loss_fn``): this rank's loss, the averaged
    gradient of every trained leaf and the whole leaves after it, both
    gathered."""
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        shard_batch,
    )

    model = _model(flat, mesh, mode, **cfg_kw)
    mask = _mask(model, mode)
    trained = [(n, p) for n, p in model.named_parameters() if mask[n]]
    fn = make_lm_loss_fn(model) if loss_fn is None else loss_fn(model)
    step = make_train_step(fn, torch.optim.SGD([p for _, p in trained],
                                               lr=LR),
                           param_mask=mask, device="cpu")
    loss = step(shard_batch(batch, mesh))["loss"].item()
    return (loss,
            _gathered(model, ((n, p.grad) for n, p in trained
                              if p.grad is not None)),
            _gathered(model, model.state_dict().items()))


def _ignoring_loss(kind):
    """The LM loss with labels ``IGNORE`` left out, over the model's mesh
    (C8): the logits path or the fused one."""
    from sparkdl_tpu_torch.parallel.train import (
        cross_entropy_loss,
        fused_cross_entropy,
    )

    def make(model):
        def loss_fn(batch):
            inputs = torch.as_tensor(batch["inputs"])
            targets = torch.as_tensor(batch["targets"])
            if kind == "fused":
                hidden = model(inputs, return_hidden=True)
                return fused_cross_entropy(
                    hidden, model.head_kernel(), targets, chunk_size=5,
                    ignore_index=IGNORE, mesh=model.mesh)
            return cross_entropy_loss(model(inputs), targets,
                                      ignore_index=IGNORE, mesh=model.mesh)

        loss_fn.model = model
        return loss_fn

    return make


def _aux_loss(model):
    """The LM loss plus ``AUX_WEIGHT`` x the router's aux loss over the
    model's mesh (C9)."""
    from sparkdl_tpu_torch.models.moe import moe_aux_loss
    from sparkdl_tpu_torch.parallel.train import cross_entropy_loss

    def loss_fn(batch):
        logits, inter = model(torch.as_tensor(batch["inputs"]),
                              return_intermediates=True)
        return (cross_entropy_loss(logits, torch.as_tensor(batch["targets"]))
                + AUX_WEIGHT * moe_aux_loss(inter, MOE["moe_top_k"],
                                            mesh=model.mesh))

    loss_fn.model = model
    return loss_fn


def _routed_fractions(flat, mesh, mode, batch):
    """This rank's own top-k fractions ``f`` of each MoE layer on its
    rows of ``batch`` (layer order)."""
    from sparkdl_tpu_torch.models.moe import _router_probs, _topk_mask
    from sparkdl_tpu_torch.parallel.train import shard_batch

    model = _model(flat, mesh, mode, **MOE)
    with torch.no_grad():
        _, inter = model(torch.as_tensor(shard_batch(batch, mesh)["inputs"]),
                         return_intermediates=True)
    return [_topk_mask(p.reshape(-1, MOE["n_experts"]),
                       MOE["moe_top_k"]).mean(dim=0).numpy()
            for p in _router_probs(inter)]


def _count_step(flat, mesh, mode, batch):
    """The collectives one step issues on this rank, by kind (the mesh's
    instance methods wrapped, as the model's autograd nodes call
    them)."""
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        shard_batch,
    )

    model = _model(flat, mesh, mode)
    mask = _mask(model, mode)
    step = make_train_step(
        make_lm_loss_fn(model),
        torch.optim.SGD([p for n, p in model.named_parameters() if mask[n]],
                        lr=LR), param_mask=mask, device="cpu")
    mine = shard_batch(batch, mesh)
    counts = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    saved = {k: getattr(mesh, k) for k in counts}

    def wrap(kind):
        def call(*a, **k):
            counts[kind] += 1
            return saved[kind](*a, **k)
        return call

    for kind in counts:
        setattr(mesh, kind, wrap(kind))
    try:
        step(mine)
    finally:
        for kind in counts:
            delattr(mesh, kind)
    return counts


def _collectives_main(mesh):
    """``Mesh.reduce_scatter`` and ``sharded_param`` on ``fsdp`` against
    plain sums and slices: rank r holds ``x_r``; the reduce-scatter is
    r's block of the sum of every x, the gather the whole, and the
    gather's backward each rank's block of every rank's cotangents
    summed."""
    from sparkdl_tpu_torch.parallel.mesh import sharded_param

    n, r = mesh.axis_size("fsdp"), mesh.axis_index("fsdp")
    xs = [torch.arange(32.0).reshape(4, 8) * (k + 1) for k in range(n)]
    out = {"scatter0": mesh.reduce_scatter(xs[r], "fsdp").numpy(),
           "scatter1": mesh.reduce_scatter(xs[r], "fsdp", dim=1).numpy()}
    whole = torch.arange(32.0).reshape(8, 4)
    for dim in (0, 1):
        size = whole.shape[dim] // n
        shard = whole.narrow(dim, r * size, size).clone().requires_grad_()
        got = sharded_param(shard, mesh, "fsdp", dim)
        (got * (r + 1.0) * torch.linspace(0.0, 1.0, 32).reshape(8, 4)
         ).sum().backward()
        out[f"gather{dim}"] = (got.detach().numpy(), shard.grad.numpy())
    return out


def _serve_main(flat, mesh, quant):
    """This rank's engine on ``mesh`` (paged, ``quant``) and its tokens;
    its resident bytes beside the whole model's."""
    from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = LlamaConfig.tiny(dtype=torch.float32, **CFG, **SERVE_CFG)
    model = Llama.from_params(cfg, flat, device="cpu")
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=2,
                                      chunk=4, page_size=8, quant=quant,
                                      device="cpu", mesh=mesh)
    return _serve(engine)


def _checkpoint_main(flat, batch, ckpt_dir):
    """LoRA steps on data=2 x fsdp=2, a save of the model's state with
    its specs (every rank), the saved weights' loss on this rank's rows,
    then a restore onto fsdp=4 against ``shard_params`` of the gathered
    tree by an fsdp=4 model's specs."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.sharding import shard_params
    from sparkdl_tpu_torch.parallel.train import make_lm_loss_fn, shard_batch
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    mesh = make_mesh(MeshSpec(data=2, fsdp=2))
    _, whole, model, _ = _port_steps(flat, mesh, "lora", batch)
    ckpt = TrainCheckpointer(ckpt_dir)
    wrote = ckpt.save(CKPT_STEP, model.state_dict(), mesh=mesh,
                      specs=model.tp_specs)
    hvd.barrier()
    with torch.no_grad():
        loss = make_lm_loss_fn(model)(shard_batch(batch, mesh)).item()
    mesh4 = make_mesh(MeshSpec(fsdp=4))
    restored = ckpt.restore(CKPT_STEP, target_mesh=mesh4)
    specs4 = Llama(model.cfg, device="meta", mesh=mesh4).tp_specs
    want = shard_params({n: torch.from_numpy(v) for n, v in whole.items()},
                        specs4, mesh4)
    equal = sorted(restored) == sorted(want) and all(
        torch.equal(restored[n], want[n]) for n in want)
    return {"wrote": wrote, "loss": loss, "whole": whole,
            "restored_equal": equal, "reshard": ckpt.last_reshard}


def _gang_main(flats, batch, ignored, serve_flat, ckpt_dir, bert_flats):
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    hvd.init()
    root = hvd.rank() == 0
    out = {"steps": {}, "grads": {}, "remat": {}, "shapes": {},
           "serve": {}, "step_options": {}, "aux": {}}
    for name, kw in MESHES.items():
        mesh = make_mesh(MeshSpec(**kw))
        for mode in MODES:
            losses, whole, _, shapes = _port_steps(flats[mode], mesh, mode,
                                                   batch)
            out["steps"][name, mode] = (losses, whole if root else None,
                                        _digest(whole))
            out["shapes"][name, mode] = shapes
            loss, grads, whole = _port_grads(flats[mode], mesh, mode, batch)
            out["grads"][name, mode] = (loss, (grads, whole) if root
                                        else None, _digest(grads))
        out["remat"][name] = _port_steps(flats["lora"], mesh, "lora", batch,
                                         remat=True)[0]
        if name == "fsdp4":
            out["counts"] = {mode: _count_step(flats[mode], mesh, mode,
                                               batch) for mode in MODES}
            out["collectives"] = _collectives_main(mesh)
        if name == "data2_fsdp2":
            out["ignored"] = {
                (mode, kind): _port_grads(flats[mode], mesh, mode, ignored,
                                          loss_fn=_ignoring_loss(kind))
                for mode in MODES for kind in ("logits", "fused")}
            out["coords"] = mesh.axis_index("data"), mesh.axis_index("fsdp")
            out["bert"] = bert_rank_main(bert_flats, mesh)
        for case in AUX_CASES:
            if case[0] == name:
                mode = case[1]
                tree = flats["moe_aux" if mode == "lora" else "moe_aux_full"]
                loss, grads, _ = _port_grads(tree, mesh, mode, batch,
                                             loss_fn=_aux_loss, **MOE)
                out["aux"][case] = (loss, grads if root else None,
                                    _routed_fractions(tree, mesh, mode,
                                                      batch))
        if name == "fsdp2_model2":
            loss, grads, _ = _port_grads(flats["moe"], mesh, "lora", batch,
                                         **MOE)
            out["moe"] = (loss, grads if root else None)
            # the step's own options (two rows a rank): microbatches, and
            # the whole loss recomputed, which gathers every block again
            out["step_options"] = {
                kw: _port_steps(flats["full"], mesh, "full", batch,
                                step_kw={kw: v})[:2]
                for kw, v in (("grad_accum", 2), ("remat", True))}
        if name in SERVE_MESHES:
            for quant in QUANTS:
                out["serve"][name, quant] = _serve_main(serve_flat, mesh,
                                                        quant)
    out["checkpoint"] = _checkpoint_main(flats["lora"], batch, ckpt_dir)
    return hvd.allgather_object(out)


def _boosted_router(tree, scale=AUX_ROUTER_SCALE):
    """``tree`` with every router kernel times ``scale``: sharp routing,
    so that each rank's rows route to experts of their own."""
    if not isinstance(tree, dict):
        return tree
    return {k: (_boosted_router(v, scale) if k != "router"
                else dict(v, kernel=np.asarray(v["kernel"]) * scale))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def trees():
    lora = _jax_tree()
    moe = _jax_tree(**MOE)
    aux = _boosted_router(moe)
    return {"lora": lora, "full": _base(lora), "moe": moe, "moe_aux": aux,
            "moe_aux_full": _base(aux)}


@pytest.fixture(scope="module")
def serve_tree():
    return _serve_tree()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fsdp_ckpt"))


@pytest.fixture(scope="module")
def bert_trees():
    return bert_par.bert_trees()


@pytest.fixture(scope="module")
def gang_started(trees, serve_tree, ckpt_dir, bert_trees):
    """One bounded gang (start within 60 s, end within 240 s), run in a
    thread while this process computes the JAX side."""
    saved = (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
             launcher.ABORT_GRACE_S)
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 240.0
    launcher.ABORT_GRACE_S = 2.0
    out = {}

    def run():
        try:
            out["ranks"] = HorovodRunner(np=-4).run(
                _gang_main,
                flats={k: flatten_jax_tree(v) for k, v in trees.items()},
                batch=_batch(), ignored=_ignored_batch(),
                serve_flat=flatten_jax_tree(serve_tree), ckpt_dir=ckpt_dir,
                bert_flats={k: flatten_jax_tree(v)
                            for k, v in bert_trees.items()})
        except BaseException as e:  # re-raised by the gang fixture
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        yield thread, out
    finally:
        thread.join()
        (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
         launcher.ABORT_GRACE_S) = saved


@pytest.fixture(scope="module")
def jax_bert(gang_started, bert_trees):
    return bert_par.jax_bert_runs(bert_trees, MESHES["data2_fsdp2"])


@pytest.fixture(scope="module")
def gang(gang_started, jax_runs, jax_ignored, jax_aux, jax_bert):
    """Every rank's results of the gang, once the JAX side is done."""
    thread, out = gang_started
    thread.join()
    if "error" in out:
        raise out["error"]
    return out["ranks"]


# -- the JAX side ------------------------------------------------------------

def _jax_mesh(kw):
    return jax_mesh.make_mesh(jax_mesh.MeshSpec(**kw),
                              devices=jax.devices()[:4])


def _jax_case(tree, kw, mode, batch, **cfg_kw):
    """The JAX mesh, model, params placed by ``TRANSFORMER_RULES``, LoRA
    mask (None for full fine-tuning) and sharded batch."""
    mesh = _jax_mesh(kw)
    lora = mode == "lora"
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG,
                                     **(LORA if lora else {}), **cfg_kw)
    model = jax_llama.Llama(cfg)
    params = jax.device_put(tree, jax_sharding.param_sharding(
        tree, jax_sharding.TRANSFORMER_RULES, mesh))
    mask = jax_lora.lora_mask(params) if lora else None
    with mesh:
        data = jax_train.shard_batch(jax.tree.map(jnp.asarray, batch), mesh)
    return mesh, model, params, mask, data


def _jax_value_and_grad(mesh, loss_fn, params, data):
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, data)
    return float(loss), flatten_jax_tree(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def jax_runs(gang_started, trees):
    """2 steps of the JAX ``make_train_step`` under GSPMD on each mesh and
    mode (losses and whole params), and the loss and gradient of the
    global batch's loss."""
    runs = {}
    for name, kw in MESHES.items():
        for mode in MODES:
            mesh, model, params, mask, data = _jax_case(trees[mode], kw,
                                                        mode, _batch())
            opt = (optax.masked(optax.adamw(LR), mask) if mask is not None
                   else optax.adamw(LR))
            loss_fn = jax_train.make_lm_loss_fn(model)
            with mesh:
                step = jax.jit(jax_train.make_train_step(loss_fn, opt,
                                                         param_mask=mask))
                state = opt.init(params)
                p, losses = params, []
                for _ in range(STEPS):
                    p, state, metrics = step(p, state, data)
                    losses.append(float(metrics["loss"]))
            runs[name, mode] = (losses, flatten_jax_tree(
                jax.tree.map(np.asarray, p)),
                _jax_value_and_grad(mesh, loss_fn, params, data))
    return runs


# -- steps against JAX --------------------------------------------------------

def _trained(mode, names):
    return sorted(n for n in names
                  if mode == "full" or n.endswith(("lora_a", "lora_b")))


@pytest.mark.gang
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fsdp_steps_match_jax(gang, jax_runs, trees, mesh_name, mode):
    """Each rank's losses within 1e-5 relative of the JAX step's global
    loss (C7), every gathered leaf after 2 steps within 1e-5; every rank
    gathers the same leaves; a LoRA run leaves the base untouched."""
    ref_losses, ref_params, _ = jax_runs[mesh_name, mode]
    got = [r["steps"][mesh_name, mode] for r in gang]
    for losses, _, _ in got:
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    whole = got[0][1]
    assert sorted(whole) == sorted(ref_params)
    start = flatten_jax_tree(trees[mode])
    for name, value in whole.items():
        np.testing.assert_allclose(value, ref_params[name], atol=1e-5,
                                   err_msg=name)
        trained = mode == "full" or name.endswith(("lora_a", "lora_b"))
        assert np.array_equal(value, start[name]) != trained, name
    assert len({g[2] for g in got}) == 1


@pytest.mark.gang
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fsdp_averaged_grads_match_jax(gang, jax_runs, trees, mesh_name,
                                       mode):
    """The gradients the step hands its optimizer are JAX's gradient of
    the global batch's loss within 1e-4 relative (in the full mode a
    gather whose backward took this rank's block, not the reduce-scatter
    of every rank's, shows here), and one SGD step applies them."""
    ref_loss, ref_grads = jax_runs[mesh_name, mode][2]
    got = [r["grads"][mesh_name, mode] for r in gang]
    for loss, _, _ in got:
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    grads, whole = got[0][1]
    trained = _trained(mode, ref_grads)
    assert sorted(grads) == trained
    start = flatten_jax_tree(trees[mode])
    for name in trained:
        np.testing.assert_allclose(grads[name], ref_grads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(whole[name],
                                   start[name] - LR * grads[name],
                                   rtol=0, atol=1e-7, err_msg=name)
    assert len({g[2] for g in got}) == 1


def _flat_specs(tree, prefix=""):
    """A JAX sharding tree as {port name: spec tuple}."""
    out = {}
    for key, value in tree.items():
        name = (f"layers.{key[6:]}" if key.startswith("layer_") else key)
        name = f"{prefix}.{name}" if prefix else name
        if isinstance(value, dict):
            out.update(_flat_specs(value, name))
        else:
            out[name] = tuple(value.spec)
    return out


@pytest.mark.gang
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resident_shards_are_the_param_sharding_blocks(gang, trees,
                                                       mesh_name, mode):
    """Each rank stores, of every leaf, the block the JAX
    ``param_sharding`` gives it on ``fsdp``: a dim the JAX spec splits
    over ``fsdp`` divided by the axis (the q/k/v/gate/up/head kernels'
    dim 0, o/down's dim 1), every other dim whole or, on ``model``, this
    rank's tensor-parallel slice; the embedding, norms and adapters are
    whole on ``fsdp``."""
    kw = MESHES[mesh_name]
    f, m = kw["fsdp"], kw.get("model", 1)
    flat = flatten_jax_tree(trees[mode])
    specs = _flat_specs(jax_sharding.param_sharding(
        trees[mode], jax_sharding.TRANSFORMER_RULES, _jax_mesh(kw)))
    n_split = 0
    for r in gang:
        shapes = r["shapes"][mesh_name, mode]
        assert sorted(shapes) == sorted(flat)
        for name, leaf in flat.items():
            spec = specs[name] + (None,) * (leaf.ndim - len(specs[name]))
            for dim, entry in enumerate(spec):
                names = entry if isinstance(entry, tuple) else (entry,)
                if "fsdp" in names:
                    n_split += 1
                    assert shapes[name][dim] * f == leaf.shape[dim], name
                else:
                    assert shapes[name][dim] in (leaf.shape[dim],
                                                 leaf.shape[dim] // m), name
        for name in ("embed.embedding", "final_norm.scale",
                     "layers.0.attn.q_proj.lora_a"):
            if name in flat:
                assert shapes[name][0] == flat[name].shape[0], name
    assert n_split == len(gang) * (7 * CFG["n_layers"] + 1)


@pytest.mark.gang
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fsdp_cfg_remat_gives_the_same_losses(gang, mesh_name):
    for r in gang:
        np.testing.assert_allclose(r["remat"][mesh_name],
                                   r["steps"][mesh_name, "lora"][0],
                                   rtol=1e-6)


@pytest.mark.gang
@pytest.mark.parametrize("option", ["grad_accum", "remat"])
def test_fsdp_step_options_keep_their_meaning(gang, option):
    """On fsdp=2 x model=2, full fine-tuning: ``grad_accum=2`` and the
    step's ``remat=True`` (the whole loss recomputed in the backward,
    the blocks gathered again inside it) give the plain step's losses
    and leaves."""
    for r in gang:
        losses, whole = r["step_options"][option]
        np.testing.assert_allclose(losses,
                                   r["steps"]["fsdp2_model2", "full"][0],
                                   rtol=1e-5)
    ref = gang[0]["steps"]["fsdp2_model2", "full"][1]
    for leaf, value in gang[0]["step_options"][option][1].items():
        np.testing.assert_allclose(value, ref[leaf], atol=1e-5,
                                   err_msg=leaf)


@pytest.mark.gang
@pytest.mark.parametrize("mode", MODES)
def test_a_step_gathers_each_block_twice_and_reduce_scatters_trained_ones(
        gang, mode):
    """On fsdp=4, the logits loss: each block is gathered in the forward
    and once more in the backward (its weights were not kept), the head
    once; a trained block's and the head's gradients are reduce-scattered
    once each, a frozen one's never; the step all-reduces its loss and
    one flat buffer of the replicated gradients."""
    layers = CFG["n_layers"]
    want = {"all_gather": 2 * layers + 1,
            "reduce_scatter": (layers + 1) if mode == "full" else 0,
            "all_reduce": 2}
    for r in gang:
        assert r["counts"][mode] == want


# -- BERT on data=2 x fsdp=2 ---------------------------------------------------

@pytest.mark.gang
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("head", bert_par.HEADS)
def test_bert_fsdp_forward_matches_jax(gang, jax_bert, head, masked):
    """Both heads on data=2 x fsdp=2, each block gathered whole before
    it runs, against the JAX GSPMD forward of the same weights (atol
    1e-5); the ZeRO-3 units are the two blocks."""
    ranks = [r["bert"] for r in gang]
    assert all(r["units"] == [0, 1] for r in ranks)
    bert_par.check_forwards(ranks, jax_bert, head, masked)


@pytest.mark.gang
def test_bert_fsdp_steps_match_jax(gang, jax_bert, bert_trees):
    """2 AdamW steps of the QA loss with every weight trained: losses
    within 1e-5 relative (the global batch's on every rank), leaves
    within 1e-5 of the JAX step's on the same mesh."""
    bert_par.check_steps([r["bert"] for r in gang], jax_bert, bert_trees)


@pytest.mark.gang
def test_reduce_scatter_and_sharded_param_match_sums_and_slices(gang):
    n = 4
    xs = [np.arange(32.0).reshape(4, 8) * (k + 1) for k in range(n)]
    total = sum(xs)
    whole = np.arange(32.0).reshape(8, 4)
    weight = np.linspace(0.0, 1.0, 32, dtype=np.float32).reshape(8, 4)
    for r, got in enumerate(g["collectives"] for g in gang):
        np.testing.assert_array_equal(got["scatter0"], total[r:r + 1])
        np.testing.assert_array_equal(got["scatter1"],
                                      total[:, 2 * r:2 * r + 2])
        for dim in (0, 1):
            gathered, grad = got[f"gather{dim}"]
            np.testing.assert_array_equal(gathered, whole)
            size = whole.shape[dim] // n
            # every rank's cotangent (k + 1) * weight, summed: 10 * weight
            block = np.take(10.0 * weight, range(r * size, (r + 1) * size),
                            axis=dim)
            np.testing.assert_allclose(grad, block, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_ignored(gang_started, trees):
    """C8's reference: the loss and gradients of the global batch with
    ignored labels, JAX's ``cross_entropy_loss(ignore_index=)`` and
    ``fused_cross_entropy(ignore_index=)`` under GSPMD on data=2 x
    fsdp=2."""
    out = {}
    for mode in MODES:
        mesh, model, params, _, data = _jax_case(
            trees[mode], MESHES["data2_fsdp2"], mode, _ignored_batch())

        def logits_loss(p, b, model=model):
            return jax_train.cross_entropy_loss(
                model.apply({"params": p}, b["inputs"]), b["targets"],
                ignore_index=IGNORE)

        def fused_loss(p, b, model=model):
            hidden = model.apply({"params": p}, b["inputs"],
                                 return_hidden=True)
            return jax_train.fused_cross_entropy(
                hidden, p["lm_head"]["kernel"], b["targets"], chunk_size=5,
                ignore_index=IGNORE)

        for kind, fn in (("logits", logits_loss), ("fused", fused_loss)):
            out[mode, kind] = _jax_value_and_grad(mesh, fn, params, data)
    return out


@pytest.mark.gang
@pytest.mark.parametrize("kind", ["logits", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_unequally_ignored_labels_match_jax(gang, jax_ignored, mode, kind):
    """C8: one rank's row a quarter ignored, another's an eighth: every
    rank's loss is the global batch's kept mean and the averaged
    gradients are its gradients, as JAX computes them (a mean of the
    ranks' means would be off by a few percent)."""
    ref_loss, ref_grads = jax_ignored[mode, kind]
    got = [r["ignored"][mode, kind] for r in gang]
    for loss, _, _ in got:
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    grads = got[0][1]
    trained = _trained(mode, ref_grads)
    assert sorted(grads) == trained
    for name in trained:
        np.testing.assert_allclose(grads[name], ref_grads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.gang
def test_an_moe_lora_step_on_fsdp2_model2_matches_jax(gang, trees):
    """The MoE block is one unit like the dense one: its stacked experts
    split over ``model`` (experts) and ``fsdp`` (dim 1) are gathered
    whole; every rank's loss and the adapter gradients are JAX's."""
    mesh, model, params, _, data = _jax_case(
        trees["moe"], MESHES["fsdp2_model2"], "lora", _batch(), **MOE)
    ref_loss, ref_grads = _jax_value_and_grad(
        mesh, jax_train.make_lm_loss_fn(model), params, data)
    for r in gang:
        np.testing.assert_allclose(r["moe"][0], ref_loss, rtol=1e-5)
    grads = gang[0]["moe"][1]
    assert sorted(grads) == _trained("lora", ref_grads)
    for name, value in grads.items():
        np.testing.assert_allclose(value, ref_grads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_aux(gang_started, trees):
    """C9's reference: the loss and gradients of the global batch's LM
    loss plus ``AUX_WEIGHT`` x JAX's ``moe_aux_loss`` of the
    intermediates, under GSPMD on each aux case's mesh."""
    from sparkdl_tpu.models import moe as jax_moe

    out = {}
    for name, mode in AUX_CASES:
        tree = trees["moe_aux" if mode == "lora" else "moe_aux_full"]
        mesh, model, params, _, data = _jax_case(tree, MESHES[name], mode,
                                                 _batch(), **MOE)

        def loss(p, b, model=model):
            logits, st = model.apply({"params": p}, b["inputs"],
                                     mutable=["intermediates"])
            return (jax_train.cross_entropy_loss(logits, b["targets"])
                    + AUX_WEIGHT * jax_moe.moe_aux_loss(
                        st["intermediates"], MOE["moe_top_k"]))

        out[name, mode] = _jax_value_and_grad(mesh, loss, params, data)
    return out


@pytest.mark.gang
@pytest.mark.parametrize("case", AUX_CASES, ids="-".join)
def test_moe_aux_loss_over_data_ranks_matches_jax(gang, jax_aux, case):
    """C9: with each rank's rows routed differently (the ranks' own
    top-k fractions differ), every rank's step loss (LM loss plus 0.01 x
    the router's aux) is JAX's over the global batch, and the averaged
    gradients are its gradients: the router's kernel and bias in the
    full mode, the adapters (which the aux reaches through the residual
    stream) in LoRA. A mean of the ranks' own ``E * sum f_r P_r`` misses
    both."""
    ref_loss, ref_grads = jax_aux[case]
    got = [r["aux"][case] for r in gang]
    fractions = np.array([g[2] for g in got])  # (rank, layer, expert)
    assert not np.allclose(fractions, fractions[:1]), fractions
    for loss, _, _ in got:
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    grads = got[0][1]
    trained = _trained(case[1], ref_grads)
    assert sorted(grads) == trained
    if case[1] == "full":
        assert {"layers.0.moe_mlp.router.kernel",
                "layers.1.moe_mlp.router.bias"} <= set(trained)
    for name in trained:
        np.testing.assert_allclose(grads[name], ref_grads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# -- serving ------------------------------------------------------------------

@pytest.mark.gang
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
def test_fsdp_engine_gives_the_jax_engines_tokens(gang, serve_tree,
                                                  mesh_name, quant):
    """The paged engine with ``mesh=`` on ``fsdp``: every rank's tokens,
    finish reasons and steps are the JAX engine's on the same mesh."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG, **SERVE_CFG)
    jeng = jax_serving.ContinuousBatchingEngine(
        jax_llama.Llama(cfg), serve_tree, n_slots=2, chunk=4, page_size=8,
        quant=quant, quant_kernel="off",
        mesh=_jax_mesh(SERVE_MESHES[mesh_name]))
    ref = _serve(jeng)
    for r in gang:
        assert r["serve"][mesh_name, quant] == ref


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.gang
def test_fsdp_save_restores_onto_fsdp4_and_one_rank(gang, ckpt_dir):
    """A data=2 x fsdp=2 save: one file (rank 0's), its sidecar with the
    ``fsdp`` entries, which the JAX reader reads; restored inside the
    gang onto fsdp=4 (each rank's blocks ``shard_params`` of the
    gathered tree by an fsdp=4 model's specs), and here onto one rank:
    the gathered tree, whose model's loss is the ranks' mean."""
    ck = [r["checkpoint"] for r in gang]
    assert [c["wrote"] for c in ck] == [True, False, False, False]
    assert all(c["restored_equal"] for c in ck)
    for c in ck:
        assert c["reshard"]["direction"] == "relayout"
        assert c["reshard"]["target_axes"]["fsdp"] == 4
    doc = pt_ckpt.load_sharding_tree(ckpt_dir, CKPT_STEP)
    assert jax_ckpt.load_sharding_tree(ckpt_dir, CKPT_STEP) == doc
    by_path = {p["path"]: p for p in doc["params"]}
    assert by_path["layers.0.attn.q_proj.kernel"]["spec"] == [["fsdp"],
                                                               ["model"]]
    assert by_path["layers.0.mlp.down_proj.kernel"]["spec"] == [["model"],
                                                                ["fsdp"]]
    assert by_path["lm_head.kernel"]["shape"] == [64, 256]
    assert (jax_ckpt.sidecar_mesh_axes(doc) == pt_ckpt.sidecar_mesh_axes(doc)
            == {"data": 2, "fsdp": 2, "seq": 1, "model": 1})
    restored = pt_ckpt.TrainCheckpointer(ckpt_dir).restore(
        CKPT_STEP, target_mesh=Mesh(AXES, (1, 1, 1, 1)))
    whole = ck[0]["whole"]
    assert sorted(restored) == sorted(whole)
    for name, value in whole.items():
        np.testing.assert_array_equal(restored[name].numpy(), value)
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **LORA)
    model = pt_llama.Llama.from_params(cfg, restored, device="cpu")
    with torch.no_grad():
        loss = pt_train.make_lm_loss_fn(model)(_batch()).item()
    np.testing.assert_allclose(loss, np.mean([c["loss"] for c in ck]),
                               rtol=1e-6)


# -- no gang -------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fsdp_dims_list_the_rules_fsdp_entries(trees, mesh_name):
    """``fsdp_dims`` of a model's specs: dim 0 of the q/k/v/gate/up and
    head kernels, dim 1 of o/down, nothing else; and on ``fsdp=1`` no
    leaf."""
    kw = MESHES[mesh_name]
    mesh = Mesh(AXES, tuple(kw.get(a, 1) for a in AXES))
    model = pt_llama.Llama(pt_llama.LlamaConfig.tiny(dtype=torch.float32,
                                                     **CFG, **LORA),
                           device="meta", mesh=mesh)
    dims = pt_sharding.fsdp_dims(model.tp_specs, mesh)
    want = {"lm_head.kernel": 0}
    for i in range(CFG["n_layers"]):
        for proj, dim in (("attn.q_proj", 0), ("attn.k_proj", 0),
                          ("attn.v_proj", 0), ("attn.o_proj", 1),
                          ("mlp.gate_proj", 0), ("mlp.up_proj", 0),
                          ("mlp.down_proj", 1)):
            want[f"layers.{i}.{proj}.kernel"] = dim
    assert dims == want
    assert model.mesh is mesh and model.zero3 is not None
    assert pt_sharding.fsdp_dims(model.tp_specs,
                                 Mesh(AXES, (1, 1, 1, 2))) == {}


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_companions_take_the_rules_fsdp_split(quant):
    """int8: ``kernel_q`` splits as its kernel, the per-column scale
    follows only the ``model`` role; int4: the packed rows and the group
    scales of q split over ``fsdp`` on dim 0, o's scales on dim 1."""
    mesh = Mesh(AXES, (1, 2, 1, 2))
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **SERVE_CFG,
                                    quant=quant)
    specs = pt_llama.Llama(cfg, device="meta", mesh=mesh).tp_specs
    if quant == "int8":
        assert specs["layers.0.attn.q_proj.kernel_q"] == ("fsdp", "model")
        assert specs["layers.0.attn.q_proj.kernel_scale"] == ("model",)
        assert specs["layers.0.attn.o_proj.kernel_scale"] == ()
    else:
        assert specs["layers.0.attn.q_proj.kernel_q4"] == ("fsdp", "model")
        assert specs["layers.0.attn.q_proj.kernel_scale4"] == ("fsdp",
                                                               "model")
        assert specs["layers.0.attn.o_proj.kernel_scale4"] == ("model",
                                                               "fsdp")


def test_other_axes_are_still_refused_by_name():
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG)
    rules = [(r"q_proj.*kernel", ("seq", None))]
    with pytest.raises(NotImplementedError, match=r"\['seq'\]"):
        pt_llama.Llama(cfg, device="meta", rules=rules,
                       mesh=Mesh(AXES, (1, 2, 2, 1)))
    both = [(r"q_proj.*kernel", (("fsdp", "model"), None))]
    with pytest.raises(NotImplementedError, match="both"):
        pt_llama.Llama(cfg, device="meta", rules=both,
                       mesh=Mesh(AXES, (1, 2, 1, 2)))


def test_a_distributed_optimizer_over_an_fsdp_model_is_refused():
    from sparkdl_tpu_torch import hvd

    mesh = Mesh(AXES, (1, 2, 1, 1))
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **LORA)
    model = pt_llama.Llama(cfg, device="cpu", mesh=mesh)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    with pytest.raises(ValueError, match="ZeRO-3"):
        pt_train.make_train_step(pt_train.make_lm_loss_fn(model), opt,
                                 device="cpu")
