"""Tensor-parallel training of the port against the JAX package on the
CPU, and the resharded checkpoints that go with it.

One gang of four ranks on gloo (``HorovodRunner(np=-4)``, bounded like
``tests/test_torch_tp_serving.py``) builds three meshes in turn,
``model=4``, ``data=2 x model=2`` and ``seq=2 x model=2`` (ring attention
on each rank's heads: the dp x sp x tp step of ``__graft_entry__.py``),
and takes 2 steps of ``make_train_step`` on each, with LoRA on q, v and o
and with every weight trained; the JAX ``make_train_step`` takes the same
steps from the same weights and batch under GSPMD on the same meshes
(the first 4 of ``tests/conftest.py``'s 8 CPU devices). The same gang
checks ``cfg.remat``, the vocabulary-parallel fused loss, the losses
with unequally ignored labels, the differentiable relayouts, and saves
a ``data=2 x model=2`` checkpoint with its sharding sidecar, restored
inside the gang onto ``model=4`` and here onto one rank. The reshard plan, ``shrink_mesh`` and the
sidecar reader are held against the JAX functions on the JAX tests'
cases, with no gang. The same gang runs BERT on ``data=2 x model=2``
(``tests/test_torch_bert_parallel.py``'s rank main): both heads'
forwards with and without a padding mask and 2 QA steps against the JAX
GSPMD run, and a checkpoint restored here onto one rank.

cloudpickle sends this module's functions (the workers' main) by value,
so a worker imports the port and torch, never JAX."""

import dataclasses
import hashlib
import logging
import os
import shutil
import sys
from functools import partial

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkdl_tpu.analysis import comms as jax_comms
from sparkdl_tpu.analysis.core import ParamInfo as JaxParamInfo
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel import sharding as jax_sharding
from sparkdl_tpu.parallel import train as jax_train
from sparkdl_tpu.parallel.ring_attention import ring_self_attention
from sparkdl_tpu.utils import checkpoint as jax_ckpt
from sparkdl_tpu.utils.jax_compat import shard_map
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.analysis import comms as pt_comms
from sparkdl_tpu_torch.analysis.core import ParamInfo
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

CFG = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
           vocab_size=256)
LORA = dict(lora_rank=4, lora_targets=("q_proj", "v_proj", "o_proj"))
MESHES = {"model4": dict(model=4), "data2_model2": dict(data=2, model=2),
          "seq2_model2": dict(seq=2, model=2)}
MODES = ("lora", "full")
ROWS, SEQ, STEPS, LR = 4, 16, 2, 1e-3
CKPT_STEP = 7
IGNORE = -100
# the fused loss's case (tests/parallel/test_fused_ce.py): 37 columns and
# one large-negative pad column, so that model=2 divides the vocabulary
FB, FS, FD, FV = 4, 12, 16, 38
CHUNKS = (5, 8, 64)


def _batch():
    return pt_train.global_batch(np.random.default_rng(2), CFG["vocab_size"],
                                 ROWS, SEQ)


def _ignored_batch():
    """The batch with the first data rank's two rows a quarter ignored
    and the last row an eighth: the ranks keep unequal counts."""
    batch = _batch()
    targets = batch["targets"].copy()
    targets[:2, ::4] = IGNORE
    targets[3, 3::8] = IGNORE
    return {"inputs": batch["inputs"], "targets": targets}


def _jax_tree():
    """A JAX LoRA tree (q, v and o) with non-zero ``lora_b``, so every
    adapter has a gradient at step 0; its base is the full fine-tune's
    tree."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG, **LORA)
    params = jax.jit(jax_llama.Llama(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "lora_b":
            return 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, params)


def _base(tree):
    """The tree without its adapters (the dense model's)."""
    if not isinstance(tree, dict):
        return tree
    return {k: _base(v) for k, v in tree.items()
            if k not in ("lora_a", "lora_b")}


def _fused_data():
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(FB // 2, FS, FD)).astype(np.float32)
    w = (rng.normal(size=(FD, FV - 1)) * 0.1).astype(np.float32)
    labels = rng.integers(0, FV - 1, (FB // 2, FS)).astype(np.int32)
    # batch of 2 -> 4 rows so data=2 divides it, as the JAX test does
    return (np.concatenate([hidden, hidden]),
            np.concatenate([w, np.full((FD, 1), -30.0, np.float32)], axis=1),
            np.concatenate([labels, labels]))


# -- the gang ----------------------------------------------------------------

def _digest(arrays):
    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()


def _port_model(flat, mesh, mode, remat=False):
    from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig
    from sparkdl_tpu_torch.parallel.ring_attention import make_ring_attention

    cfg = LlamaConfig.tiny(dtype=torch.float32, remat=remat, **CFG,
                           **(LORA if mode == "lora" else {}))
    ring = (make_ring_attention(mesh) if mesh.axis_size("seq") > 1
            else None)
    # a copy: the model's whole weights ARE the tensors it is given, and
    # the steps update them in place
    return Llama.from_params(cfg, {k: np.array(v) for k, v in flat.items()},
                             device="cpu", mesh=mesh, attention_fn=ring)


def _port_steps(flat, mesh, mode, batch, remat=False, **step_kw):
    """2 steps of the mesh-aware step (``step_kw`` to
    ``make_train_step``) from the whole tree ``flat``: this rank's losses
    and the whole leaves after them (gathered), the model and its
    batch."""
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.sharding import full_host_value
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        shard_batch,
    )

    model = _port_model(flat, mesh, mode, remat)
    mask = (lora_mask(model) if mode == "lora"
            else dict.fromkeys(model.state_dict(), True))
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=LR,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device="cpu", **step_kw)
    mine = shard_batch(batch, mesh, seq_axis=mesh.axis_size("seq") > 1)
    losses = [step(mine)["loss"].item() for _ in range(STEPS)]
    whole = {n: full_host_value(p, model.tp_specs.get(n, ()), mesh).numpy()
             for n, p in model.state_dict().items()}
    return losses, whole, model, mine


def _ignoring_loss(kind):
    """The LM loss with labels ``IGNORE`` left out, over the model's mesh:
    the logits path or the vocabulary-parallel fused one."""
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


def _port_grads(flat, mesh, mode, batch, loss_fn=None):
    """One step of the mesh-aware step with plain SGD (whose update is
    the gradient's scale, where AdamW's is not): this rank's loss, the
    averaged gradient of every trained leaf still on ``p.grad`` and the
    whole leaves after the update, both gathered. ``loss_fn(model)``
    makes the loss (default ``make_lm_loss_fn``)."""
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.sharding import full_host_value
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        shard_batch,
    )

    model = _port_model(flat, mesh, mode)
    mask = (lora_mask(model) if mode == "lora"
            else dict.fromkeys(model.state_dict(), True))
    trained = [(n, p) for n, p in model.named_parameters() if mask[n]]
    step = make_train_step(
        make_lm_loss_fn(model) if loss_fn is None else loss_fn(model),
        torch.optim.SGD([p for _, p in trained], lr=LR),
        param_mask=mask, device="cpu")
    loss = step(shard_batch(batch, mesh,
                            seq_axis=mesh.axis_size("seq") > 1))["loss"]
    specs = model.tp_specs

    def whole(named):
        return {n: full_host_value(x, specs.get(n, ()), mesh).numpy()
                for n, x in named}

    return (loss.item(), whole((n, p.grad) for n, p in trained),
            whole(model.state_dict().items()))


def _fused_main(mesh):
    """The vocabulary-parallel fused loss on this rank's rows and
    columns: its value and the gradients of its hidden rows and head
    columns, at every chunk of CHUNKS."""
    from sparkdl_tpu_torch.parallel.train import fused_cross_entropy

    hidden, w, labels = _fused_data()
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    rows = slice(d * FB // 2, (d + 1) * FB // 2)
    cols = slice(m * FV // 2, (m + 1) * FV // 2)
    out = {}
    for chunk in CHUNKS:
        h = torch.from_numpy(hidden[rows]).requires_grad_()
        wb = torch.from_numpy(w[:, cols].copy()).requires_grad_()
        loss = fused_cross_entropy(h, wb, torch.from_numpy(labels[rows]),
                                   chunk_size=chunk, mesh=mesh)
        loss.backward()
        out[chunk] = (loss.item(), h.grad.numpy(), wb.grad.numpy())
    return out


def _relayout_main(mesh):
    """``constrain`` whole -> split on model -> whole, and its gradient:
    each rank's loss is the same function of the whole, so the input's
    gradient is the weight, on every rank."""
    from sparkdl_tpu_torch.parallel.sharding import constrain

    x = torch.arange(24.0).reshape(3, 8).requires_grad_()
    w = torch.linspace(-1.0, 1.0, 24).reshape(3, 8)
    split = constrain(x, (None, "model"), mesh)
    back = constrain(split, (None, None), mesh, have=(None, "model"))
    (back * w).sum().backward()
    return {"split": split.detach().numpy(), "back": back.detach().numpy(),
            "grad": x.grad.numpy(), "want_grad": w.numpy()}


def _checkpoint_main(flat, batch, ckpt_dir):
    """LoRA steps on data=2 x model=2, a save of the model's state with
    its specs (every rank), the loss of the saved weights on the whole
    batch, then a restore onto model=4 inside the gang against
    ``shard_params`` of the gathered tree by a model=4 model's specs."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.sharding import shard_params
    from sparkdl_tpu_torch.parallel.train import make_lm_loss_fn
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    mesh = make_mesh(MeshSpec(data=2, model=2))
    _, whole, model, mine = _port_steps(flat, mesh, "lora", batch)
    ckpt = TrainCheckpointer(ckpt_dir)
    wrote = ckpt.save(CKPT_STEP, model.state_dict(), mesh=mesh,
                      specs=model.tp_specs)
    hvd.barrier()
    with torch.no_grad():
        loss = make_lm_loss_fn(model)(mine).item()
    mesh4 = make_mesh(MeshSpec(model=4))
    restored = ckpt.restore(CKPT_STEP, target_mesh=mesh4)
    specs4 = Llama(model.cfg, device="meta", mesh=mesh4).tp_specs
    want = shard_params({n: torch.from_numpy(v) for n, v in whole.items()},
                        specs4, mesh4)
    equal = sorted(restored) == sorted(want) and all(
        torch.equal(restored[n], want[n]) for n in want)
    return {"wrote": wrote, "loss": loss, "whole": whole,
            "restored_equal": equal, "reshard": ckpt.last_reshard,
            "save": ckpt.last_save}


def _gang_main(flat_lora, flat_base, batch, ignored, ckpt_dir, bert_flats):
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    hvd.init()
    flats = {"lora": flat_lora, "full": flat_base}
    out = {"steps": {}, "grads": {}, "remat": {}, "step_options": {}}
    for name, kw in MESHES.items():
        mesh = make_mesh(MeshSpec(**kw))
        for mode in MODES:
            losses, whole, _, _ = _port_steps(flats[mode], mesh, mode, batch)
            out["steps"][name, mode] = (
                losses, whole if hvd.rank() == 0 else None, _digest(whole))
            loss, grads, whole = _port_grads(flats[mode], mesh, mode, batch)
            out["grads"][name, mode] = (
                loss, (grads, whole) if hvd.rank() == 0 else None,
                _digest(grads))
        out["remat"][name] = _port_steps(flat_lora, mesh, "lora", batch,
                                         remat=True)[0]
        # the step's own options: microbatches, the whole loss recomputed
        out["step_options"][name] = {
            kw: _port_steps(flat_lora, mesh, "lora", batch, **{kw: v})[:2]
            for kw, v in (("grad_accum", 2), ("remat", True))}
        if name == "data2_model2":
            out["fused"] = _fused_main(mesh)
            out["ignored"] = {
                (mode, kind): _port_grads(flats[mode], mesh, mode, ignored,
                                          loss_fn=_ignoring_loss(kind))[:2]
                for mode in MODES for kind in ("logits", "fused")}
            out["coords"] = (mesh.axis_index("data"),
                             mesh.axis_index("model"))
            out["bert"] = bert_rank_main(
                bert_flats, mesh, os.path.join(ckpt_dir, "bert"))
        if name == "model4":
            out["relayout"] = _relayout_main(mesh)
    out["checkpoint"] = _checkpoint_main(flat_lora, batch, ckpt_dir)
    return hvd.allgather_object(out)


@pytest.fixture(scope="module")
def tree():
    return _jax_tree()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.fixture(scope="module")
def bert_trees():
    return bert_par.bert_trees()


@pytest.fixture(scope="module")
def gang(tree, ckpt_dir, bert_trees):
    """Every rank's results of one bounded gang: start within 60 s, end
    within 240 s."""
    saved = (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
             launcher.ABORT_GRACE_S)
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 240.0
    launcher.ABORT_GRACE_S = 2.0
    try:
        return HorovodRunner(np=-4).run(
            _gang_main, flat_lora=flatten_jax_tree(tree),
            flat_base=flatten_jax_tree(_base(tree)), batch=_batch(),
            ignored=_ignored_batch(), ckpt_dir=ckpt_dir,
            bert_flats={k: flatten_jax_tree(v)
                        for k, v in bert_trees.items()})
    finally:
        (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
         launcher.ABORT_GRACE_S) = saved


# -- the JAX side ------------------------------------------------------------

def _jax_mesh(kw):
    return jax_mesh.make_mesh(jax_mesh.MeshSpec(**kw),
                              devices=jax.devices()[:4])


def _jax_cases(tree, batch=None, meshes=MESHES):
    """For each mesh and mode: the JAX mesh, the model (ring attention
    under ``seq``), its params placed by ``TRANSFORMER_RULES``, the LoRA
    mask (None for full fine-tuning) and the sharded batch."""
    batch = _batch() if batch is None else batch
    for name, kw in meshes.items():
        mesh = _jax_mesh(kw)
        seq = kw.get("seq", 1) > 1
        attention_fn = None
        if seq:
            spec = P(("data", "fsdp"), "seq", "model", None)
            attention_fn = shard_map(
                partial(ring_self_attention, axis_name="seq", causal=True),
                mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                check_vma=False)
        for mode in MODES:
            lora = mode == "lora"
            cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG,
                                             **(LORA if lora else {}))
            model = jax_llama.Llama(cfg, attention_fn=attention_fn)
            params = tree if lora else _base(tree)
            params = jax.device_put(params, jax_sharding.param_sharding(
                params, jax_sharding.TRANSFORMER_RULES, mesh))
            mask = jax_lora.lora_mask(params) if lora else None
            with mesh:
                data = jax_train.shard_batch(
                    jax.tree.map(jnp.asarray, batch), mesh, seq_axis=seq)
            yield (name, mode), (mesh, model, params, mask, data)


@pytest.fixture(scope="module")
def jax_runs(tree):
    """2 steps of the JAX ``make_train_step`` under GSPMD on each mesh and
    mode: the losses and the whole params (port names), computed once."""
    runs = {}
    for key, (mesh, model, params, mask, data) in _jax_cases(tree):
        opt = (optax.masked(optax.adamw(LR), mask) if mask is not None
               else optax.adamw(LR))
        with mesh:
            step = jax.jit(jax_train.make_train_step(
                jax_train.make_lm_loss_fn(model), opt, param_mask=mask))
            state = opt.init(params)
            losses = []
            for _ in range(STEPS):
                params, state, metrics = step(params, state, data)
                losses.append(float(metrics["loss"]))
        runs[key] = (losses, flatten_jax_tree(
            jax.tree.map(np.asarray, params)))
    return runs


@pytest.fixture(scope="module")
def jax_grads(tree):
    """The loss and the gradient of every leaf (port names) of the JAX
    ``make_lm_loss_fn`` of the global batch under GSPMD, on each mesh
    and mode."""
    out = {}
    for key, (mesh, model, params, _, data) in _jax_cases(tree):
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                jax_train.make_lm_loss_fn(model)))(params, data)
        out[key] = (float(loss), flatten_jax_tree(
            jax.tree.map(np.asarray, grads)))
    return out


# -- steps against JAX --------------------------------------------------------

@pytest.mark.gang
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_steps_match_jax(gang, jax_runs, tree, mesh_name, mode):
    """Each rank's losses within 1e-5 relative of the JAX step's global
    loss and every leaf after 2 steps within 1e-5 of the JAX step's on
    the same mesh; every rank gathers the same whole leaves; a LoRA run
    leaves the base untouched."""
    ref_losses, ref_params = jax_runs[mesh_name, mode]
    got = [r["steps"][mesh_name, mode] for r in gang]
    for losses, _, _ in got:
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    whole = got[0][1]
    assert sorted(whole) == sorted(ref_params)
    start = flatten_jax_tree(tree if mode == "lora" else _base(tree))
    for name, value in whole.items():
        np.testing.assert_allclose(value, ref_params[name], atol=1e-5,
                                   err_msg=name)
        trained = mode == "full" or name.endswith(("lora_a", "lora_b"))
        assert np.array_equal(value, start[name]) != trained, name
    assert len({g[2] for g in got}) == 1


@pytest.mark.gang
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_averaged_grads_match_jax(gang, jax_grads, tree, mesh_name,
                                     mode):
    """The gradients the step hands its optimizer, averaged over
    ``data`` or ``seq`` and never over ``model``, are JAX's gradient of
    the global batch's loss (a scale error would show here, where
    AdamW's scale-free update hides it), and one SGD step applies them:
    every trained leaf moves by ``-LR`` times its gradient."""
    ref_loss, ref_grads = jax_grads[mesh_name, mode]
    got = [r["grads"][mesh_name, mode] for r in gang]
    for loss, _, _ in got:
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    grads, whole = got[0][1]
    trained = sorted(n for n in ref_grads
                     if mode == "full" or n.endswith(("lora_a", "lora_b")))
    assert sorted(grads) == trained
    start = flatten_jax_tree(tree if mode == "lora" else _base(tree))
    for name in trained:
        np.testing.assert_allclose(grads[name], ref_grads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(whole[name],
                                   start[name] - LR * grads[name],
                                   rtol=0, atol=1e-7, err_msg=name)
    assert len({g[2] for g in got}) == 1


@pytest.mark.gang
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_cfg_remat_gives_the_same_losses(gang, mesh_name):
    for r in gang:
        np.testing.assert_allclose(r["remat"][mesh_name],
                                   r["steps"][mesh_name, "lora"][0],
                                   rtol=1e-6)


@pytest.mark.gang
@pytest.mark.parametrize("option", ["grad_accum", "remat"])
def test_tp_step_options_keep_their_meaning(gang, option):
    """``grad_accum=2`` (the JAX test's microbatches against the whole
    batch) and the step's ``remat=True`` give the plain step's losses
    and leaves on every mesh."""
    for r in gang:
        for name in MESHES:
            losses, whole = r["step_options"][name][option]
            ref_losses = r["steps"][name, "lora"][0]
            np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
            if r is gang[0]:
                ref = r["steps"][name, "lora"][1]
                for leaf, value in whole.items():
                    np.testing.assert_allclose(value, ref[leaf], atol=1e-5,
                                               err_msg=f"{name} {leaf}")


@pytest.fixture(scope="module")
def jax_ignored(tree):
    """The loss and gradients of the global batch with ignored labels:
    JAX's ``cross_entropy_loss(ignore_index=)`` and
    ``fused_cross_entropy(ignore_index=)`` under GSPMD on data=2 x
    model=2."""
    out = {}
    meshes = {"data2_model2": MESHES["data2_model2"]}
    for (_, mode), (mesh, model, params, _, data) in _jax_cases(
            tree, _ignored_batch(), meshes):

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
            with mesh:
                loss, grads = jax.jit(jax.value_and_grad(fn))(params, data)
            out[mode, kind] = (float(loss), flatten_jax_tree(
                jax.tree.map(np.asarray, grads)))
    return out


@pytest.mark.gang
@pytest.mark.parametrize("kind", ["logits", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_unequally_ignored_labels_match_jax(gang, jax_ignored, mode, kind):
    """The first data rank's rows a quarter ignored, the last row an
    eighth: every rank's loss is the global batch's kept mean and the
    averaged gradients are its gradients, as JAX computes them (a mean
    of the two data ranks' means would be off by a few percent)."""
    ref_loss, ref_grads = jax_ignored[mode, kind]
    got = [r["ignored"][mode, kind] for r in gang]
    for loss, _ in got:
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    grads = got[0][1]
    trained = sorted(n for n in ref_grads
                     if mode == "full" or n.endswith(("lora_a", "lora_b")))
    assert sorted(grads) == trained
    for name in trained:
        np.testing.assert_allclose(grads[name], ref_grads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# -- the vocabulary-parallel fused loss ---------------------------------------

@pytest.mark.gang
@pytest.mark.parametrize("chunk", CHUNKS)
def test_vocab_parallel_fused_loss_matches_jax(gang, chunk):
    """The JAX fused loss under GSPMD with the head split on model
    (tests/parallel/test_fused_ce.py's case on data=2 x model=2): the
    value within 1e-6 relative, the head's and the hidden's gradients
    within 1e-6."""
    hidden, w, labels = _fused_data()
    mesh = _jax_mesh(dict(data=2, model=2))

    def loss(h, w_, l):
        return jax_train.fused_cross_entropy(h, w_, l, chunk_size=chunk)

    with mesh:
        sharded = jax_train.shard_batch({"h": jnp.asarray(hidden),
                                         "l": jnp.asarray(labels)}, mesh)
        w_tp = jax.device_put(jnp.asarray(w),
                              NamedSharding(mesh, P(None, "model")))
        ref, (gh, gw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            sharded["h"], w_tp, sharded["l"])
    by = {r["coords"]: r["fused"][chunk] for r in gang}
    # the global loss is the mean of the two data ranks' (equal rows)
    value = np.mean([by[d, 0][0] for d in (0, 1)])
    np.testing.assert_allclose(value, float(ref), rtol=1e-6)
    for d in (0, 1):
        assert by[d, 0][0] == by[d, 1][0]  # model ranks agree
    head = np.mean([np.concatenate([by[d, m][2] for m in (0, 1)], axis=1)
                    for d in (0, 1)], axis=0)
    np.testing.assert_allclose(head, np.asarray(gw), atol=1e-6)
    rows = np.concatenate([by[d, 0][1] for d in (0, 1)]) / 2
    np.testing.assert_allclose(rows, np.asarray(gh), atol=1e-6)
    for d in (0, 1):
        np.testing.assert_array_equal(by[d, 0][1], by[d, 1][1])


@pytest.mark.gang
def test_constrain_slices_and_gathers_differentiably(gang):
    x = np.arange(24.0, dtype=np.float32).reshape(3, 8)
    for rank, r in enumerate(gang):
        got = r["relayout"]
        np.testing.assert_array_equal(got["split"],
                                      x[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["back"], x)
        np.testing.assert_allclose(got["grad"], got["want_grad"], atol=1e-6)


# -- BERT on data=2 x model=2 --------------------------------------------------

@pytest.fixture(scope="module")
def jax_bert(bert_trees):
    return bert_par.jax_bert_runs(bert_trees, MESHES["data2_model2"])


@pytest.mark.gang
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("head", bert_par.HEADS)
def test_bert_tp_forward_matches_jax(gang, jax_bert, head, masked):
    """Both heads on data=2 x model=2, each rank on 2 of the 4 heads,
    against the JAX GSPMD forward of the same weights (atol 1e-5)."""
    bert_par.check_forwards([r["bert"] for r in gang], jax_bert, head,
                            masked)


@pytest.mark.gang
def test_bert_tp_steps_match_jax(gang, jax_bert, bert_trees):
    """2 AdamW steps of the QA loss with every weight trained, biases
    and embeddings included: losses within 1e-5 relative, leaves within
    1e-5 of the JAX step's on the same mesh."""
    bert_par.check_steps([r["bert"] for r in gang], jax_bert, bert_trees)


@pytest.mark.gang
def test_bert_tp_save_restores_onto_one_rank(gang, ckpt_dir):
    """The data=2 x model=2 BERT save (rank 0 writes) restored onto one
    rank is the gathered tree, and its model's loss on the whole batch
    is the TP model's (the mean of the data ranks' losses)."""
    ck = [r["bert"] for r in gang]
    assert [c["wrote"] for c in ck] == [True, False, False, False]
    restored = pt_ckpt.TrainCheckpointer(
        os.path.join(ckpt_dir, "bert")).restore(
        bert_par.BERT_CKPT_STEP, target_mesh=_one_rank())
    whole = ck[0]["steps"][1]
    assert sorted(restored) == sorted(whole)
    for name, value in whole.items():
        np.testing.assert_array_equal(restored[name].numpy(), value)
    model = bert_par.pt_bert.BertForQuestionAnswering.from_params(
        bert_par.pt_cfg(), restored, "cpu")
    with torch.no_grad():
        loss = bert_par.qa_loss_fn(model)(bert_par.bert_batch()).item()
    by = {c["coord"]: c["saved_loss"] for c in ck}
    np.testing.assert_allclose(loss, np.mean(list(by.values())), rtol=1e-6)


# -- checkpoints ---------------------------------------------------------------

def _one_rank():
    return Mesh(AXES, (1, 1, 1, 1))


@pytest.mark.gang
def test_tp_save_restores_onto_one_rank_and_model4(gang, ckpt_dir):
    """A data=2 x model=2 save: one file (rank 0's), its sidecar, the
    restore onto one rank equal to the gathered tree, its model's loss
    the TP model's; restored inside the gang onto model=4, each rank's
    slices are ``shard_params`` of that tree by a model=4 model's
    specs."""
    ck = [r["checkpoint"] for r in gang]
    assert [c["wrote"] for c in ck] == [True, False, False, False]
    assert all(c["restored_equal"] for c in ck)
    for c in ck:
        assert c["reshard"]["direction"] == "relayout"
        assert c["reshard"]["target_axes"]["model"] == 4
    assert ck[0]["save"]["sidecar_bytes"] > 0
    ckpt = pt_ckpt.TrainCheckpointer(ckpt_dir)
    restored = ckpt.restore(CKPT_STEP, target_mesh=_one_rank())
    whole = ck[0]["whole"]
    assert sorted(restored) == sorted(whole)
    for name, value in whole.items():
        np.testing.assert_array_equal(restored[name].numpy(), value)
    stats = ckpt.last_reshard
    assert stats["direction"] == "shrink" and stats["mode"] == "grouped"
    assert stats["source_axes"] == {"data": 2, "fsdp": 1, "seq": 1,
                                    "model": 2}
    assert stats["target_axes"] == {"data": 1, "fsdp": 1, "seq": 1,
                                    "model": 1}
    assert (stats["high_water_accounted_bytes"]
            <= stats["restore_high_water_bytes"])
    assert stats["bytes_moved"] == sum(v.nbytes for v in whole.values())
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **LORA)
    model = pt_llama.Llama.from_params(cfg, restored, device="cpu")
    with torch.no_grad():
        loss = pt_train.make_lm_loss_fn(model)(_batch()).item()
    tp = np.mean([c["loss"] for c in ck])
    np.testing.assert_allclose(loss, tp, rtol=1e-6)


@pytest.mark.gang
def test_the_jax_reader_reads_the_port_sidecar(gang, ckpt_dir):
    doc = pt_ckpt.load_sharding_tree(ckpt_dir, CKPT_STEP)
    assert jax_ckpt.load_sharding_tree(ckpt_dir, CKPT_STEP) == doc
    assert doc["schema"] == jax_ckpt.SHARDING_TREE_SCHEMA
    by_path = {p["path"]: p for p in doc["params"]}
    assert by_path["layers.0.attn.q_proj.kernel"]["spec"] == [["fsdp"],
                                                               ["model"]]
    assert by_path["layers.0.attn.q_proj.kernel"]["shape"] == [64, 64]
    assert by_path["layers.0.attn.o_proj.lora_a"]["spec"] == [["model"], []]
    assert by_path["final_norm.scale"]["spec"] == [[]]
    assert (jax_ckpt.sidecar_mesh_axes(doc)
            == pt_ckpt.sidecar_mesh_axes(doc)
            == {"data": 2, "fsdp": 1, "seq": 1, "model": 2})
    assert os.path.exists(pt_ckpt.sharding_sidecar_path(ckpt_dir,
                                                        CKPT_STEP))


def _reshard_problems(plan):
    return [p.to_dict() for p in plan.problems]


@pytest.mark.gang
def test_infeasible_target_raises_the_jax_plans_findings(gang, ckpt_dir):
    ckpt = pt_ckpt.TrainCheckpointer(ckpt_dir)
    bad = Mesh(AXES, (1, 1, 1, 3))
    with pytest.raises(pt_comms.ReshardPreflightError) as err:
        ckpt.restore(CKPT_STEP, target_mesh=bad)
    doc = pt_ckpt.load_sharding_tree(ckpt_dir, CKPT_STEP)
    ref = jax_comms.reshard_plan(
        jax_comms.param_info_from_sidecar(doc), doc["mesh_axes"],
        {"data": 1, "fsdp": 1, "seq": 1, "model": 3}, state_multiplier=1.0)
    assert not ref.feasible
    assert ([f.to_dict() for f in err.value.findings]
            == _reshard_problems(ref))
    assert err.value.plan.to_dict() == ref.to_dict()
    # a refusal is no torn step: nothing quarantined, nothing pruned
    assert pt_ckpt.latest_complete_step(ckpt_dir) == CKPT_STEP
    assert not [n for n in os.listdir(ckpt_dir) if "corrupt" in n]


@pytest.mark.gang
def test_a_step_without_sidecar_restores_whole_with_a_warning(
        gang, ckpt_dir, tmp_path, caplog):
    shutil.copytree(os.path.join(ckpt_dir, str(CKPT_STEP)),
                    tmp_path / str(CKPT_STEP))
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path))
    with caplog.at_level(logging.WARNING, logger="HorovodRunner"):
        restored = ckpt.restore(CKPT_STEP,
                                target_mesh=Mesh(AXES, (1, 1, 1, 2)))
    assert "no sharding sidecar" in caplog.text
    assert ckpt.last_reshard is None
    whole = gang[0]["checkpoint"]["whole"]
    for name, value in whole.items():
        np.testing.assert_array_equal(restored[name].numpy(), value)


def test_sidecars_are_pruned_with_their_steps(tmp_path):
    mesh = Mesh(AXES, (1, 1, 1, 1))
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path), max_to_keep=2)
    for step in range(4):
        assert ckpt.save(step, {"w": torch.ones(2, 4)}, mesh=mesh,
                         specs={"w": (None, "model")})
    assert sorted(os.listdir(tmp_path)) == [
        "2", "3", "sharding_tree-2.json", "sharding_tree-3.json"]
    doc = pt_ckpt.load_sharding_tree(str(tmp_path), 3)
    assert doc["params"] == [{"path": "w", "shape": [2, 4],
                              "dtype": "float32", "spec": [[], ["model"]]}]
    restored = ckpt.restore(3, target_mesh=mesh)
    assert torch.equal(restored["w"], torch.ones(2, 4))
    assert ckpt.last_reshard is None  # the recorded axes: no reshard


# -- the reshard plan against JAX (no gang) -------------------------------------

MiB = 1 << 20


def _infos(cls, cases):
    return [cls(path=path, shape=shape, dtype=dtype,
                sharded_axes=tuple(a for d in spec for a in d),
                spec=spec)
            for path, shape, dtype, spec in cases]


W = ("['w']", (16, 64), "float32", ((), ("model",)))
HEAD6 = ("['lm_head']['kernel']", (16, 6), "float32", ((), ("model",)))
BIG = ("['w']", (1024, 1024), "float32", ((), ("model",)))
BF16 = ("layers.0.mlp.down_proj.kernel", (128, 64), "bfloat16",
        (("model",), ("fsdp",)))

# the cases of tests/analysis/test_comms.py and
# tests/horovod/test_elastic_resume.py
PLANS = {
    "feasible_shrink": ([W], {"data": 2, "model": 4},
                        {"data": 1, "model": 4}, dict(hbm_bytes=1e12)),
    "feasible_grow": ([W], {"data": 2, "model": 4},
                      {"data": 4, "model": 4}, dict(hbm_bytes=1e12)),
    "indivisible": ([HEAD6], {"model": 2}, {"model": 4},
                    dict(hbm_bytes=1e12)),
    "axis_absent": ([HEAD6], {"model": 2}, {"data": 2},
                    dict(hbm_bytes=1e12)),
    "fractional_host": ([W], {"data": 2, "model": 4},
                        {"data": 1, "model": 2},
                        dict(local_device_count=4, hbm_bytes=1e12)),
    "high_water": ([BIG], {"model": 4}, {"model": 2},
                   dict(hbm_bytes=8 * MiB)),
    "state_multiplier": ([W], {"model": 4}, {"model": 4},
                         dict(hbm_bytes=1e12, state_multiplier=1.0)),
    "elastic_3way": ([("['w']", (8, 4), "float32",
                       (("data",), ("model",)))],
                     {"data": 4, "model": 2}, {"data": 2, "model": 3},
                     dict(hbm_bytes=1e12, state_multiplier=1.0)),
    "bf16_tp_leaf": ([BF16, W], {"data": 2, "fsdp": 1, "model": 2},
                     {"model": 1}, dict(hbm_bytes=None)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_reshard_plan_matches_jax(case):
    cases, source, target, kw = PLANS[case]
    got = pt_comms.reshard_plan(_infos(ParamInfo, cases), source, target,
                                **kw)
    ref = jax_comms.reshard_plan(_infos(JaxParamInfo, cases), source,
                                 target, **kw)
    assert got.to_dict() == ref.to_dict()
    assert got.feasible == ref.feasible


SHRINKS = [({"data": 4, "fsdp": 2, "model": 2}, 8),
           ({"data": 2, "fsdp": 4, "model": 1}, 2),
           ({"model": 4}, 6),
           ({"data": 1, "fsdp": 2, "seq": 1, "model": 2}, 8),
           ({"data": 4, "fsdp": 2, "seq": 1, "model": 2}, 16),
           ({"data": 2, "fsdp": 2, "seq": 1, "model": 2}, 8),
           ({"data": 2, "seq": 2, "model": 2}, 4),
           ({"seq": 2, "model": 2}, 2)]


@pytest.mark.parametrize("source,target_np", SHRINKS)
def test_shrink_mesh_matches_jax(source, target_np):
    assert (pt_comms.shrink_mesh(source, target_np)
            == jax_comms.shrink_mesh(source, target_np))


SIDECAR = {
    "schema": "sparkdl_tpu.checkpoint.sharding_tree/1", "step": 7,
    "mesh_axes": {"data": 2, "model": 4},
    "params": [
        {"path": "['w']", "shape": [16, 64], "dtype": "float32",
         "spec": [[], ["model"]]},
        {"path": "['b']", "shape": [64], "dtype": "float32", "spec": [[]]},
        {"path": "q", "shape": [8, 8], "dtype": "bfloat16",
         "spec": [["fsdp"], ["model", "seq"]]}],
}


def test_param_info_from_sidecar_matches_jax():
    got = pt_comms.param_info_from_sidecar(SIDECAR)
    ref = jax_comms.param_info_from_sidecar(SIDECAR)
    assert [dataclasses.asdict(i) for i in got] == [
        dataclasses.asdict(i) for i in ref]
    for target in ({"data": 1, "model": 4}, {"data": 1, "model": 3}):
        assert (pt_comms.reshard_plan(got, SIDECAR["mesh_axes"], target,
                                      hbm_bytes=1e12).to_dict()
                == jax_comms.reshard_plan(ref, SIDECAR["mesh_axes"], target,
                                          hbm_bytes=1e12).to_dict())


# -- the sharding helpers on meshes without a gang ------------------------------

def _jax_path_name(path):
    keys = [str(getattr(k, "key", k)) for k in path]
    return ".".join(f"layers.{k[6:]}" if k.startswith("layer_") else k
                    for k in keys)


@pytest.mark.parametrize("model", [2, 4])
def test_sharding_tree_info_matches_jax(tree, model):
    """A TP model's local state dict and specs give the JAX
    ``sharding_tree_info`` of the whole tree under the same specs."""
    mesh = Mesh(AXES, (1, 1, 1, model), rank=model - 1)
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **LORA)
    pt_model = pt_llama.Llama(cfg, device="meta", mesh=mesh)
    got = pt_sharding.sharding_tree_info(pt_model.state_dict(),
                                         pt_model.tp_specs, mesh)
    assert got == pt_sharding.tp_param_info(pt_model.state_dict(),
                                            pt_model.tp_specs, mesh)
    jmesh = _jax_mesh(dict(model=model, data=4 // model))
    specs = {n: pt_sharding.named_sharding_for(mesh, [
        pt_sharding._names(e) for e in spec])
        for n, spec in pt_model.tp_specs.items()}
    shardings = jax.tree_util.tree_map_with_path(
        lambda path, _: NamedSharding(jmesh, P(*specs[_jax_path_name(path)])),
        tree)
    ref = jax_sharding.sharding_tree_info(tree, shardings)
    ref = {_jax_path_name_from_key(i.path): i for i in ref}
    assert len(ref) == len(got)
    for info in got:
        want = ref[info.path]
        assert (info.shape, info.dtype, info.spec, info.sharded_axes) == (
            want.shape, want.dtype, want.spec, want.sharded_axes), info.path
        assert dict(info.mesh_axes)["model"] == model


def _jax_path_name_from_key(keystr):
    keys = [k.strip("'") for k in keystr.strip("[]").split("][")]
    return ".".join(f"layers.{k[6:]}" if k.startswith("layer_") else k
                    for k in keys)


def test_named_sharding_for_matches_jax():
    """On a mesh of every axis, and on a one-axis mesh that lacks the
    others (their dims go whole)."""
    devices = np.array(jax.devices()[:4])
    meshes = [(_jax_mesh(dict(data=4)), Mesh(AXES, (4, 1, 1, 1))),
              (jax.sharding.Mesh(devices, ("data",)),
               Mesh(("data",), (4,)))]
    for dims in ([["data"], []], [["fsdp"], ["model"]],
                 [["data", "model"], ["seq"]], [], None):
        for jmesh, mesh in meshes:
            assert pt_sharding.named_sharding_for(mesh, dims) == tuple(
                jax_sharding.named_sharding_for(jmesh, dims).spec)


def test_constrain_and_full_host_value_on_one_rank_meshes():
    x = torch.arange(12.0).reshape(3, 4)
    one = _one_rank()
    assert pt_sharding.constrain(x, (None, "model"), one) is x
    np.testing.assert_array_equal(
        pt_sharding.full_host_value(x, (None, "model"), one).numpy(),
        x.numpy())
    # a rank of model=2 without a process group slices its block
    rank1 = Mesh(AXES, (1, 1, 1, 2), rank=1)
    np.testing.assert_array_equal(
        pt_sharding.constrain(x, (None, "model"), rank1).numpy(),
        x[:, 2:].numpy())
    np.testing.assert_array_equal(
        pt_sharding.constrain(x, ("model", None), rank1,
                              have=("model", None)).numpy(), x.numpy())


# -- refusals ------------------------------------------------------------------

def test_a_distributed_optimizer_over_a_tp_model_is_refused():
    from sparkdl_tpu_torch import hvd

    mesh = Mesh(AXES, (1, 1, 1, 2))
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **LORA)
    model = pt_llama.Llama(cfg, device="cpu", mesh=mesh)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    with pytest.raises(ValueError, match="DistributedOptimizer"):
        pt_train.make_train_step(pt_train.make_lm_loss_fn(model), opt,
                                 device="cpu")
