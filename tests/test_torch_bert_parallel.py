"""BERT on a mesh: the shared Megatron / ZeRO-3 machinery
(``sparkdl_tpu_torch.models.megatron``) and the BERT models laid out by
``TRANSFORMER_RULES``, on the CPU with no process.

A rank's layout is built on a ``Mesh`` without process groups (its
collectives return their input), which is enough for what a rank holds
and computes alone: the roles, the whole biases, each rank's slice of a
JAX tree, a column-parallel projection's block and a row-parallel one's
partial product. The forwards and the steps against the JAX GSPMD run
need a gang: they are cases of the module-scoped gangs of
``tests/test_torch_tp_train.py`` (``data=2 x model=2``) and
``tests/test_torch_fsdp.py`` (``data=2 x fsdp=2``), whose rank mains and
JAX references are the helpers below."""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel import sharding as jax_sharding
from sparkdl_tpu.parallel import train as jax_train
from sparkdl_tpu_torch.models import bert as pt_bert
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models import megatron
from sparkdl_tpu_torch.models.from_jax import (
    flatten_jax_tree,
    load_jax_variables,
)
from sparkdl_tpu_torch.parallel import sharding as pt_sharding
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh
from tests.test_torch_models import _randomize

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

# 4 heads, so that model=2 gives each rank 2 whole heads (the JAX
# package's test puts tiny's 2 heads on model=4, which GSPMD reshards
# mid-head and the port refuses)
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_position=64)
NUM_CLASSES = 3
ROWS, SEQ, STEPS, LR = 4, 16, 2, 1e-3
HEADS = ("qa", "cls")
# QA's weights whose gradient is zero in exact arithmetic
# (tests/test_torch_models.py): AdamW moves each of their entries by lr
# times the sign of rounding noise, on either side
QA_SHIFT_FREE = ("attn.k_proj.bias", "qa_head.bias",
                 f"layers.{CFG['n_layers'] - 1}.mlp_norm.bias")
# a checkpoint step of the data=2 x model=2 gang
BERT_CKPT_STEP = 3


def jax_cfg():
    return jax_bert.BertConfig.tiny(dtype=jnp.float32, **CFG)


def pt_cfg():
    return pt_bert.BertConfig.tiny(dtype=torch.float32, **CFG)


def bert_batch():
    """The SQuAD-style global batch (numpy): ids, types, a padding mask
    of lengths 16, 11, 16, 7 and start / end labels inside them."""
    rng = np.random.default_rng(5)
    lengths = np.array([SEQ, 11, SEQ, 7])
    return {"ids": rng.integers(0, CFG["vocab_size"],
                                (ROWS, SEQ)).astype(np.int32),
            "types": (np.arange(SEQ)[None, :] >= 5).repeat(ROWS, 0).astype(
                np.int32),
            "mask": np.arange(SEQ)[None, :] < lengths[:, None],
            "starts": (rng.random(ROWS) * lengths).astype(np.int32),
            "ends": (rng.random(ROWS) * lengths).astype(np.int32)}


def _jax_model(head):
    if head == "qa":
        return jax_bert.BertForQuestionAnswering(jax_cfg())
    return jax_bert.BertForSequenceClassification(jax_cfg(),
                                                  num_classes=NUM_CLASSES)


def bert_trees():
    """Each head's flax params (``type_embed`` included), every bias and
    LayerNorm redrawn: a zero bias would hide a mis-sliced one."""
    b = bert_batch()
    out = {}
    for seed, head in enumerate(HEADS):
        variables = _jax_model(head).init(
            jax.random.PRNGKey(seed), jnp.asarray(b["ids"]),
            jnp.asarray(b["types"]), jnp.asarray(b["mask"]))
        out[head] = _randomize(variables, 7 + seed)["params"]
    return out


def _pt_model(head, flat, mesh):
    # a copy: a whole leaf of the model IS the tensor it is given
    params = {k: np.array(v) for k, v in flat.items()}
    if head == "qa":
        return pt_bert.BertForQuestionAnswering.from_params(
            pt_cfg(), params, "cpu", mesh=mesh)
    return pt_bert.BertForSequenceClassification.from_params(
        pt_cfg(), params, "cpu", mesh=mesh, num_classes=NUM_CLASSES)


def _outputs(model, head, b, masked):
    with torch.no_grad():
        out = model(torch.as_tensor(b["ids"]), torch.as_tensor(b["types"]),
                    torch.as_tensor(b["mask"]) if masked else None)
    return np.stack([o.numpy() for o in out]) if head == "qa" else \
        out.numpy()


def qa_loss_fn(model):
    """SQuAD's start CE + end CE under the padding mask."""
    from sparkdl_tpu_torch.parallel.train import cross_entropy_loss

    def loss_fn(b):
        start, end = model(torch.as_tensor(b["ids"]),
                           torch.as_tensor(b["types"]),
                           torch.as_tensor(b["mask"]))
        return (cross_entropy_loss(start, torch.as_tensor(b["starts"]))
                + cross_entropy_loss(end, torch.as_tensor(b["ends"])))

    loss_fn.model = model
    return loss_fn


def bert_rank_main(flats, mesh, ckpt_dir=None):
    """One rank's BERT cases on ``mesh`` (run inside a gang's main): both
    heads' outputs on this rank's rows, with and without the padding
    mask; 2 AdamW steps of the QA loss with every weight trained, the
    losses and the whole leaves after them (gathered); with
    ``ckpt_dir``, a save of the trained state with its specs and the
    saved weights' loss on this rank's rows. The rows' place in the
    global batch is ``coord``."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.sharding import full_host_value
    from sparkdl_tpu_torch.parallel.train import make_train_step, shard_batch
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    mine = shard_batch(bert_batch(), mesh)
    out = {"coord": mesh.axis_index("data") * mesh.axis_size("fsdp")
           + mesh.axis_index("fsdp"), "outputs": {}}
    for head in HEADS:
        model = _pt_model(head, flats[head], mesh)
        for masked in (True, False):
            out["outputs"][head, masked] = _outputs(model, head, mine,
                                                    masked)
    model = _pt_model("qa", flats["qa"], mesh)
    out["units"] = (None if model.zero3 is None
                    else sorted(model.zero3.units, key=str))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss_fn = qa_loss_fn(model)
    step = make_train_step(loss_fn, opt, device="cpu")
    losses = [step(mine)["loss"].item() for _ in range(STEPS)]
    whole = {n: full_host_value(p, model.tp_specs.get(n, ()), mesh).numpy()
             for n, p in model.state_dict().items()}
    out["steps"] = (losses, whole if hvd.rank() == 0 else None)
    if ckpt_dir is not None:
        ckpt = TrainCheckpointer(ckpt_dir)
        out["wrote"] = ckpt.save(BERT_CKPT_STEP, model.state_dict(),
                                 mesh=mesh, specs=model.tp_specs)
        hvd.barrier()
        with torch.no_grad():
            out["saved_loss"] = loss_fn(mine).item()
    return out


def jax_bert_runs(trees, mesh_kw):
    """The JAX GSPMD run on ``mesh_kw`` over the first 4 CPU devices:
    each head's outputs on the global batch with and without the mask,
    and 2 ``make_train_step`` steps of the QA loss (AdamW, every weight
    trained): the losses and the whole params (port names)."""
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**mesh_kw),
                              devices=jax.devices()[:4])
    b = jax.tree.map(jnp.asarray, bert_batch())
    out = {}
    placed = {}
    for head in HEADS:
        model = _jax_model(head)
        placed[head] = params = jax.device_put(
            trees[head], jax_sharding.param_sharding(
                trees[head], jax_sharding.TRANSFORMER_RULES, mesh))
        fn = jax.jit(model.apply)
        with mesh:
            data = jax_train.shard_batch(b, mesh)
            for masked in (True, False):
                got = fn({"params": params}, data["ids"], data["types"],
                         data["mask"] if masked else None)
                out[head, masked] = (np.stack([np.asarray(o) for o in got])
                                     if head == "qa" else np.asarray(got))
    model = _jax_model("qa")

    def loss_fn(params, batch):
        start, end = model.apply({"params": params}, batch["ids"],
                                 batch["types"], batch["mask"])
        return (jax_train.cross_entropy_loss(start, batch["starts"])
                + jax_train.cross_entropy_loss(end, batch["ends"]))

    opt = optax.adamw(LR)
    with mesh:
        data = jax_train.shard_batch(b, mesh)
        step = jax.jit(jax_train.make_train_step(loss_fn, opt))
        params, state, losses = placed["qa"], opt.init(placed["qa"]), []
        for _ in range(STEPS):
            params, state, metrics = step(params, state, data)
            losses.append(float(metrics["loss"]))
    out["steps"] = (losses, flatten_jax_tree(jax.tree.map(np.asarray,
                                                          params)))
    return out


def check_forwards(ranks, ref, head, masked):
    """The ranks' outputs, rows in their global order, against JAX's
    (atol 1e-5, the Llama steps' leaf tolerance); ranks that share rows
    agree."""
    by = {}
    for r in ranks:
        got = r["outputs"][head, masked]
        if r["coord"] in by:
            np.testing.assert_allclose(got, by[r["coord"]], atol=1e-6)
        by[r["coord"]] = got
    axis = 1 if head == "qa" else 0
    got = np.concatenate([by[c] for c in sorted(by)], axis=axis)
    np.testing.assert_allclose(got, ref[head, masked], atol=1e-5)


def check_steps(ranks, ref, trees):
    """Every rank's losses within 1e-5 relative of JAX's, every gathered
    leaf within 1e-5 of JAX's after 2 steps (a shift-free one within 2 lr
    a step), every leaf trained."""
    ref_losses, ref_params = ref["steps"]
    for r in ranks:
        np.testing.assert_allclose(r["steps"][0], ref_losses, rtol=1e-5)
    whole = ranks[0]["steps"][1]
    assert sorted(whole) == sorted(ref_params)
    start = flatten_jax_tree(trees["qa"])
    for name, value in whole.items():
        atol = 2 * LR * STEPS if name.endswith(QA_SHIFT_FREE) else 1e-5
        np.testing.assert_allclose(value, ref_params[name], atol=atol,
                                   err_msg=name)
        assert not np.array_equal(value, start[name]), name


# -- no process -------------------------------------------------------------


def _rank_mesh(sizes, rank):
    """This rank's view of a mesh, without process groups."""
    return Mesh(AXES, sizes, rank)


@pytest.fixture(scope="module")
def trees():
    return bert_trees()


@pytest.mark.parametrize("head", HEADS)
def test_indivisible_heads_are_refused_by_name(trees, head):
    """tiny's 2 heads on model=4 (the JAX package's
    tests/parallel/test_tp_equivalence.py case, which GSPMD reshards
    mid-head) raise NotImplementedError naming them, built or loaded."""
    cfg = pt_bert.BertConfig.tiny(dtype=torch.float32)
    mesh = _rank_mesh((1, 1, 1, 4), 0)
    cls = (pt_bert.BertForQuestionAnswering if head == "qa"
           else pt_bert.BertForSequenceClassification)
    with pytest.raises(NotImplementedError, match="n_heads=2"):
        cls(cfg, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="n_heads=2"):
        pt_bert.Bert(cfg, device="cpu", mesh=mesh)


def test_the_roles_and_the_whole_leaves_by_the_rules(trees):
    """On model=2: q, k, v and fc1 column-parallel, o and fc2
    row-parallel, the heads and pooler whole; every bias and LayerNorm
    leaf whole (the rules match only kernels), the three embeddings
    split on d_model; each rank's leaves the JAX tree's blocks, through
    ``load_jax_variables`` and ``from_params`` alike."""
    flat = flatten_jax_tree(trees["cls"])
    for rank in range(2):
        mesh = _rank_mesh((1, 1, 1, 2), rank)
        model = load_jax_variables(
            pt_bert.BertForSequenceClassification(
                pt_cfg(), NUM_CLASSES, device="cpu", mesh=mesh),
            {"params": trees["cls"]})
        block = model.bert.layers[0]
        assert [m.tp_role for m in (block.attn.q_proj, block.attn.k_proj,
                                    block.attn.v_proj, block.fc1)] == \
            ["col"] * 4
        assert block.attn.o_proj.tp_role == block.fc2.tp_role == "row"
        assert model.pooler.tp_role == model.classifier.tp_role == "rep"
        assert block.attn.n_heads == 2 and model.tp.rank == rank
        specs = model.tp_specs
        for name, spec in specs.items():
            if name.endswith(("bias", "scale")):
                assert spec == (), name
        for table in ("embed", "pos_embed", "type_embed"):
            assert specs[f"bert.{table}.embedding"] == (None, "model")
            assert getattr(model.bert, table).tp_split
        state = model.state_dict()
        want = pt_sharding.shard_params(flat, specs, mesh)
        loaded = pt_bert.BertForSequenceClassification.from_params(
            pt_cfg(), flat, "cpu", mesh=mesh, num_classes=NUM_CLASSES)
        for name, value in want.items():
            np.testing.assert_array_equal(state[name].numpy(), value)
            np.testing.assert_array_equal(
                loaded.state_dict()[name].numpy(), value)
        assert state["bert.layers.0.attn.q_proj.kernel"].shape == (64, 32)
        assert state["bert.layers.0.attn.q_proj.bias"].shape == (64,)
        assert state["bert.layers.0.fc2.kernel"].shape == (64, 64)


def test_a_column_block_carries_its_bias_block_and_a_row_sum_one_bias(
        trees):
    """A rank's column-parallel q_proj gives its block of the whole
    projection, its bias block included; a row-parallel o_proj's partial
    products, summed over the ranks, plus the whole bias once give the
    whole projection. Without process groups the all-reduce returns the
    rank's partial, so each rank's output is its partial plus the
    bias."""
    whole = pt_bert.BertForQuestionAnswering.from_params(
        pt_cfg(), flatten_jax_tree(trees["qa"]), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, 64)).astype(np.float32))
    attn = whole.bert.layers[0].attn
    with torch.no_grad():
        q_whole, o_whole = attn.q_proj(x), attn.o_proj(x)
    o_bias = attn.o_proj.bias.detach()
    partials = []
    for rank in range(2):
        mesh = _rank_mesh((1, 1, 1, 2), rank)
        model = _pt_model("qa", flatten_jax_tree(trees["qa"]), mesh)
        local = model.bert.layers[0].attn
        with torch.no_grad():
            q = megatron.tp_call(local.q_proj, x, model.tp, want="split")
            o = megatron.tp_call(local.o_proj,
                                 x[..., 32 * rank:32 * (rank + 1)],
                                 model.tp, have="split")
        np.testing.assert_allclose(
            q.numpy(), q_whole[..., 32 * rank:32 * (rank + 1)].numpy(),
            atol=1e-6)
        partials.append(o - o_bias)
    np.testing.assert_allclose((partials[0] + partials[1] + o_bias).numpy(),
                               o_whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("head", HEADS)
def test_the_zero3_unit_is_the_block_under_the_head_models_prefix(head):
    """On fsdp=2 the head model's ``bert.layers.<i>`` leaves form unit i
    (each block's kernels, split over fsdp), nothing is left for
    ``"top"`` under the rules (the embeddings and heads have no fsdp
    entry), and the Llama keeps its units and its top-level head."""
    mesh = _rank_mesh((1, 2, 1, 1), 1)
    model = (pt_bert.BertForQuestionAnswering(pt_cfg(), device="cpu",
                                              mesh=mesh) if head == "qa"
             else pt_bert.BertForSequenceClassification(
                 pt_cfg(), NUM_CLASSES, device="cpu", mesh=mesh))
    assert sorted(model.zero3.units) == [0, 1]
    assert model.bert.zero3 is model.zero3 and model.tp is None
    named = {id(p): n for n, p in model.named_parameters()}
    for i in (0, 1):
        leaves = sorted(named[id(owner._parameters[leaf])]
                        for owner, leaf, _ in model.zero3.units[i])
        assert leaves == sorted(
            f"bert.layers.{i}.{m}.kernel" for m in (
                "attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.o_proj",
                "fc1", "fc2"))
    assert model.bert.layers[0].fc1.kernel.shape == (32, 128)
    assert model.bert.layers[0].fc2.kernel.shape == (128, 32)
    assert megatron.unit_of("bert.layers.1.fc1.kernel") == 1
    assert megatron.unit_of("layers.3.attn.q_proj.kernel") == 3
    assert megatron.unit_of("bert.embed.embedding") == "top"
    llama = pt_llama.Llama(pt_llama.LlamaConfig.tiny(dtype=torch.float32),
                           device="cpu", mesh=mesh)
    assert sorted(llama.zero3.units, key=str) == [0, 1, "top"]


def test_a_binding_in_place_comes_back_after_an_inner_one():
    """``bound`` nests: an inner binding of a leaf that a ZeRO-3 unit
    already bound (a row-parallel bias left out of the product) gives
    the outer one back."""
    dense = pt_bert.Dense(4, 4, torch.float32, "cpu")
    outer, inner = torch.ones(4), torch.zeros(4)
    with megatron.bound({(dense, "bias"): outer}):
        with megatron.bound({(dense, "bias"): inner}):
            assert dense.bias is inner
        assert dense.bias is outer
    assert isinstance(dense.bias, torch.nn.Parameter)
