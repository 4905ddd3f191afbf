"""The model zoo of the port (``MnistCNN``, ``ResNet``, the BERT models)
against the JAX package on the CPU: the same numpy inputs and the same
flax variables, carried across by ``load_jax_variables``.

- forwards: MnistCNN (fp32, 1e-5); ResNet18Thin on 2 x 32 x 32 x 3 in
  eval mode and in train mode (logits and the updated running
  statistics against flax's ``mutable=["batch_stats"]``, fp32, 2e-4);
  BERT QA with and without a padding mask and BERT classification
  (fp32, 2e-4); one bf16 case each for ResNet and BERT (tolerances
  stated at the cases). Every leaf of the flax variables is randomised
  first (biases, norm scales, running statistics), so that no branch
  hides behind flax's init: at init ``bn3``'s zero scale would hide the
  strided 3x3 convolution and its asymmetric SAME padding;
- one training step each against ``jax.value_and_grad`` and optax on
  the same batch: ResNet with SGD-momentum and its ``batch_stats``,
  BERT QA with AdamW at equal weight decay (losses and updated weights,
  rtol 1e-4);
- the full-width parameter counts, on the ``meta`` device against
  ``jax.eval_shape`` of the JAX model, exactly;
- the entry points default to CUDA and raise without a card;
- a ``HorovodRunner(np=-2)`` gang on gloo trains tiny BERT
  classification through ``hvd.DistributedOptimizer``, a half-batch a
  rank, against the JAX step on the whole batch.
"""

import sys

import cloudpickle
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.models import mnist_cnn as jax_mnist
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu.parallel import train as jax_train
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.models import bert as pt_bert
from sparkdl_tpu_torch.models import layers as pt_layers
from sparkdl_tpu_torch.models import mnist_cnn as pt_mnist
from sparkdl_tpu_torch.models import resnet as pt_resnet
from sparkdl_tpu_torch.models.from_jax import (
    flatten_jax_tree,
    load_jax_variables,
)
from sparkdl_tpu_torch.parallel import train as pt_train

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

BERT_JAX = jax_bert.BertConfig.tiny(dtype=jnp.float32)
BERT_PT = pt_bert.BertConfig.tiny(dtype=torch.float32)
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def _randomize(variables, seed):
    """Every leaf redrawn around its role: kernels and embeddings keep
    their init, biases and means normal(0.1), scales 1 + normal(0.3),
    variances uniform(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf, np.float32)
        if name in ("kernel", "embedding"):
            return leaf
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.3 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, _np(variables))


def _bert_inputs(seed, masked=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT_JAX.vocab_size, (B, S)).astype(np.int32)
    types = rng.integers(0, 2, (B, S)).astype(np.int32)
    lengths = np.array([S, S // 2 + 3])
    mask = np.arange(S)[None, :] < lengths[:, None]
    return ids, types, (mask if masked else None)


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def mnist_vars():
    model = jax_mnist.MnistCNN()
    x = jnp.zeros((1, 28, 28, 1))
    return _randomize(model.init(jax.random.PRNGKey(0), x), 1)


@pytest.fixture(scope="module")
def resnet_vars():
    model = jax_resnet.ResNet18Thin()
    x = jnp.zeros((1, 32, 32, 3))
    return _randomize(model.init(jax.random.PRNGKey(0), x), 2)


def _bert_vars(model, seed):
    ids, types, mask = _bert_inputs(0)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                           jnp.asarray(types), jnp.asarray(mask))
    return _randomize(variables, seed)


@pytest.fixture(scope="module")
def bert_qa_vars():
    return _bert_vars(jax_bert.BertForQuestionAnswering(BERT_JAX), 3)


@pytest.fixture(scope="module")
def bert_cls_vars():
    return _bert_vars(jax_bert.BertForSequenceClassification(BERT_JAX), 4)


# BERT QA's weights whose gradient is zero in exact arithmetic: each
# shifts the logits of a softmax alike (a key projection's bias every
# score of a query's row; the head's bias, and the last LayerNorm's bias
# through the head, every position's start or end logit)
QA_SHIFT_FREE = ("attn.k_proj.bias", "qa_head.bias",
                 f"layers.{BERT_PT.n_layers - 1}.mlp_norm.bias")


def _assert_weights_match(got, want, lr, steps=1,
                          shift_free=("attn.k_proj.bias",)):
    """Each of ``got``'s tensors against ``want``'s (state dicts) after
    ``steps`` AdamW steps at ``lr``: rtol 1e-4. A weight of
    ``shift_free`` (name suffixes) has a zero gradient in exact
    arithmetic, so each AdamW step moves each of its entries by lr times
    the sign of rounding noise, on either side: it is held to 2 lr a
    step."""
    for name, value in got.items():
        atol = 2 * lr * steps if name.endswith(shift_free) else 1e-6
        np.testing.assert_allclose(np.asarray(value),
                                   np.asarray(want[name]), rtol=1e-4,
                                   atol=atol, err_msg=name)


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------- forwards


def test_mnist_cnn_logits_match_jax(mnist_vars):
    x = _images((3, 28, 28, 1), 10)
    ref = jax_mnist.MnistCNN().apply(mnist_vars, jnp.asarray(x))
    model = load_jax_variables(pt_mnist.MnistCNN(device="cpu"), mnist_vars)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _pt_resnet(variables, dtype=torch.float32):
    return load_jax_variables(
        pt_resnet.ResNet18Thin(dtype=dtype, device="cpu"), variables)


def test_resnet_eval_mode_matches_jax(resnet_vars):
    x = _images((2, 32, 32, 3), 11)
    ref = jax_resnet.ResNet18Thin().apply(resnet_vars, jnp.asarray(x),
                                          train=False)
    model = _pt_resnet(resnet_vars).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]), name  # no stat moved


def test_resnet_train_mode_matches_jax_and_its_batch_stats(resnet_vars):
    x = _images((2, 32, 32, 3), 12)
    ref, new = jax_resnet.ResNet18Thin().apply(
        resnet_vars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = _pt_resnet(resnet_vars).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)
    state = model.state_dict()
    old = flatten_jax_tree(resnet_vars["batch_stats"])
    new = flatten_jax_tree(_np(new["batch_stats"]))
    assert len(new) == 2 * 9  # mean and var of 9 batch norms
    for name, want in new.items():
        np.testing.assert_allclose(state[name].numpy(), want, atol=2e-4,
                                   rtol=2e-4, err_msg=name)
        assert not np.allclose(want, old[name]), name


def test_resnet_bf16_matches_jax(resnet_vars):
    """bf16 convolutions, fp32 batch norms and head on both sides: both
    round each convolution's output to bf16 from an fp32 sum, so the
    logits agree to 1e-4 of their largest (the largest error seen here:
    3.1e-6 of it; each side is 2.9e-3 of it from the fp32 model)."""
    x = _images((2, 32, 32, 3), 13)
    ref = np.asarray(jax_resnet.ResNet18Thin(dtype=jnp.bfloat16).apply(
        resnet_vars, jnp.asarray(x), train=False))
    model = _pt_resnet(resnet_vars, torch.bfloat16).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_bert_qa_matches_jax(bert_qa_vars, masked):
    ids, types, mask = _bert_inputs(20, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_bert.BertForQuestionAnswering(BERT_JAX).apply(
        bert_qa_vars, jnp.asarray(ids), jnp.asarray(types), jmask)
    model = load_jax_variables(
        pt_bert.BertForQuestionAnswering(BERT_PT, device="cpu"),
        bert_qa_vars)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(types),
                    None if mask is None else torch.from_numpy(mask))
    for g, r in zip(got, ref):
        assert g.shape == (B, S) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


def test_bert_classification_matches_jax(bert_cls_vars):
    ids, types, mask = _bert_inputs(21)
    ref = jax_bert.BertForSequenceClassification(BERT_JAX).apply(
        bert_cls_vars, jnp.asarray(ids), jnp.asarray(types),
        jnp.asarray(mask))
    model = load_jax_variables(
        pt_bert.BertForSequenceClassification(BERT_PT, device="cpu"),
        bert_cls_vars)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(types),
                    torch.from_numpy(mask))
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)


def test_bert_bf16_matches_jax(bert_qa_vars):
    """bf16 Dense layers and embeddings, fp32 norms, residual stream and
    head on both sides: XLA and torch round the bf16 elementwise chain
    (the tanh GELU, the residual adds) differently, so the logits agree
    to 3e-2 of their largest (the largest error seen here: 1.2e-2 of
    it; each side is 6.8e-3 to 8.8e-3 of it from the fp32 model)."""
    ids, types, mask = _bert_inputs(22)
    ref = jax_bert.BertForQuestionAnswering(
        jax_bert.BertConfig.tiny(dtype=jnp.bfloat16)).apply(
        bert_qa_vars, jnp.asarray(ids), jnp.asarray(types),
        jnp.asarray(mask))
    model = load_jax_variables(pt_bert.BertForQuestionAnswering(
        pt_bert.BertConfig.tiny(), device="cpu"), bert_qa_vars)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(types),
                    torch.from_numpy(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max() / np.abs(r).max()
        assert err < 3e-2, err


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (7, 3, 2), (8, 1, 2), (9, 3, 1), (6, 7, 2), (5, 1, 1)])
def test_same_padding_matches_flax_conv(size, kernel, stride):
    """flax's ``"SAME"`` pads the odd pixel after: a stride-2 3x3 window
    on an even size pads (0, 1), where torch's ``padding=1`` would pad
    (1, 1) and shift every output."""
    x = _images((1, size, size, 2), 30)
    conv = flax.linen.Conv(3, (kernel, kernel), (stride, stride),
                           use_bias=True)
    variables = _randomize(conv.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x)), 31)
    ref = conv.apply(variables, jnp.asarray(x))
    ours = pt_layers.Conv(2, 3, (kernel, kernel), torch.float32, "cpu",
                          strides=stride, bias=True)
    load_jax_variables(ours, variables)
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_loader_raises_on_a_missing_or_misshaped_entry(bert_qa_vars,
                                                       resnet_vars):
    no_types = _np(bert_qa_vars)
    del no_types["params"]["bert"]["type_embed"]
    model = pt_bert.BertForQuestionAnswering(BERT_PT, device="cpu")
    with pytest.raises(ValueError, match="type_embed"):
        load_jax_variables(model, no_types)
    no_stats = {"params": _np(resnet_vars)["params"]}
    with pytest.raises(ValueError, match="bn_init.mean"):
        load_jax_variables(_pt_resnet(resnet_vars), no_stats)
    wide = pt_resnet.ResNet18Thin(num_classes=11, device="cpu")
    with pytest.raises(ValueError, match="classifier.kernel"):
        load_jax_variables(wide, resnet_vars)


# ---------------------------------------------------------------- training


def test_resnet_sgd_momentum_step_matches_jax(resnet_vars):
    """One train-mode step: cross entropy, SGD lr 0.1 momentum 0.9 (the
    recipe of benchmarks/model_bench.py), the running statistics
    updated by the step's forward."""
    rng = np.random.default_rng(40)
    x = _images((4, 32, 32, 3), 41)
    y = rng.integers(0, 10, (4,)).astype(np.int32)
    model_j = jax_resnet.ResNet18Thin()
    params = jax.tree.map(jnp.asarray, resnet_vars["params"])
    stats = jax.tree.map(jnp.asarray, resnet_vars["batch_stats"])

    def loss_fn(p):
        logits, new = model_j.apply({"params": p, "batch_stats": stats},
                                    jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        return jax_train.cross_entropy_loss(logits, jnp.asarray(y)), new

    (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    opt = optax.sgd(0.1, momentum=0.9)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref = {"params": _np(optax.apply_updates(params, updates)),
           "batch_stats": _np(new["batch_stats"])}

    model = _pt_resnet(resnet_vars).train()
    opt_t = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    def pt_loss(batch):
        return pt_train.cross_entropy_loss(model(batch["x"]), batch["y"])

    pt_loss.model = model
    step = pt_train.make_train_step(pt_loss, opt_t, device="cpu")
    got = step({"x": x, "y": y})["loss"].item()
    np.testing.assert_allclose(got, float(loss), rtol=1e-4)
    want = pt_resnet.ResNet18Thin(device="cpu")
    load_jax_variables(want, ref)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(),
                                   want.state_dict()[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _qa_loss_jax(model, params, batch):
    start, end = model.apply({"params": params}, batch["ids"],
                             batch["types"], batch["mask"])
    return (jax_train.cross_entropy_loss(start, batch["starts"])
            + jax_train.cross_entropy_loss(end, batch["ends"]))


def test_bert_qa_adamw_step_matches_jax(bert_qa_vars):
    """One SQuAD-style step: start CE + end CE under a padding mask,
    AdamW at lr 1e-3 and weight decay 1e-2 on both sides (optax's adamw
    defaults to 1e-4, torch's AdamW to 1e-2: set both)."""
    ids, types, mask = _bert_inputs(50)
    rng = np.random.default_rng(51)
    lengths = mask.sum(1)
    batch = {"ids": ids, "types": types, "mask": mask,
             "starts": (rng.random(B) * lengths).astype(np.int32),
             "ends": (rng.random(B) * lengths).astype(np.int32)}
    model_j = jax_bert.BertForQuestionAnswering(BERT_JAX)
    params = jax.tree.map(jnp.asarray, bert_qa_vars["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.value_and_grad(
        lambda p: _qa_loss_jax(model_j, p, jbatch))(params)
    opt = optax.adamw(1e-3, weight_decay=1e-2)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref = {"params": _np(optax.apply_updates(params, updates))}

    model = load_jax_variables(
        pt_bert.BertForQuestionAnswering(BERT_PT, device="cpu"),
        bert_qa_vars)
    opt_t = torch.optim.AdamW(model.parameters(), lr=1e-3,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-2)

    def pt_loss(b):
        start, end = model(b["ids"], b["types"], b["mask"])
        return (pt_train.cross_entropy_loss(start, b["starts"])
                + pt_train.cross_entropy_loss(end, b["ends"]))

    pt_loss.model = model
    step = pt_train.make_train_step(pt_loss, opt_t, device="cpu")
    got = step(batch)["loss"].item()
    np.testing.assert_allclose(got, float(loss), rtol=1e-4)
    want = load_jax_variables(
        pt_bert.BertForQuestionAnswering(BERT_PT, device="cpu"), ref)
    _assert_weights_match(model.state_dict(), want.state_dict(), 1e-3,
                          shift_free=QA_SHIFT_FREE)


# ------------------------------------------------------ full-width counts


def _count_jax(model, *args):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))


def _ids(b, s):
    return jax.ShapeDtypeStruct((b, s), jnp.int32)


@pytest.mark.parametrize("family", ["mnist_cnn", "resnet50", "bert_base",
                                    "bert_base_qa", "bert_base_cls"])
def test_full_width_parameter_counts_equal_jax(family):
    base_j, base_t = jax_bert.BertConfig.base(), pt_bert.BertConfig.base()
    img = jax.ShapeDtypeStruct
    jax_model, args, port = {
        "mnist_cnn": (jax_mnist.MnistCNN(), (img((1, 28, 28, 1),
                                                 jnp.float32),),
                      lambda: pt_mnist.MnistCNN(device="meta")),
        "resnet50": (jax_resnet.ResNet50(), (img((1, 224, 224, 3),
                                                 jnp.bfloat16),),
                     lambda: pt_resnet.ResNet50(device="meta")),
        "bert_base": (jax_bert.Bert(base_j), (_ids(1, 8), _ids(1, 8)),
                      lambda: pt_bert.Bert(base_t, device="meta")),
        "bert_base_qa": (jax_bert.BertForQuestionAnswering(base_j),
                         (_ids(1, 8), _ids(1, 8)),
                         lambda: pt_bert.BertForQuestionAnswering(
                             base_t, device="meta")),
        "bert_base_cls": (jax_bert.BertForSequenceClassification(base_j),
                          (_ids(1, 8), _ids(1, 8)),
                          lambda: pt_bert.BertForSequenceClassification(
                              base_t, device="meta")),
    }[family]
    want = _count_jax(jax_model, *args)
    got = pt_train.param_count(port())
    assert got == want, (family, got, want)
    if family == "resnet50":
        assert got == 25_557_032  # ResNet-50 at 1000 classes


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", [
    lambda: pt_mnist.MnistCNN(),
    lambda: pt_resnet.ResNet50(),
    lambda: pt_resnet.ResNet18Thin(),
    lambda: pt_resnet.BottleneckBlock(64, 64),
    lambda: pt_bert.Bert(BERT_PT),
    lambda: pt_bert.BertForQuestionAnswering(BERT_PT),
    lambda: pt_bert.BertForSequenceClassification(BERT_PT),
], ids=["mnist", "resnet50", "resnet18thin", "block", "bert", "bert_qa",
        "bert_cls"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, build):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


# --------------------------------------------------------------- the gang


@pytest.fixture
def bounded_gangs(monkeypatch):
    """The gang must start within 60 s and end within 120 s; a failed
    worker's peers are killed 2 s after it. Workers run on the CPU."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")


def _bert_cls_main(variables, batch, steps):
    """One rank's data-parallel BERT classification fine-tune: rank 0's
    weights (``replicate``), this rank's half of the batch
    (``shard_batch``), AdamW through ``DistributedOptimizer``."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.models import BertConfig
    from sparkdl_tpu_torch.models import BertForSequenceClassification
    from sparkdl_tpu_torch.models.from_jax import load_jax_variables
    from sparkdl_tpu_torch.parallel.train import (
        cross_entropy_loss,
        make_train_step,
        replicate,
        shard_batch,
    )

    torch.set_num_threads(2)
    hvd.init()
    model = BertForSequenceClassification(
        BertConfig.tiny(dtype=torch.float32), device="cpu")
    if hvd.rank() == 0:  # the others keep their own init until replicate
        load_jax_variables(model, variables)
    replicate(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    def loss_fn(b):
        return cross_entropy_loss(model(b["ids"], b["types"], b["mask"]),
                                  b["labels"])

    loss_fn.model = model
    step = make_train_step(loss_fn, opt, device="cpu")
    mine = shard_batch(batch)
    losses = [step(mine)["loss"].item() for _ in range(steps)]
    return {"losses": hvd.allgather_object(losses),
            "rows": hvd.allgather_object(int(mine["ids"].shape[0])),
            "params": hvd.allgather_object(
                {n: p.detach().numpy() for n, p in
                 model.named_parameters()})}


@pytest.mark.gang
def test_gang_bert_classification_matches_the_jax_step(bert_cls_vars,
                                                       bounded_gangs):
    rows, steps = 4, 2
    rng = np.random.default_rng(60)
    ids = rng.integers(0, BERT_JAX.vocab_size, (rows, S)).astype(np.int32)
    mask = np.arange(S)[None, :] < rng.integers(4, S + 1, (rows, 1))
    batch = {"ids": ids, "types": np.zeros_like(ids), "mask": mask,
             "labels": rng.integers(0, 2, (rows,)).astype(np.int32)}

    model_j = jax_bert.BertForSequenceClassification(BERT_JAX)
    params = jax.tree.map(jnp.asarray, bert_cls_vars["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    @jax.jit
    def jax_step(p, s):
        def loss_fn(p):
            logits = model_j.apply({"params": p}, jbatch["ids"],
                                   jbatch["types"], jbatch["mask"])
            return jax_train.cross_entropy_loss(logits, jbatch["labels"])

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    opt = optax.adamw(1e-3)  # weight decay 1e-4, optax's default
    state, ref_losses = opt.init(params), []
    for _ in range(steps):
        params, state, loss = jax_step(params, state)
        ref_losses.append(float(loss))
    want = load_jax_variables(pt_bert.BertForSequenceClassification(
        BERT_PT, device="cpu"), {"params": _np(params)}).state_dict()

    got = HorovodRunner(np=-2).run(_bert_cls_main, variables=bert_cls_vars,
                                   batch=batch, steps=steps)
    assert got["rows"] == [rows // 2, rows // 2]
    # equal halves: the ranks' mean loss is the whole batch's
    np.testing.assert_allclose(np.mean(got["losses"], axis=0), ref_losses,
                               rtol=1e-4)
    rank0, rank1 = got["params"]
    assert set(rank0) == set(want)
    for name, value in rank0.items():
        np.testing.assert_array_equal(value, rank1[name], err_msg=name)
    _assert_weights_match(rank0, want, 1e-3, steps)
