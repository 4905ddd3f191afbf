"""Ring and ring-flash attention of the port against the JAX package on
the CPU, fp32 at tiny sizes.

One gang of two ranks on gloo (``HorovodRunner(np=-2)``, bounded like
``tests/test_torch_tp_serving.py``) on ``make_mesh(MeshSpec(seq=2))``
returns every result to this process: the dense ring and ring-flash
(the flash kernels' plain versions on CPU tensors), causal and not,
under both hop schedules, forward and dq, dk, dv of a weighted sum;
the tiny Llama with ``attention_fn=make_ring_attention(mesh)``, its
loss and every parameter's gradient of the global mean loss; and one
LoRA train step through ``hvd.DistributedOptimizer`` on the sequence
shards. They are held against the JAX rings under ``shard_map`` on a
two-device ``MeshSpec(seq=2)`` (``tests/conftest.py``'s CPU devices;
the flash ring in Pallas interpret mode), against JAX's ring-flash
Llama composition (``tests/parallel/test_ring_attention.py``), and
against the whole sequence in one process. In-process tests cover a
ring of one rank, the merges, the RoPE table past ``max_cache_len``,
``shard_batch`` on a mesh and the refusals.

cloudpickle sends this module's functions (the workers' main) by
value, so a worker imports the port and torch, never JAX."""

import sys
from functools import partial

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel import ring_attention as jax_ring
from sparkdl_tpu.parallel.train import cross_entropy_loss as jax_ce
from sparkdl_tpu.utils.jax_compat import shard_map
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.parallel import ring_attention as pt_ring
from sparkdl_tpu_torch.parallel import train as pt_train
from sparkdl_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    make_mesh,
    make_named_mesh,
)

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

B, S, H, D = 2, 32, 2, 8          # 16 positions a rank
CASES = [(impl, causal) for impl in ("dense", "flash")
         for causal in (True, False)]
SPEC = P("data", "seq", None, None)
VOCAB = 256


def _case_id(case):
    return f"{case[0]}-{'causal' if case[1] else 'full'}"


def _qkvw(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _lora_model(attention_fn=None):
    """A tiny fp32 LoRA Llama drawn from a seed, every ``lora_b``
    non-zero (so every adapter has a gradient)."""
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4)
    gen = torch.Generator().manual_seed(7)
    model = pt_llama.init_weights(pt_llama.Llama(
        cfg, device="cpu", attention_fn=attention_fn), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    return model


def _ring_main(qkvw, tree, batch):
    """Every rank: the rings on this rank's shard of (q, k, v), the
    tiny Llama on its columns of ``batch``, one LoRA train step; rank
    0 returns both ranks' results."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.models.lora import lora_mask

    torch.set_num_threads(1)
    hvd.init()
    mesh = make_mesh(MeshSpec(seq=hvd.size()))
    rank, n = mesh.axis_index("seq"), mesh.axis_size("seq")
    cut = slice(rank * S // n, (rank + 1) * S // n)
    q, k, v, w = (torch.from_numpy(x[:, cut].copy()) for x in qkvw)
    out = {"rank": rank, "attn": {}, "llama": {}}
    for impl, causal in CASES:
        for overlap in (True, False):
            ring = pt_ring.make_ring_attention(mesh, causal=causal,
                                               impl=impl, overlap=overlap)
            ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
            o = ring(ql, kl, vl)
            (o * w).sum().backward()
            out["attn"][impl, causal, overlap] = [
                t.detach().numpy() for t in (o, ql.grad, kl.grad, vl.grad)]

    mine = pt_train.shard_batch(batch, mesh, seq_axis=True)
    out["positions"] = mine["positions"]
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32)
    for impl in (None, "flash"):
        model = load_jax_params(pt_llama.Llama(
            cfg, device="cpu",
            attention_fn=pt_ring.make_ring_attention(mesh, impl=impl)), tree)
        for p in model.parameters():
            p.requires_grad_(True)
        loss = pt_train.make_lm_loss_fn(model)(mine)
        loss.backward()
        # the global mean loss and its gradient: the ranks' mean
        out["llama"][impl] = (
            hvd.allreduce(loss.detach(), op=hvd.Average).item(),
            {name: hvd.allreduce(p.grad, op=hvd.Average).numpy()
             for name, p in model.named_parameters()})

    model = _lora_model(pt_ring.make_ring_attention(mesh))
    mask = lora_mask(model)
    named = [(name, p) for name, p in model.named_parameters() if mask[name]]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.0), named_parameters=named)
    step = pt_train.make_train_step(pt_train.make_lm_loss_fn(model), opt,
                                    param_mask=mask, device="cpu")
    local = step(mine)["loss"].item()
    out["step"] = (hvd.allreduce(torch.tensor(local), op=hvd.Average).item(),
                   {name: p.grad.numpy() for name, p in named})
    return hvd.allgather_object(out)


@pytest.fixture(scope="module")
def jax_model():
    """JAX's ring-flash Llama composition
    (``tests/parallel/test_ring_attention.py``) on a two-device seq=2
    mesh: the params, the batch, the loss and its gradients."""
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(seq=2),
                              devices=jax.devices()[:2])
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    attend = shard_map(partial(jax_ring.ring_flash_attention,
                               axis_name="seq", causal=True, interpret=True),
                       mesh=mesh, in_specs=(SPEC, SPEC, SPEC),
                       out_specs=SPEC, check_vma=False)
    model = jax_llama.Llama(cfg, attention_fn=attend)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(batch["inputs"]))["params"]

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["inputs"]))
        return jax_ce(logits, jnp.asarray(batch["targets"]))

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return {"batch": batch, "params": params, "loss": loss, "grads": grads}


@pytest.fixture(scope="module")
def jax_rings():
    """The JAX rings' outputs and (dq, dk, dv) of sum(out * w) for every
    case, on a two-device seq=2 mesh."""
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(seq=2),
                              devices=jax.devices()[:2])
    q, k, v, w = map(jnp.asarray, _qkvw())
    out = {}
    for impl, causal in CASES:
        fn = (jax_ring.ring_self_attention if impl == "dense"
              else partial(jax_ring.ring_flash_attention, interpret=True))
        ring = shard_map(partial(fn, axis_name="seq", causal=causal),
                         mesh=mesh, in_specs=(SPEC, SPEC, SPEC),
                         out_specs=SPEC, check_vma=False)

        def forward_and_vjp(q, k, v, w, ring=ring):
            o, vjp = jax.vjp(ring, q, k, v)
            return (o, *vjp(w))

        out[impl, causal] = [np.asarray(t) for t in
                             jax.jit(forward_and_vjp)(q, k, v, w)]
    return out


@pytest.fixture(scope="module")
def gang(jax_model):
    """Both ranks' results of one bounded gang: start within 60 s, end
    within 120 s."""
    from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree

    saved = (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
             launcher.ABORT_GRACE_S)
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 120.0
    launcher.ABORT_GRACE_S = 2.0
    try:
        tree = flatten_jax_tree(jax.tree.map(np.asarray, jax_model["params"]))
        return HorovodRunner(np=-2).run(
            _ring_main, qkvw=_qkvw(), tree=tree, batch=jax_model["batch"])
    finally:
        (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
         launcher.ABORT_GRACE_S) = saved


def _whole(ranks, key, i):
    """The ranks' shards of result ``i`` of ``key`` joined along S."""
    return np.concatenate([r["attn"][key][i] for r in ranks], axis=1)


@pytest.mark.gang
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ring_forward_matches_jax(gang, jax_rings, case):
    got = _whole(gang, (*case, True), 0)
    np.testing.assert_allclose(got, jax_rings[case][0], rtol=1e-5, atol=1e-6)


@pytest.mark.gang
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ring_gradients_match_jax_grad(gang, jax_rings, case):
    """dq, dk and dv of a position-weighted sum: a block's gradient
    that lands on the wrong rank shows."""
    for i, name in enumerate("qkv", start=1):
        np.testing.assert_allclose(
            _whole(gang, (*case, True), i), jax_rings[case][i], atol=5e-5,
            rtol=5e-4, err_msg=f"d{name} diverged")


@pytest.mark.gang
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_both_schedules_are_bit_identical(gang, case):
    for r in gang:
        for a, b in zip(r["attn"][(*case, True)], r["attn"][(*case, False)]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gang
@pytest.mark.parametrize("impl", [None, "flash"], ids=["default", "flash"])
def test_ring_llama_loss_and_gradients_match_jax(gang, jax_model, impl):
    """The tiny Llama with ``attention_fn=make_ring_attention(mesh)``
    (dense on CPU tensors, or ring-flash) against JAX's composition:
    the global mean loss and every parameter's gradient."""
    from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree

    loss, grads = gang[0]["llama"][impl]
    assert gang[1]["llama"][impl][0] == loss
    np.testing.assert_allclose(loss, float(jax_model["loss"]), rtol=1e-5)
    flat = flatten_jax_tree(jax.tree.map(np.asarray, jax_model["grads"]))
    assert set(flat) == set(grads)
    for name, want in flat.items():
        np.testing.assert_allclose(grads[name], want, atol=5e-5, rtol=5e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(gang[0]["positions"][0], np.arange(16))
    np.testing.assert_array_equal(gang[1]["positions"][1],
                                  np.arange(16, 32))


@pytest.mark.gang
def test_seq_parallel_step_gradient_is_the_whole_sequences(gang, jax_model):
    """One step on the seq=2 shards: the gradient that
    ``hvd.DistributedOptimizer`` averaged over the ranks (each the mean
    loss of its own 16 tokens) is the whole sequence's, computed in one
    process with dense attention."""
    from sparkdl_tpu_torch.models.lora import lora_mask

    model = _lora_model()
    mask = lora_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    loss = pt_train.make_lm_loss_fn(model)(jax_model["batch"])
    loss.backward()
    ring_loss, grads = gang[0]["step"]
    np.testing.assert_allclose(ring_loss, loss.item(), rtol=1e-5)
    want = {n: p.grad.numpy() for n, p in model.named_parameters()
            if mask[n]}
    assert set(grads) == set(want) and len(want) == 8
    for name, g in want.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(grads[name], g, atol=5e-5, rtol=5e-4,
                                   err_msg=name)
        np.testing.assert_array_equal(gang[1]["step"][1][name], grads[name])


def _one_rank_mesh():
    return make_mesh(MeshSpec(seq=1))


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_a_ring_of_one_rank_is_plain_attention(case, overlap):
    impl, causal = case
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw(4))
    ring = pt_ring.make_ring_attention(_one_rank_mesh(), causal=causal,
                                       impl=impl, overlap=overlap)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (ring(*leaves) * w).sum().backward()
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    out = pt_ring.attention_reference(*ref, causal=causal)
    (out * w).sum().backward()
    torch.testing.assert_close(ring(q, k, v), out.detach(), rtol=1e-5,
                               atol=2e-6)
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad, want.grad, rtol=5e-4,
                                   atol=5e-5)


def test_block_attend_and_merge_stats_match_jax():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(B, 8, H, D).astype(np.float32) for _ in range(3))
    k2, v2 = (rng.randn(B, 8, H, D).astype(np.float32) for _ in range(2))
    mask = np.tril(np.ones((8, 8), bool))
    jp = [jax_ring._block_attend(*map(jnp.asarray, (q, k, v)),
                                 jnp.asarray(mask), 0.3),
          jax_ring._block_attend(*map(jnp.asarray, (q, k2, v2)), None, 0.3)]
    pp = [pt_ring._block_attend(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(mask), 0.3),
          pt_ring._block_attend(*map(torch.from_numpy, (q, k2, v2)), None,
                                0.3)]
    for jb, pb in zip(jp, pp):
        for a, b in zip(jb, pb):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
    jm = jax_ring._merge_stats(*jp[0], *jp[1])
    pm = pt_ring._merge_stats(*pp[0], *pp[1])
    for a, b in zip(jm, pm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_lse_merge_matches_jax():
    """The port's lse is (B, H, S), the JAX ring's (B, H, S, 1) beside a
    (B, H, S, D) output: the same merge in each layout; a partial at
    NEG_INF (a masked hop) leaves the accumulator as it was."""
    rng = np.random.RandomState(6)
    acc_o, o = (rng.randn(B, 8, H, D).astype(np.float32) for _ in range(2))
    acc_lse, lse = (rng.randn(B, H, 8).astype(np.float32) for _ in range(2))
    jo, jl = jax_ring._lse_merge(
        jnp.asarray(acc_o.transpose(0, 2, 1, 3)), jnp.asarray(acc_lse)[..., None],
        jnp.asarray(o.transpose(0, 2, 1, 3)), jnp.asarray(lse)[..., None])
    po, pl = pt_ring._lse_merge(*map(torch.from_numpy,
                                     (acc_o, acc_lse, o, lse)))
    np.testing.assert_allclose(po.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl)[..., 0], rtol=1e-6)
    masked = pt_ring._lse_merge(
        torch.from_numpy(acc_o), torch.from_numpy(acc_lse),
        torch.zeros_like(torch.from_numpy(o)),
        torch.full_like(torch.from_numpy(lse), pt_ring.NEG_INF))
    torch.testing.assert_close(masked[0], torch.from_numpy(acc_o),
                               rtol=0, atol=0)
    torch.testing.assert_close(masked[1], torch.from_numpy(acc_lse),
                               rtol=0, atol=0)


def test_rope_table_covers_a_shards_positions():
    """A sequence shard's positions start at its offset: positions past
    ``max_cache_len`` (and past S) index a table sized from the largest,
    and the logits are those of a model whose table was long enough."""
    short = pt_llama.LlamaConfig.tiny(dtype=torch.float32, max_cache_len=8)
    model = pt_llama.init_weights(pt_llama.Llama(short, device="cpu"),
                                  torch.Generator().manual_seed(0))
    tokens = torch.arange(8)[None] % VOCAB
    positions = torch.arange(24, 32)
    got = model(tokens, positions)
    long = pt_llama.Llama.from_params(
        pt_llama.LlamaConfig.tiny(dtype=torch.float32, max_cache_len=64),
        model.state_dict(), device="cpu")
    torch.testing.assert_close(got, long(tokens, positions), rtol=0, atol=0)
    assert torch.isfinite(got).all()
    assert not torch.equal(got, model(tokens))


@pytest.mark.parametrize("kwargs,error", [
    ({"bq": 128}, NotImplementedError), ({"bk": 128}, NotImplementedError),
    ({"interpret": True}, NotImplementedError),
])
def test_ring_flash_refuses_tpu_settings(kwargs, error):
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(error, match=next(iter(kwargs))):
        pt_ring.ring_flash_attention(q, q, q, mesh=_one_rank_mesh(),
                                     **kwargs)


def test_make_ring_attention_refuses_interpret_and_unknown_impls():
    mesh = _one_rank_mesh()
    with pytest.raises(NotImplementedError, match="interpret"):
        pt_ring.make_ring_attention(mesh, interpret=False)
    with pytest.raises(ValueError, match="impl must be"):
        pt_ring.make_ring_attention(mesh, impl="pallas")
    assert pt_ring.resolve_overlap(None) is True
    assert pt_ring.resolve_overlap(0) is False


def test_shard_batch_on_a_mesh_gives_each_rank_its_block():
    """data x seq = 2 x 2 (a hand-built mesh: the layout, no group): each
    rank's rows by its data coordinate, its columns by its seq one, and
    their global positions; ranks that differ only on model share a
    block."""
    batch = {"inputs": np.arange(4 * 8).reshape(4, 8),
             "targets": np.arange(4 * 8).reshape(4, 8) + 100}
    for rank in range(8):
        mesh = Mesh(AXES, (2, 1, 2, 2), rank)
        d, s = mesh.axis_index("data"), mesh.axis_index("seq")
        got = pt_train.shard_batch(batch, mesh, seq_axis=True)
        rows, cols = slice(2 * d, 2 * d + 2), slice(4 * s, 4 * s + 4)
        np.testing.assert_array_equal(got["inputs"], batch["inputs"][rows,
                                                                    cols])
        np.testing.assert_array_equal(got["targets"],
                                      batch["targets"][rows, cols])
        np.testing.assert_array_equal(
            got["positions"], np.tile(np.arange(4 * s, 4 * s + 4), (2, 1)))
        rows_only = pt_train.shard_batch(batch, mesh)
        assert set(rows_only) == {"inputs", "targets"}
        np.testing.assert_array_equal(rows_only["inputs"],
                                      batch["inputs"][rows])
    with pytest.raises(ValueError, match="do not split evenly over seq"):
        pt_train.shard_batch({"inputs": np.zeros((2, 7))},
                             Mesh(AXES, (1, 1, 2, 1)), seq_axis=True)
    with pytest.raises(ValueError, match="needs the mesh"):
        pt_train.shard_batch(batch, seq_axis=True, rank=0, size=1)


def test_a_mesh_of_one_rank_exchanges_nothing():
    mesh = make_named_mesh("stage")
    assert mesh.shape == {"stage": 1} and mesh.axis_index("stage") == 0
    x = torch.arange(4.0, requires_grad=True)
    assert mesh.ppermute(x, "stage") is x
    assert all(y is x for y in mesh.ppermute_start((x, x), "stage").wait())
