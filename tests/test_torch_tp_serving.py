"""Tensor-parallel serving of the port against the JAX package on the
CPU: the sharding rules leaf for leaf against the JAX ``param_sharding``
(divisibility fallback and stacked-adapter left-pad included), the
ranks' slices rebuilding each leaf, a JAX tree landed on one rank's
shards, the sharded paged decode on local heads against the whole
plain decode, the refusals by name; and one gang of two ranks on gloo
(``HorovodRunner(np=-2)``, bounded like ``tests/test_torch_gang.py``)
whose TP=2 engines give the JAX TP engine's greedy tokens on
``MeshSpec(data=4, model=2)`` (``tests/conftest.py``'s 8 CPU devices)
and the port's single-rank engine's, exactly, for the dense and paged
caches, int8 and int4, a shared prefix with chunked prefill and
multi-LoRA, with both ranks identical, at temperature > 0 too.

cloudpickle sends this module's functions (the workers' main) by
value, so a worker imports the port and torch, never JAX."""

import dataclasses
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.models import quant as jax_quant
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel import sharding as jax_sharding
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.fleet import EngineWorker
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree, load_jax_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.observe.metrics import Registry
from sparkdl_tpu_torch.ops import paged_attention as pt_paged
from sparkdl_tpu_torch.parallel import mesh as pt_mesh
from sparkdl_tpu_torch.parallel import sharding as pt_sharding
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

# fp32, group 16: the row-parallel int4 projections keep whole groups
# (o_proj's K 64 is 4 groups, 2 a rank)
CFG = dict(max_cache_len=64, quant_group=16)
LORA = dict(lora_rank=4, lora_targets=("q_proj", "v_proj", "o_proj"))


def _jax_cfg(**kw):
    return jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **CFG, **kw)


def _pt_cfg(**kw):
    return pt_llama.LlamaConfig.tiny(dtype=torch.float32, **CFG, **kw)


def _with_new_adapters(tree, seed):
    """Fresh non-zero lora_a and lora_b on the same frozen base."""
    k = jax.random.PRNGKey(seed)

    def leaf(path, x):
        nonlocal k
        if str(getattr(path[-1], "key", "")) in ("lora_a", "lora_b"):
            k, sub = jax.random.split(k)
            return jax.random.normal(sub, x.shape, x.dtype) * 0.05
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def trees():
    """JAX param trees: dense (widened 1.7x, as test_torch_serving.py),
    int8, int4 and two stacked adapters on the dense base."""
    seedp = jnp.zeros((1, 8), jnp.int32)
    dense = jax_llama.Llama(_jax_cfg()).init(jax.random.PRNGKey(0),
                                             seedp)["params"]
    dense = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, dense)
    lora = jax_llama.Llama(_jax_cfg(**LORA)).init(jax.random.PRNGKey(0),
                                                  seedp)["params"]
    lora = jax.tree_util.tree_map_with_path(
        lambda path, p: p * 1.7 if p.ndim == 2 and "lora" not in str(path)
        else p, lora)
    stacked = jax_lora.stack_lora_adapters(
        [_with_new_adapters(lora, 3), _with_new_adapters(lora, 1)])
    return {"dense": dense,
            "int8": jax_quant.quantize_llama_params(dense),
            "int4": jax_quant.quantize_llama_params(dense, bits=4, group=16),
            "multi_lora": stacked}


def _pt_mesh(spec, rank=0):
    return Mesh(AXES, spec.axis_sizes(), rank)


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


SPECS = [jax_mesh.MeshSpec(data=4, model=2), jax_mesh.MeshSpec(model=8)]


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "multi_lora"])
@pytest.mark.parametrize("spec", SPECS, ids=["data4_model2", "model8"])
def test_param_sharding_matches_the_jax_specs_leaf_for_leaf(trees, kind,
                                                            spec):
    tree = trees[kind]
    want = _flat_specs(jax_sharding.param_sharding(
        tree, jax_sharding.TRANSFORMER_RULES, jax_mesh.make_mesh(spec)))
    got = pt_sharding.param_sharding(
        flatten_jax_tree(jax.tree.map(np.asarray, tree)),
        pt_sharding.TRANSFORMER_RULES, _pt_mesh(spec))
    assert got == want
    # both fallbacks show: the int8 scale (N,) by ndim, stacked adapters
    # left-padded, and at model=8 the int4 scales (4 rows) by divisibility
    if kind == "int8":
        assert got["layers.0.attn.q_proj.kernel_scale"] == ()
    if kind == "multi_lora":
        assert got["layers.0.attn.q_proj.lora_b"] == (None, None, "model")
    if kind == "int4" and spec.model == 8:
        assert got["layers.0.attn.o_proj.kernel_scale4"] == ()


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "multi_lora"])
def test_both_ranks_shards_rebuild_every_leaf(trees, kind):
    flat = flatten_jax_tree(jax.tree.map(np.asarray, trees[kind]))
    spec = jax_mesh.MeshSpec(model=2)
    layout = pt_sharding.tp_layout(flat, pt_sharding.TRANSFORMER_RULES,
                                   _pt_mesh(spec))
    shards = [pt_sharding.shard_params(flat, layout, _pt_mesh(spec, r))
              for r in range(2)]
    n_split = 0
    for name, leaf in flat.items():
        dims = [d for d, e in enumerate(layout[name]) if e == "model"]
        if not dims:
            assert all(s[name] is leaf for s in shards), name
            continue
        n_split += 1
        assert all(s[name].flags.c_contiguous for s in shards), name
        np.testing.assert_array_equal(
            np.concatenate([s[name] for s in shards], axis=dims[0]), leaf,
            err_msg=name)
    assert n_split > 0
    if kind == "int8":
        # the port's own split of a companion: a column-parallel int8
        # scale is sliced with its columns, a row-parallel one kept whole
        assert layout["layers.0.attn.q_proj.kernel_scale"] == ("model",)
        assert layout["layers.0.attn.o_proj.kernel_scale"] == ()
    if kind == "multi_lora":
        assert layout["layers.0.attn.o_proj.lora_a"] == (None, "model",
                                                         None)
        assert layout["layers.0.attn.o_proj.lora_b"] == ()


@pytest.mark.parametrize("rank", [0, 1])
def test_a_jax_tree_lands_on_one_ranks_shards(trees, rank):
    """``load_jax_params`` of the whole tree into a tensor-parallel model
    (no process group is needed to load) gives exactly that rank's
    slices, and ``Llama.from_params`` of the whole state dict the
    same."""
    spec = jax_mesh.MeshSpec(model=2)
    mesh = _pt_mesh(spec, rank)
    tree = jax.tree.map(np.asarray, trees["int4"])
    cfg = _pt_cfg(quant="int4")
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu", mesh=mesh),
                            tree)
    flat = flatten_jax_tree(tree)
    local = pt_sharding.shard_params(flat, model.tp_specs, mesh)
    state = model.state_dict()
    assert set(state) == set(local)
    for name, value in local.items():
        np.testing.assert_array_equal(state[name].numpy(), value,
                                      err_msg=name)
    assert state["lm_head.kernel_q4"].shape == (32, 128)
    assert state["layers.0.attn.o_proj.kernel_q4"].shape == (16, 64)
    full = load_jax_params(pt_llama.Llama(cfg, device="cpu"), tree)
    again = pt_llama.Llama.from_params(cfg, full.state_dict(), "cpu",
                                       mesh=mesh)
    for name, value in again.state_dict().items():
        assert torch.equal(value, state[name]), name


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_paged_decode_on_local_heads_matches_the_whole(
        monkeypatch, rank):
    """K1 on this rank's q heads and kv heads gives the whole plain
    decode's heads of this rank, and runs no collective."""
    import torch.distributed as dist

    for name in ("all_reduce", "all_gather_into_tensor", "broadcast"):
        monkeypatch.setattr(dist, name, lambda *a, **k: pytest.fail(
            "the sharded decode ran a collective"))
    g = torch.Generator().manual_seed(7)
    b, h, hkv, d, page, n_pages = 3, 8, 4, 16, 8, 12
    q = torch.randn((b, h, d), generator=g)
    k_pool = torch.randn((n_pages, page, hkv, d), generator=g)
    v_pool = torch.randn((n_pages, page, hkv, d), generator=g)
    tables = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 0, 0]],
                          dtype=torch.int32)
    lens = torch.tensor([20, 9, 1], dtype=torch.int32)
    whole = pt_paged.paged_attention_decode_reference(q, k_pool, v_pool,
                                                      tables, lens)
    mesh = _pt_mesh(jax_mesh.MeshSpec(model=2), rank)
    f = pt_paged.paged_attention_decode_sharded(mesh, n_heads=h,
                                                n_kv_heads=hkv)
    hl, kl = h // 2, hkv // 2
    got = f(q[:, rank * hl:(rank + 1) * hl].contiguous(),
            k_pool[:, :, rank * kl:(rank + 1) * kl].contiguous(),
            v_pool[:, :, rank * kl:(rank + 1) * kl].contiguous(),
            tables, lens)
    torch.testing.assert_close(got, whole[:, rank * hl:(rank + 1) * hl],
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="local query heads"):
        f(q, k_pool[:, :, :kl].contiguous(), v_pool[:, :, :kl].contiguous(),
          tables, lens)


@pytest.mark.parametrize("n,kw", [(8, {}), (8, dict(model_parallel=2)),
                                  (8, dict(model_parallel=2, fsdp=True)),
                                  (16, dict(model_parallel=4,
                                            seq_parallel=2))])
def test_mesh_helpers_match_the_jax_ones(n, kw):
    assert pt_mesh.best_mesh(n, **kw).axis_sizes() == \
        jax_mesh.best_mesh(n, **kw).axis_sizes()
    assert pt_mesh.log2_factors(n) == jax_mesh.log2_factors(n)
    with pytest.raises(ValueError, match="not divisible"):
        pt_mesh.best_mesh(n, model_parallel=3)


def test_a_mesh_without_a_process_group_is_one_rank():
    """Outside a gang the world is this rank: every axis of size 1, no
    group, collectives that return their input; a spec of another size,
    or an unknown axis, raises."""
    mesh = pt_mesh.make_mesh()
    assert mesh.shape == dict(zip(AXES, (1, 1, 1, 1))) and not mesh.groups
    x = torch.arange(6.0).reshape(2, 3)
    for op in (mesh.all_reduce, mesh.all_gather, mesh.broadcast):
        assert op(x, "model") is x
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pt_mesh.make_mesh(pt_mesh.MeshSpec(model=2))
    with pytest.raises(ValueError, match="unknown mesh axes"):
        pt_mesh.make_mesh_from_axes({"tensor": 2})
    assert pt_mesh.make_mesh_from_axes({"model": 1}).axis_size("model") == 1
    # row-major over (data, fsdp, seq, model): model varies fastest
    assert Mesh(AXES, (2, 1, 1, 2), rank=3).coords == {
        "data": 1, "fsdp": 0, "seq": 0, "model": 1}


def _dense_model():
    return pt_llama.Llama(_pt_cfg(), device="cpu")


@pytest.mark.parametrize("case", [
    "kv_heads", "data_split", "vocab_split", "int4_groups", "fleet"])
def test_refusals_name_what_is_not_ported(case):
    model = _dense_model()
    tp2 = _pt_mesh(jax_mesh.MeshSpec(model=2))
    if case == "kv_heads":
        # tiny has 2 kv heads: 4 ranks cannot hold whole ones
        with pytest.raises(NotImplementedError, match="n_kv_heads=2"):
            ContinuousBatchingEngine(
                model, model.state_dict(), page_size=8, device="cpu",
                mesh=_pt_mesh(jax_mesh.MeshSpec(model=4)))
    elif case == "data_split":
        rules = [(r"q_proj.*kernel", ("data", None))]
        with pytest.raises(NotImplementedError,
                           match=r"layers\.0\.attn\.q_proj\.kernel"):
            pt_llama.Llama(model.cfg, device="cpu", rules=rules,
                           mesh=_pt_mesh(jax_mesh.MeshSpec(data=2,
                                                           model=2)))
    elif case == "vocab_split":
        rules = [(r"embed.*embedding", ("model", None))]
        with pytest.raises(NotImplementedError, match="embed.embedding"):
            pt_llama.Llama(model.cfg, device="cpu", rules=rules, mesh=tp2)
    elif case == "int4_groups":
        # group 64 leaves o_proj's K 64 one group: no whole group a rank
        with pytest.raises(NotImplementedError,
                           match="o_proj.kernel_scale4"):
            pt_llama.Llama(dataclasses.replace(_pt_cfg(quant="int4"),
                                               quant_group=64),
                           device="cpu", mesh=tp2)
    else:
        class TPEngine:
            mesh = tp2

        with pytest.raises(NotImplementedError, match="mesh"):
            EngineWorker(0, TPEngine, Registry())


# -- one gang of two ranks --------------------------------------------------

def _requests(vocab):
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (5, 9, 13)]
    # 20 crosses the 8-row pages more than once
    return prompts, [6, 20, 7]


PREFIX_LEN = 6

# engine arguments, and whether requests extend a shared prefix
CASES = {
    "dense": (dict(page_size=0), False),
    "paged_prefix_chunked": (dict(page_size=8, prefill_chunk=4), True),
    "int8": (dict(page_size=8, quant="int8"), False),
    "int4": (dict(page_size=8, quant="int4"), False),
    "multi_lora": (dict(page_size=8), False),
}


def _serve(engine, vocab, prefix, adapters):
    """The case's requests through ``engine``: (tokens, finish reasons,
    logprobs, stats)."""
    prompts, budgets = _requests(vocab)
    pid = None
    if prefix:
        shared = prompts[1][:PREFIX_LEN]
        prompts = [np.concatenate([shared, p]) for p in prompts]
        pid = engine.register_prefix(shared)
    rids = [engine.submit(p, b, prefix_id=pid,
                          adapter_id=i % 2 if adapters else 0)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    res = engine.run()
    return ([np.asarray(res[r]).tolist() for r in rids],
            [engine.finish_reasons[r] for r in rids],
            [np.asarray(engine.logprobs[r]).tolist() for r in rids],
            {k: engine.stats.get(k, 0) for k in
             ("steps", "active_slot_steps", "total_slot_steps",
              "prefill_segments", "prefill_tokens_saved")})


def _port_engine(flat, case, mesh=None, **kw):
    kwargs, _ = CASES[case]
    cfg = _pt_cfg(**(dict(LORA, multi_lora=2) if case == "multi_lora"
                     else {}))
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu"), flat)
    return ContinuousBatchingEngine(model, model.state_dict(), n_slots=2,
                                    chunk=4, device="cpu", mesh=mesh,
                                    **kwargs, **kw)


def _tp_main(flats):
    """Every rank: a TP=2 mesh, each case's engine with ``mesh=``, and a
    sampled run (temperature 0.8, top-k 8); rank 0 returns both ranks'
    results."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    hvd.init()
    mesh = make_mesh(MeshSpec(model=hvd.size()))
    out = {}
    for case, (_, prefix) in CASES.items():
        engine = _port_engine(flats[case], case, mesh)
        assert engine._model.n_kv_heads == 1  # one of tiny's 2 a rank
        out[case] = _serve(engine, 256, prefix, case == "multi_lora")
    out["sampled"] = _serve(_port_engine(flats["paged_prefix_chunked"],
                                         "paged_prefix_chunked", mesh,
                                         temperature=0.8, top_k=8),
                            256, True, False)
    return hvd.allgather_object(out)


@pytest.fixture(scope="module")
def gang(trees):
    """Both ranks' results of one bounded gang: start within 60 s, end
    within 120 s."""
    saved = (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
             launcher.ABORT_GRACE_S)
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 120.0
    launcher.ABORT_GRACE_S = 2.0
    try:
        flats = {case: flatten_jax_tree(jax.tree.map(
            np.asarray, trees["multi_lora" if case == "multi_lora" else
                              "dense"])) for case in CASES}
        return flats, HorovodRunner(np=-2).run(_tp_main, flats=flats)
    finally:
        (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
         launcher.ABORT_GRACE_S) = saved


@pytest.mark.gang
@pytest.mark.parametrize("case", list(CASES))
def test_tp2_gang_gives_the_jax_tp_engines_tokens(trees, gang, case):
    flats, ranks = gang
    kwargs, prefix = CASES[case]
    kwargs = dict(kwargs)
    multi = case == "multi_lora"
    jcfg = _jax_cfg(**(dict(LORA, multi_lora=2) if multi else {}))
    if "quant" in kwargs:
        kwargs["quant_kernel"] = "off"
    jeng = jax_serving.ContinuousBatchingEngine(
        jax_llama.Llama(jcfg), trees["multi_lora" if multi else "dense"],
        n_slots=2, chunk=4,
        mesh=jax_mesh.make_mesh(jax_mesh.MeshSpec(data=4, model=2)),
        **kwargs)
    jtoks, jreasons, _, jstats = _serve(jeng, 256, prefix, multi)
    single = _serve(_port_engine(flats[case], case), 256, prefix, multi)
    tp = ranks[0][case]
    assert tp[0] == jtoks
    assert tp[0] == single[0]
    assert tp[1] == jreasons == single[1]
    assert tp[3] == single[3]
    assert tp[3]["steps"] == jstats["steps"]
    # the rank's logprobs: the single rank's, summed in another order
    np.testing.assert_allclose(np.concatenate(tp[2]),
                               np.concatenate(single[2]), atol=1e-4)
    assert ranks[1][case] == tp


@pytest.mark.gang
def test_tp2_ranks_sample_alike_at_temperature(gang):
    _, ranks = gang
    assert ranks[0]["sampled"] == ranks[1]["sampled"]
    toks, reasons, lps, _ = ranks[0]["sampled"]
    assert [len(t) for t in toks] == [6, 20, 7]
    assert set(reasons) == {"length"}
    assert all(np.isfinite(v).all() for v in lps)
