"""The port's graph lints against the JAX package's, scenario by scenario.

Each scenario of ``tests/analysis/test_graph_passes.py`` whose rule the
port has runs twice: the JAX program through
``sparkdl_tpu.analysis.lint_fn`` (8 host devices) and its PyTorch
counterpart through the port's ``lint_fn`` or ``lint_gang`` (a trace on
``meta`` tensors standing for the card). Both must give the same rule
ids and severities, or both be clean. Two JAX scenarios fail on this
jax (``test_f64_literal_inside_step_flagged``,
``test_debug_print_flagged``, ROADMAP): the port's counterpart is held
against the severity the JAX pass documents for them instead. The
JAX passes that read HLO or StableHLO text directly (the donation
signature parser, ``implicit-reshard``) have no port counterpart; the
memory and overlap passes are held on the same inputs, a context or
the counterpart program. Last, the launcher's pre-flight over a
registered step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparkdl_tpu import analysis as janalysis
from sparkdl_tpu.analysis.core import GraphContext as JaxContext
from sparkdl_tpu.analysis.passes_comms import hbm_overcommit as jax_hbm
from sparkdl_tpu.analysis.passes_comms import (
    unoverlapped_collective as jax_overlap,
)
from sparkdl_tpu.parallel.mesh import MeshSpec, make_mesh
from sparkdl_tpu.utils.jax_compat import shard_map
from sparkdl_tpu_torch import HorovodRunner, hvd
from sparkdl_tpu_torch import analysis
from sparkdl_tpu_torch.analysis import preflight
from sparkdl_tpu_torch.analysis.core import (
    GraphContext,
    ParamInfo,
    Severity,
    run_passes,
)
from sparkdl_tpu_torch.analysis.passes_comms import hbm_overcommit
from sparkdl_tpu_torch.analysis.trace import trace_step
from sparkdl_tpu_torch.horovod import launcher, supervisor
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh

torch.set_num_threads(2)


def by_rule(findings, rule_id):
    return [f for f in findings if f.rule_id == rule_id]


def key(findings):
    return sorted({(f.rule_id, int(f.severity)) for f in findings})


def same(jax_findings, port_findings):
    assert key(port_findings) == key(jax_findings), (
        "\n".join(map(str, jax_findings)) + "\n--\n"
        + "\n".join(map(str, port_findings)))


@pytest.fixture(scope="module")
def mesh_8():
    return make_mesh(MeshSpec(data=8))


@pytest.fixture(scope="module")
def mesh_2x4():
    return make_mesh(MeshSpec(data=2, model=4))


def _mesh(**axes):
    return Mesh(AXES, tuple(int(axes.get(a, 1)) for a in AXES))


# -- collective-consistency --------------------------------------------------


def _jax_sm(fn, mesh, out_specs=P("data")):
    return shard_map(fn, mesh, in_specs=P("data"), out_specs=out_specs,
                     check_vma=False)


def test_cond_branch_divergence_deadlock(mesh_8):
    """A collective on one branch only: JAX's data-dependent ``cond``;
    the port's branch on the rank's coordinate, which gives the ranks
    divergent sequences."""
    def inner(x):
        return jax.lax.cond(x.sum() > 0, lambda v: jax.lax.psum(v, "data"),
                            lambda v: v * 2.0, x)

    jf = by_rule(janalysis.lint_fn(_jax_sm(inner, mesh_8), jnp.ones((8, 4)),
                                   compile=False, mesh=mesh_8),
                 "collective-consistency")
    m = _mesh(data=8)

    def step(x):
        if m.axis_index("data") == 0:
            return m.all_reduce(x, "data")
        return x * 2.0

    pf = by_rule(analysis.lint_fn(step, torch.ones(1, 4), mesh=m),
                 "collective-consistency")
    same(jf, pf)
    assert "deadlock" in pf[0].message and "rank 0 and rank 1" in \
        pf[0].message


def test_matching_branches_are_clean(mesh_8):
    def inner(x):
        return jax.lax.cond(x.sum() > 0, lambda v: jax.lax.psum(v, "data"),
                            lambda v: jax.lax.psum(v * 2.0, "data"), x)

    jf = by_rule(janalysis.lint_fn(_jax_sm(inner, mesh_8), jnp.ones((8, 4)),
                                   compile=False, mesh=mesh_8),
                 "collective-consistency")
    m = _mesh(data=8)

    def step(x):
        if m.axis_index("data") == 0:
            return m.all_reduce(x, "data")
        return m.all_reduce(x * 2.0, "data")

    pf = by_rule(analysis.lint_fn(step, torch.ones(1, 4), mesh=m),
                 "collective-consistency")
    assert jf == [] and pf == []


def test_while_loop_collective_warns(mesh_8):
    """A collective under a trip count the step decides at run time:
    JAX's ``while``; the port's loop whose condition reads the card,
    where the trace ends (and host-sync-in-step has its own say)."""
    def inner(x):
        def body(c):
            i, v = c
            return i + 1, jax.lax.psum(v, "data")

        return jax.lax.while_loop(lambda c: c[0] < 3, body, (0, x))[1]

    jf = by_rule(janalysis.lint_fn(_jax_sm(inner, mesh_8), jnp.ones((8, 4)),
                                   compile=False, mesh=mesh_8),
                 "collective-consistency")
    m = _mesh(data=8)

    def step(x):
        i = torch.zeros((), dtype=torch.int32, device=x.device)
        while i < 3:
            x = m.all_reduce(x, "data")
            i = i + 1
        return x

    findings = analysis.lint_fn(step, torch.ones(1, 4), mesh=m)
    pf = by_rule(findings, "collective-consistency")
    same(jf, pf)
    assert by_rule(findings, "host-sync-in-step")[0].severity == \
        Severity.ERROR


def test_scan_collective_is_clean(mesh_8):
    """A static trip count: JAX's ``scan`` of ppermutes, the port's
    Python loop of ring hops."""
    def inner(x):
        def body(carry, _):
            carry = jax.lax.ppermute(carry, "data",
                                     [(i, (i + 1) % 8) for i in range(8)])
            return carry, None

        return jax.lax.scan(body, x, None, length=4)[0]

    jf = by_rule(janalysis.lint_fn(_jax_sm(inner, mesh_8), jnp.ones((8, 4)),
                                   compile=False, mesh=mesh_8),
                 "collective-consistency")
    m = _mesh(data=8)

    def step(x):
        for _ in range(4):
            x = m.ppermute(x, "data")
        return x

    pf = by_rule(analysis.lint_fn(step, torch.ones(1, 4), mesh=m),
                 "collective-consistency")
    assert jf == [] and pf == []


def test_cross_rank_order_divergence(mesh_8):
    def rank_a(x):
        return jax.lax.all_gather(jax.lax.psum(x, "data"), "data")

    def rank_b(x):
        return jax.lax.psum(jax.lax.all_gather(x, "data"), "data")

    x = jnp.ones((8, 4))
    with mesh_8:
        jf = janalysis.lint_gang(
            [_jax_sm(rank_a, mesh_8, P(None, "data")),
             _jax_sm(rank_b, mesh_8, P(None, "data"))],
            args_per_rank=[(x,), (x,)])
    m = _mesh(data=2)

    def port_a(t):
        return m.all_gather(m.all_reduce(t, "data"), "data", dim=0)

    def port_b(t):
        return m.all_reduce(m.all_gather(t, "data", dim=0), "data")

    t = torch.ones(1, 4)
    pf = analysis.lint_gang([port_a, port_b], args_per_rank=[(t,), (t,)],
                            mesh=m)
    same(jf, pf)
    assert "diverge" in pf[0].message and "port_a" not in pf[0].message
    assert "all-reduce(data)[f32]" in pf[0].message


def test_cross_rank_same_program_clean(mesh_8):
    def rank(x):
        return jax.lax.psum(x, "data")

    x = jnp.ones((8, 4))
    with mesh_8:
        jf = janalysis.lint_gang([_jax_sm(rank, mesh_8)] * 2,
                                 args_per_rank=[(x,), (x,)])
    m = _mesh(data=2)

    def port(t):
        return m.all_reduce(t, "data")

    t = torch.ones(1, 4)
    pf = analysis.lint_gang([port, port], args_per_rank=[(t,), (t,)], mesh=m)
    assert jf == [] and pf == []


def test_lint_gang_empty_is_empty():
    assert janalysis.lint_gang([]) == [] and analysis.lint_gang([]) == []


def test_hvd_rank_answers_for_the_traced_rank():
    """``hvd.rank()`` and ``hvd.size()`` under a trace are the traced
    rank's; outside it the process's own state is back."""
    from sparkdl_tpu_torch.hvd import _state

    seen = []
    before = _state.state().snapshot()

    def step(x):
        seen.append((hvd.rank(), hvd.size()))
        return hvd.allreduce(x)

    analysis.lint_fn(step, torch.ones(2), mesh={"data": 4})
    assert seen == [(r, 4) for r in range(4)]
    assert _state.state().snapshot() == before


def test_a_direct_torch_distributed_call_is_refused_by_name():
    from sparkdl_tpu_torch.analysis.trace import TracedCollectiveError

    def step(x):
        torch.distributed.all_reduce(x)
        return x

    with pytest.raises(TracedCollectiveError, match="all_reduce"):
        trace_step(step, torch.ones(2), mesh={"data": 2}, rank=0)
    assert torch.distributed.all_reduce.__module__.startswith("torch")


# -- full-param-allgather ----------------------------------------------------


def _jax_tp(mesh):
    shardings = {"w": NamedSharding(mesh, P(None, "model"))}
    params = {"w": jax.device_put(jnp.ones((16, 64), jnp.float32),
                                  shardings["w"])}
    x = jax.device_put(jnp.ones((8, 16), jnp.float32),
                       NamedSharding(mesh, P("data", None)))
    return params, shardings, x


def _port_tp():
    """This rank's (16, 16) block of a (16, 64) weight split over
    ``model=4``, on a (data=2, model=4) mesh."""
    return {"w": torch.ones(16, 16)}, {"w": (None, "model")}, _mesh(
        data=2, model=4)


def test_full_param_gather_flagged(mesh_2x4):
    params, shardings, x = _jax_tp(mesh_2x4)

    def bad(p, xb):
        wfull = jax.lax.with_sharding_constraint(
            p["w"], NamedSharding(mesh_2x4, P()))
        return (xb @ wfull).sum()

    jf = by_rule(janalysis.lint_fn(bad, params, x, mesh=mesh_2x4,
                                   params=params, shardings=shardings),
                 "full-param-allgather")
    pp, specs, m = _port_tp()

    def port_bad(p, xb):
        return (xb @ m.all_gather(p["w"], "model")).sum()

    pf = by_rule(analysis.lint_fn(port_bad, pp, torch.ones(4, 16), mesh=m,
                                  rank=0, params=pp, shardings=specs),
                 "full-param-allgather")
    same(jf, pf)
    assert pf[0].op == "all-gather" and "[w]" in pf[0].message


def test_sharded_matmul_clean(mesh_2x4):
    params, shardings, x = _jax_tp(mesh_2x4)

    def good(p, xb):
        y = xb @ p["w"]
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(mesh_2x4, P("data", "model"))).sum()

    jf = by_rule(janalysis.lint_fn(good, params, x, mesh=mesh_2x4,
                                   params=params, shardings=shardings),
                 "full-param-allgather")
    pp, specs, m = _port_tp()
    pf = by_rule(analysis.lint_fn(lambda p, xb: (xb @ p["w"]).sum(), pp,
                                  torch.ones(4, 16), mesh=m, rank=0,
                                  params=pp, shardings=specs),
                 "full-param-allgather")
    assert not [f for f in jf + pf if f.severity >= Severity.WARNING]


def test_activation_gather_shaped_like_a_whole_weight_is_clean():
    """The rule matches what a gather sends, not only its result's
    shape: the (16, 64) gather of a column-parallel product is an
    activation that happens to take the (16, 64) weight's whole shape,
    and is not flagged (ROADMAP C11); the same gather of the weight's
    own shard, cast first, is."""
    pp, specs, m = _port_tp()
    xb = torch.ones(16, 16)

    def activation(p, xb):
        return m.all_gather(xb @ p["w"], "model").sum()

    def weight(p, xb):
        return (xb @ m.all_gather(p["w"].double().float(), "model")).sum()

    clean, bad = (by_rule(analysis.lint_fn(f, pp, xb, mesh=m, rank=0,
                                           params=pp, shardings=specs),
                          "full-param-allgather")
                  for f in (activation, weight))
    assert clean == []
    assert [f.severity for f in bad] == [Severity.ERROR]


def test_transposed_whole_is_a_warning():
    """The same dims in another order: hvd's allgather stacks the four
    (16, 16) blocks of a (16, 64) weight along dim 0, a (64, 16) whole
    (the port's Mesh.all_gather lays it out whole, an ERROR above)."""
    pp = {"w": torch.ones(16, 16)}
    f = by_rule(analysis.lint_fn(lambda p: hvd.allgather(p["w"]).sum(), pp,
                                 mesh={"model": 4}, rank=0, params=pp,
                                 shardings={"w": (None, "model")}),
                "full-param-allgather")
    assert [x.severity for x in f] == [Severity.WARNING]
    assert "reordered" in f[0].message


def test_zero3_gather_is_flagged_as_the_jax_fsdp_step():
    """ZeRO-3's gathers (``gather_shards``) rebuild each whole weight by
    design; the JAX rule gives its ``fsdp`` step an ERROR (XLA
    all-gathers the whole weight), and the port's rule gives the same
    on the port's ZeRO-3 gather."""
    jmesh = make_mesh(MeshSpec(data=4, fsdp=2))
    sh = {"w": NamedSharding(jmesh, P("fsdp", None))}
    params = {"w": jax.device_put(jnp.ones((16, 64), jnp.float32), sh["w"])}
    x = jax.device_put(jnp.ones((8, 16), jnp.float32),
                       NamedSharding(jmesh, P(("data", "fsdp"), None)))
    jf = by_rule(janalysis.lint_fn(
        jax.grad(lambda p, xb: ((xb @ p["w"]) ** 2).mean()), params, x,
        mesh=jmesh, params=params, shardings=sh), "full-param-allgather")
    from sparkdl_tpu_torch.parallel.mesh import gather_shards

    m = _mesh(data=4, fsdp=2)
    shard = {"w": torch.ones(8, 64, requires_grad=True)}

    def step(p, xb):
        (w,) = gather_shards([p["w"]], (0,), m, "fsdp")
        ((xb @ w) ** 2).mean().backward()
        return p["w"].grad

    pf = by_rule(analysis.lint_fn(step, shard, torch.ones(1, 16), mesh=m,
                                  rank=0, params=shard,
                                  shardings={"w": ("fsdp", None)}),
                 "full-param-allgather")
    same(jf, pf)
    assert pf[0].severity == Severity.ERROR


# -- silent-canonicalization -------------------------------------------------


def test_f64_argument_flagged():
    jf = by_rule(janalysis.lint_fn(lambda x: x * 2,
                                   np.arange(4, dtype=np.float64),
                                   compile=False),
                 "silent-canonicalization")
    pf = by_rule(analysis.lint_fn(lambda x: x * 2,
                                  torch.arange(4, dtype=torch.float64)),
                 "silent-canonicalization")
    assert [f for f in pf if f.severity == Severity.ERROR][0].op == "float64"
    assert [f for f in jf if f.severity == Severity.ERROR]
    assert {(f.rule_id, int(f.severity)) for f in jf if f.severity ==
            Severity.ERROR} <= set(key(pf))


def test_f64_literal_inside_step_flagged():
    """The JAX scenario fails on this jax; the port's in-step 64-bit
    compute is held against the severity the JAX pass documents for its
    shadow trace (WARNING)."""
    assert "WARNING" in janalysis.all_passes()[
        "silent-canonicalization"].severities

    def step(x):
        return x * torch.tensor([0.5], dtype=torch.float64)

    pf = by_rule(analysis.lint_fn(step, torch.ones(4)),
                 "silent-canonicalization")
    assert [f.severity for f in pf] == [Severity.WARNING]
    assert "64 bits" in pf[0].message and "test_torch_graph_lint" in \
        pf[0].location


def test_f32_program_clean():
    jf = by_rule(janalysis.lint_fn(lambda x: x * 2.0, jnp.ones((4,)),
                                   compile=False), "silent-canonicalization")
    pf = by_rule(analysis.lint_fn(lambda x: x * 2.0, torch.ones(4)),
                 "silent-canonicalization")
    assert jf == [] and pf == []


# -- host-sync-in-step -------------------------------------------------------


def test_pure_callback_flagged():
    """A round trip through the host: JAX's ``pure_callback``, the
    port's copy to the host and back."""
    def jstep(x):
        y = jax.pure_callback(lambda a: np.asarray(a),
                              jax.ShapeDtypeStruct((4,), jnp.float32), x)
        return y * 2

    jf = by_rule(janalysis.lint_fn(jstep, jnp.ones((4,)), compile=False),
                 "host-sync-in-step")

    def pstep(x):
        return torch.from_numpy(x.cpu().numpy()).to(x.device) * 2

    pf = by_rule(analysis.lint_fn(pstep, torch.ones(4)), "host-sync-in-step")
    same(jf, pf)
    assert "copy to host" in pf[0].message


def test_debug_print_flagged():
    """The JAX scenario fails on this jax; its module doc flags debug
    prints at the callbacks' severity (ERROR), and so is the port's
    print of a card value."""
    assert "ERROR" in janalysis.all_passes()["host-sync-in-step"].severities

    def step(x):
        print(f"loss={x.sum().item()}")
        return x * 2

    pf = by_rule(analysis.lint_fn(step, torch.ones(4)), "host-sync-in-step")
    assert [f.severity for f in pf] == [Severity.ERROR]


def test_python_scalar_arg_warns():
    jf = by_rule(janalysis.lint_fn(lambda x, lr: x * lr, jnp.ones((4,)), 0.1,
                                   compile=False), "host-sync-in-step")
    pf = by_rule(analysis.lint_fn(lambda x, lr: x * lr, torch.ones(4), 0.1),
                 "host-sync-in-step")
    same(jf, pf)
    assert "weakly typed" in pf[0].message


def test_callback_found_in_lowered_artifact():
    """Linting an artifact the caller has: JAX's ``Lowered``, the port's
    trace (``lint_lowered``)."""
    def jstep(x):
        jax.debug.print("x={x}", x=x.sum())
        return x

    jf = by_rule(janalysis.lint_lowered(jax.jit(jstep).lower(jnp.ones((4,)))),
                 "host-sync-in-step")
    trace = trace_step(lambda x: x * x.sum().item(), torch.ones(4))
    pf = by_rule(analysis.lint_lowered(trace), "host-sync-in-step")
    same(jf, pf)
    assert not trace.complete and trace.stopped.kind == "scalar read"


def test_scalar_warning_does_not_mask_the_host_read():
    from sparkdl_tpu.analysis.passes_host import host_sync_in_step as jpass

    from sparkdl_tpu_torch.analysis.passes_host import host_sync_in_step

    def jstep(x):
        jax.debug.print("x={x}", x=x.sum())
        return x

    hlo = jax.jit(jstep).lower(jnp.ones((4,))).compile().as_text()
    jf = jpass(JaxContext(hlo_text=hlo, example_args=(3.0,)))
    trace = trace_step(lambda x: x * x.sum().item(), torch.ones(4))
    pf = host_sync_in_step(GraphContext(trace=trace, example_args=(3.0,)))
    same(jf, pf)


def test_a_data_dependent_shape_ends_the_trace():
    trace = trace_step(lambda x: x[x > 0].sum(), torch.ones(4))
    assert trace.stopped.kind == "data-dependent shape"
    (f,) = by_rule(analysis.lint_lowered(trace), "host-sync-in-step")
    assert f.severity == Severity.ERROR


def test_the_cpu_stands_for_itself():
    """Traced for the CPU, a host read waits for nothing: INFO, and the
    trace still ends there."""
    pf = by_rule(analysis.lint_fn(lambda x: x * x.sum().item(),
                                  torch.ones(4), device="cpu"),
                 "host-sync-in-step")
    assert [f.severity for f in pf] == [Severity.INFO]


# -- the clean model, every pass ---------------------------------------------


def test_clean_mnist_train_step_is_silent():
    """The full pass suite over the canonical clean model (the MNIST CNN,
    the stock step factory, the stock loss): nothing at any severity,
    for either package."""
    import optax

    from sparkdl_tpu.models.mnist_cnn import MnistCNN as JaxCNN
    from sparkdl_tpu.parallel.train import cross_entropy_loss as jax_ce
    from sparkdl_tpu.parallel.train import make_train_step as jax_step

    from sparkdl_tpu_torch.models.mnist_cnn import MnistCNN
    from sparkdl_tpu_torch.parallel.train import (
        cross_entropy_loss,
        make_train_step,
    )

    jm = JaxCNN()
    x = jnp.ones((2, 28, 28, 1), jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    opt = optax.adamw(1e-3)

    def jloss(p, batch):
        return jax_ce(jm.apply({"params": p}, batch["x"])[:, None, :],
                      batch["y"][:, None])

    jf = janalysis.lint_fn(jax_step(jloss, opt), params, opt.init(params),
                           {"x": x, "y": jnp.zeros((2,), jnp.int32)},
                           compile=True)
    model = MnistCNN(device="cpu")

    def loss_fn(batch):
        return cross_entropy_loss(model(batch["x"])[:, None, :],
                                  batch["y"][:, None])

    loss_fn.model = model
    step = make_train_step(loss_fn, torch.optim.AdamW(model.parameters(),
                                                      lr=1e-3), device="cpu")
    pf = analysis.lint_fn(step, {"x": np.ones((2, 28, 28, 1), np.float32),
                                 "y": np.zeros((2,), np.int32)},
                          params=model)
    assert jf == [] and pf == [], "\n".join(map(str, jf + pf))


def test_passes_degrade_on_empty_context():
    assert janalysis.run_passes(JaxContext()) == []
    assert run_passes(GraphContext()) == []


def test_param_info_accepts_bare_specs():
    """No mesh: every named axis counts as sharded, as JAX takes a bare
    PartitionSpec."""
    (j,) = janalysis.param_info_from({"w": jnp.ones((4, 8))},
                                     {"w": P(None, "model")})
    (p,) = analysis.param_info_from({"w": torch.ones(4, 8)},
                                    {"w": (None, "model")})
    assert p.sharded_axes == j.sharded_axes == ("model",)
    assert (p.shape, p.dtype) == (j.shape, j.dtype)


def test_param_info_ignores_size_one_axes():
    jmesh = make_mesh(MeshSpec(data=8, model=1))
    (j,) = janalysis.param_info_from(
        {"w": jnp.ones((4, 4))}, {"w": NamedSharding(jmesh, P(None, "model"))})
    (p,) = analysis.param_info_from({"w": torch.ones(4, 4)},
                                    {"w": (None, "model")},
                                    {"data": 8, "model": 1})
    assert p.sharded_axes == j.sharded_axes == ()


# -- undonated-step-buffers --------------------------------------------------


def _jax_state():
    return ({"w": jnp.ones((64, 32), jnp.float32)},
            {"w": jnp.zeros((64, 32), jnp.float32)},
            jnp.ones((4,), jnp.float32))


def _jax_step(p, m, batch):
    g = jax.tree.map(lambda w: w * 0.0 + batch.sum(), p)
    m2 = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
    return jax.tree.map(lambda w, mm: w - 0.01 * mm, p, m2), m2


def _port_state():
    return ({"w": torch.ones(64, 32)}, {"w": torch.zeros(64, 32)},
            torch.ones(4))


def _port_functional(p, m, batch):
    g = {k: w * 0.0 + batch.sum() for k, w in p.items()}
    m2 = {k: 0.9 * m[k] + 0.1 * g[k] for k in m}
    return {k: p[k] - 0.01 * m2[k] for k in p}, m2


def _port_in_place(p, m, batch):
    with torch.no_grad():
        for k in p:
            m[k].mul_(0.9).add_(0.1 * batch.sum())
            p[k].sub_(0.01 * m[k])
    return p, m


def test_undonated_param_sized_inputs_warned():
    params, moments, batch = _jax_state()
    jf = by_rule(janalysis.lint_fn(_jax_step, params, moments, batch,
                                   compile=False, params=params,
                                   shardings={"w": P()}),
                 "undonated-step-buffers")
    p, m, b = _port_state()
    pf = by_rule(analysis.lint_fn(_port_functional, p, m, b, params=p),
                 "undonated-step-buffers")
    same(jf, pf)
    assert "2 step input(s)" in pf[0].message


def test_in_place_step_is_clean():
    """JAX's donated step; the port's step that updates in place."""
    params, moments, batch = _jax_state()
    step = functools.partial(jax.jit, donate_argnums=(0, 1))(_jax_step)
    jf = by_rule(janalysis.lint_fn(step, params, moments, batch,
                                   compile=False, params=params,
                                   shardings={"w": P()}),
                 "undonated-step-buffers")
    p, m, b = _port_state()
    pf = by_rule(analysis.lint_fn(_port_in_place, p, m, b, params=p),
                 "undonated-step-buffers")
    assert jf == [] and pf == []


def test_heuristic_fires_only_on_steps_that_update_nothing_in_place():
    big = jnp.ones((1024, 1024), jnp.float32)
    opts = {"donation_min_elements": 1 << 20}

    def jstep(p, m, batch):
        return p - 0.01 * m, 0.9 * m + batch.sum()

    jf = by_rule(janalysis.lint_fn(jstep, big, big, jnp.ones((4,)),
                                   compile=False, options=opts),
                 "undonated-step-buffers")
    pbig = torch.ones(1024, 1024)
    pf = by_rule(analysis.lint_fn(jstep, pbig, pbig.clone(), torch.ones(4),
                                  options=opts), "undonated-step-buffers")
    same(jf, pf)
    assert "no input is updated in place" in pf[0].message
    jf = by_rule(janalysis.lint_fn(
        functools.partial(jax.jit, donate_argnums=(1,))(jstep), big, big,
        jnp.ones((4,)), compile=False, options=opts),
        "undonated-step-buffers")

    def one_in_place(p, m, batch):
        with torch.no_grad():
            m.mul_(0.9).add_(batch.sum())
        return p - 0.01 * m, m

    pf = by_rule(analysis.lint_fn(one_in_place, pbig, pbig.clone(),
                                  torch.ones(4), options=opts),
                 "undonated-step-buffers")
    assert jf == [] and pf == []


def test_inference_forward_with_params_is_silent():
    params, _, _ = _jax_state()
    jf = by_rule(janalysis.lint_fn(lambda p, b: b @ p["w"], params,
                                   jnp.ones((4, 64)), compile=False,
                                   params=params, shardings={"w": P()}),
                 "undonated-step-buffers")
    p, _, _ = _port_state()
    pf = by_rule(analysis.lint_fn(lambda q, b: b @ q["w"], p,
                                  torch.ones(4, 64), params=p),
                 "undonated-step-buffers")
    assert jf == [] and pf == []


def test_adamw_counts_both_moment_trees():
    import optax

    from sparkdl_tpu.parallel.train import make_train_step as jax_step

    params = {"w": jnp.ones((64, 32), jnp.float32)}
    opt = optax.adamw(1e-3)
    jf = by_rule(janalysis.lint_fn(
        jax_step(lambda p, b: ((b @ p["w"]) ** 2).mean(), opt), params,
        opt.init(params), jnp.ones((4, 64)), compile=False, params=params,
        shardings={"w": P()}), "undonated-step-buffers")

    def adam(p, mu, nu, batch):
        g = {k: w * 0.0 + batch.sum() for k, w in p.items()}
        mu2 = {k: 0.9 * mu[k] + 0.1 * g[k] for k in p}
        nu2 = {k: 0.999 * nu[k] + 0.001 * g[k] * g[k] for k in p}
        return ({k: p[k] - 1e-3 * mu2[k] / (nu2[k].sqrt() + 1e-8)
                 for k in p}, mu2, nu2)

    p = {"w": torch.ones(64, 32)}
    pf = by_rule(analysis.lint_fn(adam, p, {"w": torch.zeros(64, 32)},
                                  {"w": torch.zeros(64, 32)},
                                  torch.ones(4, 64), params=p),
                 "undonated-step-buffers")
    same(jf, pf)
    assert "3 step input(s)" in pf[0].message and "3 step input(s)" in \
        jf[0].message


def test_small_inputs_stay_silent():
    jf = by_rule(janalysis.lint_fn(lambda p, b: p + b.sum(), jnp.ones((8, 8)),
                                   jnp.ones((4,)), compile=False),
                 "undonated-step-buffers")
    pf = by_rule(analysis.lint_fn(lambda p, b: p + b.sum(), torch.ones(8, 8),
                                  torch.ones(4)), "undonated-step-buffers")
    assert jf == [] and pf == []


# -- hbm-overcommit ------------------------------------------------------------


def _stats(peak):
    return {"argument_size_in_bytes": peak // 2,
            "output_size_in_bytes": peak // 4,
            "temp_size_in_bytes": peak // 4, "alias_size_in_bytes": 0}


@pytest.mark.parametrize("peak,capacity,extra", [
    (2 * 2**30, 2**30, {}),
    (int(0.95 * 2**30), 2**30, {}),
    (2**28, 2**30, {}),
    (2**40, None, {"device_kind": "cpu"}),
], ids=["overcommit", "crowded", "fits", "no-capacity"])
def test_hbm_overcommit_is_the_jax_rule(peak, capacity, extra):
    opts = {"hbm_bytes_per_device": capacity, **extra}
    jf = jax_hbm(JaxContext(memory_stats=_stats(peak), options=opts))
    pf = hbm_overcommit(GraphContext(memory_stats=_stats(peak), options=opts))
    same(jf, pf)


def test_target_mesh_mode_surfaces_reshard_problems():
    from sparkdl_tpu.analysis.core import ParamInfo as JaxParamInfo

    kw = dict(path="['w']", shape=(16, 6), dtype="float32",
              sharded_axes=("model",), spec=((), ("model",)),
              mesh_axes=(("model", 2),))
    opts = {"hbm_bytes_per_device": 2**30, "target_mesh_axes": {"model": 4}}
    jf = jax_hbm(JaxContext(memory_stats={"temp_size_in_bytes": 1024},
                            param_info=[JaxParamInfo(**kw)], options=opts))
    pf = hbm_overcommit(GraphContext(memory_stats={"temp_size_in_bytes": 1024},
                                     param_info=[ParamInfo(**kw)],
                                     options=opts))
    same(jf, pf)
    assert pf[0].rule_id == "reshard-infeasible" and pf[0].op == "['w']"


def test_a_traced_step_over_the_card_is_refused():
    """The trace's own peak against a card of 1 MiB."""
    findings = analysis.lint_fn(lambda x: (x @ x.t()).sum(),
                                torch.ones(1024, 512),
                                options={"hbm_bytes_per_device": 1 << 20})
    (f,) = by_rule(findings, "hbm-overcommit")
    assert f.severity == Severity.ERROR and "OOMs" in f.message


# -- unoverlapped-collective -----------------------------------------------


_SYNC_HLO = """
HloModule step
ENTRY %main {
  %p0 = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %r = f32[1024]{0} add(f32[1024]{0} %ar, f32[1024]{0} %p0)
}
"""

_ASYNC_OVERLAPPED_HLO = """
HloModule step
ENTRY %main {
  %p0 = f32[1024]{0} parameter(0)
  %ar-start = f32[1024]{0} all-reduce-start(f32[1024]{0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %mm = f32[1024]{0} fusion(f32[1024]{0} %p0), kind=kLoop, calls=%fused
  %ar-done = f32[1024]{0} all-reduce-done(f32[1024]{0} %ar-start)
  ROOT %r = f32[1024]{0} add(f32[1024]{0} %ar-done, f32[1024]{0} %mm)
}
"""

_ASYNC_BACK_TO_BACK_HLO = """
HloModule step
ENTRY %main {
  %p0 = f32[1024]{0} parameter(0)
  %ar-start = f32[1024]{0} all-reduce-start(f32[1024]{0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ar-done = f32[1024]{0} all-reduce-done(f32[1024]{0} %ar-start)
  ROOT %r = f32[1024]{0} add(f32[1024]{0} %ar-done, f32[1024]{0} %p0)
}
"""

_SYNC_SERIALIZED_HOP_HLO = """
HloModule step
%body (p: (f32[1024], f32[1024])) -> (f32[1024], f32[1024]) {
  %p = (f32[1024]{0}, f32[1024]{0}) parameter(0)
  %blk = f32[1024]{0} get-tuple-element((f32[1024]{0}, f32[1024]{0}) %p), index=0
  %cp = f32[1024]{0} collective-permute(f32[1024]{0} %blk), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
  %mm = f32[1024]{0} fusion(f32[1024]{0} %cp), kind=kLoop, calls=%attend
  ROOT %t = (f32[1024]{0}, f32[1024]{0}) tuple(f32[1024]{0} %cp, f32[1024]{0} %mm)
}
"""

_SYNC_OVERLAPPED_HOP_HLO = """
HloModule step
%body (p: (f32[1024], f32[1024])) -> (f32[1024], f32[1024]) {
  %p = (f32[1024]{0}, f32[1024]{0}) parameter(0)
  %blk = f32[1024]{0} get-tuple-element((f32[1024]{0}, f32[1024]{0}) %p), index=0
  %cp = f32[1024]{0} collective-permute(f32[1024]{0} %blk), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
  %mm = f32[1024]{0} fusion(f32[1024]{0} %blk), kind=kLoop, calls=%attend
  ROOT %t = (f32[1024]{0}, f32[1024]{0}) tuple(f32[1024]{0} %cp, f32[1024]{0} %mm)
}
"""


# the mesh the overlap pairs' steps hold (a trace takes it as the traced
# rank's for the call)
_M4 = _mesh(data=4)


def _sync(x):
    return _M4.all_reduce(x, "data") + x


def _async_overlapped(x):
    h = hvd.allreduce_async(x)
    y = x * 3.0 + 1.0
    return h.result() + y


def _async_back_to_back(x):
    return hvd.allreduce_async(x).result() + x


def _no_collective(x):
    return x


def _serialized_hop(x):
    return _M4.ppermute(x, "data") * 2.0


def _overlapped_hop(x):
    pending = _M4.ppermute_start((x,), "data")
    y = x * 2.0
    (nxt,) = pending.wait()
    return nxt + y


@pytest.mark.parametrize("hlo,step", [
    (_SYNC_HLO, _sync), (_ASYNC_OVERLAPPED_HLO, _async_overlapped),
    (_ASYNC_BACK_TO_BACK_HLO, _async_back_to_back),
    ("ENTRY %main { ROOT %r = f32[4]{0} parameter(0)\n}", _no_collective),
    (_SYNC_SERIALIZED_HOP_HLO, _serialized_hop),
    (_SYNC_OVERLAPPED_HOP_HLO, _overlapped_hop),
], ids=["sync", "async-overlapped", "async-back-to-back", "none",
        "serialized-hop", "overlapped-hop"])
def test_unoverlapped_collective_pairs(hlo, step):
    jf = jax_overlap(JaxContext(hlo_text=hlo, options={
        "n_devices": 4, "device_kind": "cpu"}))
    trace = trace_step(step, torch.ones(1024), mesh=_M4, rank=0)
    assert len(trace.collectives) == (hlo.count("-start(")
                                      or hlo.count("all-reduce(")
                                      + hlo.count("collective-permute("))
    pf = by_rule(analysis.lint_lowered(trace), "unoverlapped-collective")
    same(jf, pf)
    assert [f.op for f in pf] == [f.op.replace("module", "step")
                                  for f in jf]
    if step is _sync:
        # the port's ring hop is an async batch of sends and receives,
        # waited at once: reported as such, where XLA's is a sync op
        assert "barrier-style (sync)" in pf[1].message


# -- the launcher's pre-flight -------------------------------------------------


class _WorkerSpawned(Exception):
    """Tripwire: the launcher reached subprocess.Popen."""


@pytest.fixture
def lint_on(monkeypatch):
    def boom(*a, **k):
        raise _WorkerSpawned(a[0] if a else "?")

    monkeypatch.setattr(preflight, "ENABLED", True)
    monkeypatch.setattr(launcher.subprocess, "Popen", boom)
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy())
    preflight.clear()
    yield
    preflight.clear()


def _noop_main():
    return 0


def _diverging(x):
    y = hvd.allreduce(x)
    if hvd.rank() == 1:
        y = hvd.allreduce(y)
    return y


def test_a_diverging_registered_step_refuses_the_launch(lint_on):
    analysis.register_preflight(_diverging, torch.ones(8), mesh={"data": 2})
    with pytest.raises(analysis.PreflightLintError) as e:
        HorovodRunner(np=-2).run(_noop_main)
    assert "collective-consistency" in {f.rule_id for f in e.value.findings}
    assert preflight.take_comms_reports() == []


def test_a_clean_registered_step_reaches_spawn_with_its_report(
        lint_on, monkeypatch):
    analysis.register_preflight(lambda x: hvd.allreduce(x) * 2,
                                torch.ones(8), mesh={"data": 2})
    reports = []
    real = preflight.take_comms_reports

    def take():
        reports.extend(real())
        return list(reports)

    monkeypatch.setattr(preflight, "take_comms_reports", take)
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_noop_main)
    (report,) = reports
    assert report["totals"]["count"] == 1
    assert report["collectives"][0]["group_size"] == 2


def test_a_registered_trace_is_linted(lint_on):
    from sparkdl_tpu_torch.parallel.train import lower_train_step

    trace = lower_train_step(lambda x: x * x.sum().item(), torch.ones(4),
                             cost_name=None)
    analysis.register_preflight(trace)
    with pytest.raises(analysis.PreflightLintError, match="host-sync"):
        HorovodRunner(np=-2).run(_noop_main)


def test_a_step_that_cannot_be_traced_launches_anyway(lint_on):
    def broken(x):
        raise KeyError("no such leaf")

    analysis.register_preflight(broken, torch.ones(4))
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_noop_main)


# -- the registry and the CLI ------------------------------------------------


def test_the_passes_are_the_jax_packages_less_implicit_reshard():
    from sparkdl_tpu_torch.analysis.core import all_passes, rule_catalog

    jax_passes = janalysis.all_passes()
    port = all_passes()
    assert set(port) == set(jax_passes) - {"implicit-reshard"}
    for rule_id, p in port.items():
        # the port's rules emit JAX's severities (host-sync adds INFO: a
        # host read traced for the CPU ends the trace and waits for
        # nothing)
        assert set(jax_passes[rule_id].severities) <= set(p.severities)
    assert set(port) <= set(rule_catalog())
    assert {"lock-order-cycle", "pickle-closure-capture",
            "reshard-infeasible"} <= set(rule_catalog())


def test_cli_lists_passes_and_refuses_the_jax_programs_by_name(capsys):
    from sparkdl_tpu_torch.analysis.__main__ import main

    assert main(["--list-passes"]) == 0
    listed = capsys.readouterr().out
    assert "collective-consistency" in listed and "lock-order" not in listed
    assert main(["--list-rules"]) == 0
    rules = capsys.readouterr().out
    assert "lock-order-cycle" in rules
    assert "[fixable: donate-step-buffers]" in rules
    # --graft lints the port's own program now (tests/test_torch_graft.py);
    # the modes that need it refuse to run without it, as JAX's CLI does
    for flags, prerequisite in ((["--comms"], "--graft"),
                                (["--comms-out", "x.json"], "--graft"),
                                (["--fix"], "--graft"),
                                (["--fixit-out", "x.json"], "--graft"),
                                (["--dry-run", "--graft", "2"], "--fix")):
        with pytest.raises(SystemExit) as e:
            main(flags)
        assert e.value.code == 2
        assert prerequisite in capsys.readouterr().err


# -- the port's own mesh steps -------------------------------------------------


@pytest.mark.parametrize("axes,errors", [({"model": 2}, False),
                                         ({"fsdp": 2}, True)],
                         ids=["tensor-parallel", "zero3"])
def test_the_stock_mesh_steps(axes, errors):
    """The port's LoRA step on a TP and a ZeRO-3 Llama, linted over both
    ranks: TP moves activations and gathers no weight; ZeRO-3 gathers
    each block's weights whole by design, which the rule flags as JAX's
    does on its ``fsdp`` step (``test_zero3_gather_is_flagged_as_the_jax_
    fsdp_step``). Its saved-tensor hooks find the gathered weights again
    under a trace, where every storage's data_ptr is 0."""
    from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
    )

    cfg = LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                           vocab_size=512, lora_rank=4, dtype=torch.float32)
    full = init_weights(Llama(cfg, device="cpu"),
                        torch.Generator().manual_seed(0)).state_dict()
    mesh = _mesh(**axes)
    model = Llama.from_params(cfg, full, mesh=mesh, device="cpu")
    mask = lora_mask(model)
    opt = torch.optim.AdamW([p for n, p in model.named_parameters()
                             if mask[n]], lr=1e-3)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device="cpu")
    findings = analysis.lint_fn(
        step, global_batch(np.random.default_rng(0), 512, 2, 16), mesh=mesh,
        params=model)
    assert not by_rule(findings, "collective-consistency")
    gathers = by_rule(findings, "full-param-allgather")
    assert bool(gathers) == errors
    assert all(f.severity == Severity.ERROR for f in gathers)
    assert [f for f in findings if f.severity == Severity.ERROR] == gathers
