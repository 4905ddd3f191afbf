"""The GPipe pipeline of the port against the JAX package on the CPU,
fp32 at the JAX tests' shapes (``tests/parallel/test_pipeline.py``)
with two stages.

One gang of two ranks on gloo (``HorovodRunner(np=-2)``, bounded like
``tests/test_torch_tp_serving.py``) on ``make_named_mesh("stage")``
returns every result to this process: the outputs under both
schedules, each rank's stage gradients of the loss every rank computes
from them, the ticks each rank ran and the hops each rank's backward
issued, in order. They are held against JAX ``make_pipeline`` on a
two-device ``("stage",)`` mesh and against sequential application.
In-process tests cover a one-stage mesh and the stacked-tree slicer.

cloudpickle sends this module's functions (the workers' main) by
value, so a worker imports the port and torch, never JAX."""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from sparkdl_tpu.parallel.pipeline import make_pipeline as jax_make_pipeline
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.parallel import pipeline as pt_pipe
from sparkdl_tpu_torch.parallel.mesh import make_named_mesh

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

N_STAGES = 2
# (d, m, mb) of the JAX tests' forward and gradient cases
FORWARD, GRADIENT = (16, 8, 4), (8, 8, 2)


def _case(d, m, mb, seed, bias=True):
    """The JAX tests' stacked params and microbatches, numpy fp32."""
    rng = np.random.RandomState(seed)
    stacked = {"w": (rng.randn(N_STAGES, d, d) * 0.3).astype(np.float32),
               "b": ((rng.randn(N_STAGES, d) * 0.1).astype(np.float32)
                     if bias else np.zeros((N_STAGES, d), np.float32))}
    return stacked, rng.randn(m, mb, d).astype(np.float32)


def _pt_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _pipe_main(cases):
    """Every rank: each case through the pipeline under both schedules,
    the loss sum(out^2) on every rank and its backward; the ticks and
    the backward's hops recorded. Rank 0 returns both ranks' results."""
    import torch

    from sparkdl_tpu_torch import hvd

    torch.set_num_threads(1)
    hvd.init()
    mesh = make_named_mesh("stage")
    stage = mesh.axis_index("stage")
    ticks, hops = [0], []
    exchange = mesh._exchange

    def logged(tensors, axis, step):
        if not torch.is_grad_enabled():  # inside a backward
            hops.append((step, [tuple(t.shape) for t in tensors]))
        return exchange(tensors, axis, step)

    mesh._exchange = logged

    def stage_fn(p, x):
        ticks[0] += 1
        return _pt_stage(p, x)

    out = {"stage": stage}
    for name, (stacked, micro) in cases.items():
        for overlap in (True, False):
            params = {k: torch.from_numpy(v).requires_grad_()
                      for k, v in pt_pipe.stage_slice(stacked, stage).items()}
            ticks[0] = 0
            hops.clear()
            pipe = pt_pipe.make_pipeline(mesh, stage_fn, overlap=overlap)
            y = pipe(params, torch.from_numpy(micro))
            (y ** 2).sum().backward()
            out[name, overlap] = {
                "out": y.detach().numpy(), "ticks": ticks[0],
                "n_stages": pipe.n_stages, "hops": list(hops),
                "grads": {k: p.grad.numpy() for k, p in params.items()}}
    return hvd.allgather_object(out)


@pytest.fixture(scope="module")
def cases():
    return {"forward": _case(*FORWARD, seed=0),
            "gradient": _case(*GRADIENT, seed=1, bias=False)}


@pytest.fixture(scope="module")
def jax_runs(cases):
    """JAX ``make_pipeline`` on two CPU devices: each case's outputs and
    the gradients of sum(out^2) for the stacked params."""
    mesh = JaxMesh(np.array(jax.devices()[:N_STAGES]), ("stage",))
    pipe = jax_make_pipeline(mesh, _jax_stage)
    out = {}
    for name, (stacked, micro) in cases.items():
        tree = jax.tree.map(jnp.asarray, stacked)
        x = jnp.asarray(micro)
        out[name] = (np.asarray(jax.jit(pipe)(tree, x)),
                     jax.tree.map(np.asarray, jax.jit(jax.grad(
                         lambda p: (pipe(p, x) ** 2).sum()))(tree)))
    return out


@pytest.fixture(scope="module")
def gang(cases):
    """Both ranks' results of one bounded gang: start within 60 s, end
    within 120 s."""
    saved = (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
             launcher.ABORT_GRACE_S)
    launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S = 60.0, 120.0
    launcher.ABORT_GRACE_S = 2.0
    try:
        return HorovodRunner(np=-2).run(_pipe_main, cases=cases)
    finally:
        (launcher.START_TIMEOUT_S, launcher.JOB_TIMEOUT_S,
         launcher.ABORT_GRACE_S) = saved


def _sequential(stacked, micro):
    x = torch.from_numpy(micro)
    for i in range(N_STAGES):
        x = _pt_stage({k: torch.from_numpy(v[i]) for k, v in stacked.items()},
                      x)
    return x


@pytest.mark.gang
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", ["forward", "gradient"])
def test_pipeline_outputs_match_jax_and_sequential(gang, cases, jax_runs,
                                                   name, overlap):
    for r in gang:
        got = r[name, overlap]["out"]
        np.testing.assert_allclose(got, jax_runs[name][0], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got, _sequential(*cases[name]).numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.gang
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", ["forward", "gradient"])
def test_pipeline_gradients_match_jax_grad(gang, jax_runs, name, overlap):
    """Each rank's stage gradients of the loss every rank computed: the
    JAX gradient of the stacked params at that stage."""
    want = jax_runs[name][1]
    for r in gang:
        for k, g in r[name, overlap]["grads"].items():
            np.testing.assert_allclose(g, want[k][r["stage"]], atol=1e-4,
                                       rtol=1e-4, err_msg=k)


@pytest.mark.gang
def test_the_loss_on_every_rank_counts_once(gang, cases):
    """Every rank calls backward on the same loss; the sum that
    replicated the last stage's outputs hands its cotangent back once:
    the gradients are sequential application's, not twice them."""
    stacked, micro = cases["gradient"]
    params = [{k: torch.from_numpy(v[i].copy()).requires_grad_()
               for k, v in stacked.items()} for i in range(N_STAGES)]
    x = torch.from_numpy(micro)
    for p in params:
        x = _pt_stage(p, x)
    (x ** 2).sum().backward()
    for r in gang:
        got = r["gradient", True]["grads"]["w"]
        want = params[r["stage"]]["w"].grad.numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert not np.allclose(got, N_STAGES * want, atol=1e-4, rtol=1e-4)


@pytest.mark.gang
@pytest.mark.parametrize("name", ["forward", "gradient"])
def test_both_schedules_are_bit_identical(gang, name):
    for r in gang:
        new, old = r[name, True], r[name, False]
        np.testing.assert_array_equal(new["out"], old["out"])
        for k in new["grads"]:
            np.testing.assert_array_equal(new["grads"][k], old["grads"][k])


@pytest.mark.gang
def test_ticks_and_the_order_of_backward_hops(gang, cases):
    """M + 2(P-1) ticks with the hop in flight, M + P - 1 serialized,
    every stage running stage_fn on every tick; each rank's backward
    issues the same reverse hops in the same order (a hop a tick but
    the last, whose arrival nothing reads)."""
    for name, (_, micro) in cases.items():
        m = micro.shape[0]
        for overlap, ticks in ((True, m + 2 * (N_STAGES - 1)),
                               (False, m + N_STAGES - 1)):
            runs = [r[name, overlap] for r in gang]
            assert [run["ticks"] for run in runs] == [ticks] * N_STAGES
            assert all(run["n_stages"] == N_STAGES for run in runs)
            hops = runs[0]["hops"]
            # overlap: the first tick's hop carries zeros (no gradient)
            assert len(hops) == ticks - 1 - overlap
            assert all(step == -1 and shapes == [micro.shape[1:]]
                       for step, shapes in hops)
            assert runs[1]["hops"] == hops


@pytest.mark.parametrize("overlap", [True, False])
def test_a_one_stage_pipeline_is_the_stage(cases, overlap):
    stacked, micro = cases["forward"]
    one = {k: v[:1] for k, v in stacked.items()}
    mesh = make_named_mesh("stage")
    calls = [0]

    def stage_fn(p, x):
        calls[0] += 1
        return _pt_stage(p, x)

    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in pt_pipe.stage_slice(one, 0).items()}
    pipe = pt_pipe.make_pipeline(mesh, stage_fn, overlap=overlap)
    assert pipe.n_stages == 1
    y = pipe(params, torch.from_numpy(micro))
    assert calls[0] == micro.shape[0]
    ref_params = {k: torch.from_numpy(v[0]).requires_grad_()
                  for k, v in one.items()}
    ref = _pt_stage(ref_params, torch.from_numpy(micro))
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    (y ** 2).sum().backward()
    (ref ** 2).sum().backward()
    for k in params:
        torch.testing.assert_close(params[k].grad, ref_params[k].grad)


def test_stage_slice_takes_each_leaf_at_the_stage():
    stacked = {"blocks": [{"w": np.arange(6).reshape(3, 2)},
                          (torch.arange(3) * 10, np.ones((3, 4)))],
               "b": torch.arange(12.0).reshape(3, 4)}
    got = pt_pipe.stage_slice(stacked, 1)
    np.testing.assert_array_equal(got["blocks"][0]["w"], [2, 3])
    assert isinstance(got["blocks"][1], tuple)
    assert int(got["blocks"][1][0]) == 10
    np.testing.assert_array_equal(got["blocks"][1][1], np.ones(4))
    torch.testing.assert_close(got["b"], torch.arange(4.0, 8.0))
