"""The port's HorovodRunner gangs, for real: five tests, each a gang of
two worker processes on gloo (the tests run without a card), each
bounded by the launcher's own start and job timeouts (patched below) so
that none can hang the run:

1. the collective battery (expected values computed here in numpy from
   the JAX engine's semantics), ``log_to_driver`` lines on the driver's
   stdout, an oversized stdout line, rank 0's return value, and
   ``tests/horovod/test_frameworks.py::_torch_main`` on the port against
   that file's own oracle, through its own ``import horovod.torch``;
2. the data-parallel LoRA step: each rank takes half of a global batch
   through ``shard_batch`` and ``DistributedOptimizer``; rank 0's
   adapters against the JAX package's single-process step on the whole
   batch from the same weights;
3. a worker that raises fails the run with its traceback, and no worker
   process is left;
4. under a supervisor policy with retries, a rank SIGKILLed mid-run
   (first attempt only) is relaunched once and the run resumes from the
   latest checkpoint onto the uninterrupted run's result;
5. a user exception under the same policy runs exactly one attempt.

cloudpickle sends this module's functions (the workers' mains) by value,
so a worker imports the port and torch, never this module or JAX.
"""

import os
import sys

import cloudpickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import lora as jax_lora
from sparkdl_tpu.parallel import train as jax_train
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher, supervisor
from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree
from sparkdl_tpu_torch.parallel.train import global_batch
from tests.horovod.test_frameworks import _torch_reference_step

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

pytestmark = pytest.mark.gang


@pytest.fixture(autouse=True)
def bounded_gangs(monkeypatch):
    """Each gang must start within 60 s and end within 120 s; a failed
    worker's peers are killed 2 s after it."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)


def _battery_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return {
        "f32": rng.standard_normal((5, 3)).astype(np.float32),
        "f64": rng.standard_normal((4,)),
        "i32": rng.integers(-50, 50, (5, 3)).astype(np.int32),
        "i16": rng.integers(-300, 300, (6,)).astype(np.int16),
        "bool": rng.random((7,)) > 0.5,
        "ragged": rng.standard_normal((rank + 2, 3)).astype(np.float32),
        "a2a": np.arange(6, dtype=np.float32) + 100 * rank,
        "rs": rng.standard_normal((4, 2)).astype(np.float32),
        "rs_i": rng.integers(-9, 9, (4,)).astype(np.int32),
    }


def _battery_main(inputs):
    """Every collective on this rank's inputs; rank 0 returns what both
    ranks got (an allgather_object), and the port's run of
    ``_torch_main`` of tests/horovod/test_frameworks.py."""
    import sys

    import numpy as np
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import log_to_driver

    torch.set_num_threads(2)
    hvd.init()
    r, n = hvd.rank(), hvd.size()
    x = inputs[r]
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {"rank": r, "size": n}
    for op in ("average", "sum", "min", "max"):
        out[f"f32_{op}"] = hvd.allreduce(x["f32"], op=op)  # numpy in/out
        out[f"i32_{op}"] = hvd.allreduce(t["i32"], op=op).numpy()
        out[f"bool_{op}"] = hvd.allreduce(t["bool"], op=op).numpy()
    out["f64_avg"] = hvd.allreduce(t["f64"]).numpy()
    out["i16_sum"] = hvd.allreduce(t["i16"], average=False).numpy()
    out["ragged"] = hvd.allgather(t["ragged"]).numpy()
    out["bcast"] = hvd.broadcast(t["f32"], 1).numpy()
    out["a2a_equal"] = hvd.alltoall(t["a2a"]).numpy()
    splits = [1, 5] if r == 0 else [4, 2]
    out["a2a_splits"] = hvd.alltoall(t["a2a"], splits=splits).numpy()
    out["rs_sum"] = hvd.reducescatter(t["rs"], op=hvd.Sum).numpy()
    out["rs_avg"] = hvd.reducescatter(t["rs"]).numpy()
    out["rs_max"] = hvd.reducescatter(t["rs"], op=hvd.Max).numpy()
    out["rs_i_avg"] = hvd.reducescatter(t["rs_i"]).numpy()
    grouped = hvd.grouped_allreduce([t["f32"], t["i32"], t["f32"][:2]],
                                    op=hvd.Sum)
    out["grouped"] = [g.numpy() for g in grouped]
    handle = hvd.allreduce_async(t["f32"], op=hvd.Max)
    hvd.barrier()
    out["async_max"] = handle.result().numpy()
    out["bobj"] = hvd.broadcast_object({"from": r, "pad": "p" * 100 * r},
                                       root_rank=1)
    out["gobj"] = hvd.allgather_object(("rank", r, "x" * (r + 1)))
    synced = hvd.broadcast(t["f32"], 0)
    out["synced"] = hvd.check_synchronized({"w": synced, "b": [synced]})
    try:
        hvd.check_synchronized({"w": t["f32"]})
        out["diverged"] = None
    except RuntimeError as e:
        out["diverged"] = str(e)
    out["diverged_atol"] = hvd.check_synchronized(
        [synced + 1e-3 * r], atol=1e-2)

    # tests/horovod/test_frameworks.py::_torch_main, with its own import
    # of horovod.torch, which the worker binds to the port
    import horovod.torch as hvd_torch

    hvd_torch.init()
    torch.manual_seed(1234 + hvd_torch.rank())
    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    opt = hvd_torch.DistributedOptimizer(opt)
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd_torch.broadcast_optimizer_state(opt, root_rank=0)
    xs = torch.full((8, 4), float(hvd_torch.rank() + 1))
    loss = ((model(xs) - torch.zeros(8, 1)) ** 2).mean()
    loss.backward()
    opt.step()
    flat = np.concatenate(
        [p.detach().numpy().ravel() for p in model.parameters()])
    gathered = hvd_torch.allgather(flat[None, :])
    # the framework shims are bound too, and a torch main pulls in no
    # framework it does not import itself
    import horovod.keras

    keras = {"module": horovod.keras.__name__,
             "frameworks": sorted({"tensorflow", "keras"}
                                  & set(sys.modules))}
    out["torch_main"] = {
        "size": hvd_torch.size(), "params": flat.tolist(),
        "sync_diff": float(np.abs(gathered[0] - gathered[1]).max()),
        "is_sgd": isinstance(opt, torch.optim.SGD),
        "module": hvd_torch.__name__, "keras": keras,
        "jax_loaded": "jax" in sys.modules}

    log_to_driver(f"battery rank {r} of {n} done")
    print("A" * 200_000)  # cut by the sender; the channel survives
    return hvd.allgather_object(out)


def _expected(inputs, rank):
    """The JAX engine's semantics in numpy, for ``rank``."""
    x0, x1 = inputs
    e = {}
    for k in ("f32", "i32"):
        a, b = x0[k], x1[k]
        e[f"{k}_sum"] = a + b
        e[f"{k}_min"] = np.minimum(a, b)
        e[f"{k}_max"] = np.maximum(a, b)
    e["f32_average"] = (x0["f32"] + x1["f32"]) / np.float32(2)
    # integer average: the sum in float64 / size, truncated to int32
    e["i32_average"] = ((x0["i32"].astype(np.float64) + x1["i32"]) / 2
                        ).astype(np.int32)
    a, b = x0["bool"], x1["bool"]
    e["bool_sum"] = e["bool_average"] = e["bool_max"] = a | b
    e["bool_min"] = a & b
    e["f64_avg"] = (x0["f64"] + x1["f64"]) / 2
    e["i16_sum"] = (x0["i16"] + x1["i16"]).astype(np.int16)
    e["ragged"] = np.concatenate([x0["ragged"], x1["ragged"]])
    e["bcast"] = x1["f32"]
    e["a2a_equal"] = np.concatenate([x0["a2a"][3 * rank:3 * rank + 3],
                                     x1["a2a"][3 * rank:3 * rank + 3]])
    # rank 0 sends [1, 5] rows, rank 1 [4, 2]
    e["a2a_splits"] = (np.concatenate([x0["a2a"][:1], x1["a2a"][:4]])
                       if rank == 0 else
                       np.concatenate([x0["a2a"][1:], x1["a2a"][4:]]))
    rows = slice(2 * rank, 2 * rank + 2)
    e["rs_sum"] = (x0["rs"] + x1["rs"])[rows]
    e["rs_avg"] = ((x0["rs"] + x1["rs"]) / np.float32(2))[rows]
    e["rs_max"] = np.maximum(x0["rs"], x1["rs"])[rows]
    e["rs_i_avg"] = ((x0["rs_i"].astype(np.float64) + x1["rs_i"]) / 2
                     ).astype(np.int32)[rows]
    e["grouped"] = [x0["f32"] + x1["f32"], x0["i32"] + x1["i32"],
                    (x0["f32"] + x1["f32"])[:2]]
    e["async_max"] = np.maximum(x0["f32"], x1["f32"])
    return e


def test_gang_collectives_logs_result_and_torch_main(capfd):
    inputs = [_battery_inputs(0), _battery_inputs(1)]
    got = HorovodRunner(np=-2).run(_battery_main, inputs=inputs)
    out = capfd.readouterr().out
    assert "battery rank 0 of 2 done" in out
    assert "battery rank 1 of 2 done" in out
    # local gangs stream worker output; the 200k line arrives cut
    assert "A" * 1000 in out and "A" * 70_000 not in out
    assert [g["rank"] for g in got] == [0, 1]
    for rank, res in enumerate(got):
        assert res["size"] == 2
        for name, want in _expected(inputs, rank).items():
            if isinstance(want, list):
                for g, w in zip(res[name], want):
                    assert g.dtype == w.dtype, name
                    np.testing.assert_array_equal(g, w, err_msg=name)
                continue
            assert res[name].dtype == want.dtype, (name, res[name].dtype)
            np.testing.assert_array_equal(res[name], want, err_msg=name)
        assert res["bobj"] == {"from": 1, "pad": "p" * 100}
        assert res["gobj"] == [("rank", 0, "x"), ("rank", 1, "xx")]
        assert res["synced"] is True and res["diverged_atol"] is True
        assert "diverged across ranks" in res["diverged"]
        tm = res["torch_main"]
        assert tm["size"] == 2 and tm["is_sgd"]
        assert tm["module"] == "sparkdl_tpu_torch.compat.horovod_torch"
        assert tm["keras"] == {
            "module": "sparkdl_tpu_torch.compat.horovod_keras",
            "frameworks": []}
        assert not tm["jax_loaded"]
        assert tm["sync_diff"] < 1e-6
        np.testing.assert_allclose(tm["params"], _torch_reference_step(),
                                   atol=1e-5)


VOCAB, SEQ, ROWS, STEPS = 256, 24, 4, 2


@pytest.fixture(scope="module")
def lora_tree():
    """A tiny fp32 JAX LoRA tree with non-zero lora_b, so both adapters
    get gradients from the first step."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, lora_rank=4)
    params = jax.jit(jax_llama.Llama(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "lora_b":
            return 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, params)


def _lora_main(tree, batch, steps):
    """One rank's data-parallel LoRA fine-tune: rank 0's weights
    (replicate), this rank's half of the batch (shard_batch), masked
    AdamW through DistributedOptimizer."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.models import llama
    from sparkdl_tpu_torch.models.from_jax import load_jax_params
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        replicate,
        shard_batch,
    )

    torch.set_num_threads(2)
    hvd.init()
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4,
                                 attention="flash")
    model = load_jax_params(llama.Llama(cfg, device="cpu"), tree)
    if hvd.rank() != 0:
        with torch.no_grad():  # only the broadcast can make them agree
            for p in model.parameters():
                p.add_(1.0)
    replicate(model)
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device="cpu")
    mine = shard_batch(batch)
    losses = [step(mine)["loss"].item() for _ in range(steps)]
    hvd.check_synchronized(model)
    return {"losses": hvd.allgather_object(losses),
            "rows": hvd.allgather_object(mine["inputs"].shape[0]),
            "params": {n: p.detach().numpy() for n, p in named}}


def jax_lora_reference(tree, batch, steps=STEPS):
    """The JAX package's single-process masked-AdamW LoRA steps on the
    whole ``batch`` from ``tree``: (losses, the flattened trained
    tree)."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, lora_rank=4,
                                     attention="flash")
    params = jax.tree.map(jnp.asarray, tree)
    mask = jax_lora.lora_mask(params)
    opt = optax.masked(optax.adamw(1e-3), mask)
    step = jax.jit(jax_train.make_train_step(
        jax_train.make_lm_loss_fn(jax_llama.Llama(cfg)), opt,
        param_mask=mask))
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, state, metrics = step(params, state,
                                      jax.tree.map(jnp.asarray, batch))
        losses.append(float(metrics["loss"]))
    return losses, flatten_jax_tree(jax.tree.map(np.asarray, params))


def test_data_parallel_lora_step_matches_the_jax_step(lora_tree):
    batch = global_batch(np.random.default_rng(2), VOCAB, ROWS, SEQ)
    ref_losses, ref = jax_lora_reference(lora_tree, batch)

    got = HorovodRunner(np=-2).run(
        _lora_main, tree=flatten_jax_tree(lora_tree), batch=batch,
        steps=STEPS)
    assert got["rows"] == [ROWS // 2, ROWS // 2]
    # equal halves, no ignored tokens: the ranks' mean loss is the global
    # batch's, and the averaged gradient its gradient
    np.testing.assert_allclose(np.mean(got["losses"], axis=0), ref_losses,
                               rtol=1e-5)
    assert len(got["params"]) == 8  # q and v, lora_a and lora_b, 2 layers
    for name, value in got["params"].items():
        # test_torch_train.py's tolerance for the adapters after its steps
        np.testing.assert_allclose(value, ref[name], atol=1e-5,
                                   err_msg=name)
        assert not np.array_equal(value, flatten_jax_tree(lora_tree)[name])


def _failing_main(pid_dir):
    import os

    from sparkdl_tpu_torch import hvd

    hvd.init()
    with open(os.path.join(pid_dir, f"{hvd.rank()}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if hvd.rank() == 1:
        raise ValueError("boom on rank 1")
    hvd.barrier()  # never met: rank 0 waits until the launcher kills it


def test_a_failing_worker_fails_the_run_and_leaves_no_process(tmp_path):
    with pytest.raises(RuntimeError) as exc:
        HorovodRunner(np=-2).run(_failing_main, pid_dir=str(tmp_path))
    text = str(exc.value)
    assert "--- rank 1 ---" in text
    assert "ValueError: boom on rank 1" in text
    assert "_failing_main" in text  # the rank's own traceback
    pids = [int(p.read_text()) for p in sorted(tmp_path.glob("*.pid"))]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _resumable_main(ckpt_dir, steps, kill_rank, kill_step):
    """A checkpointed loop that resumes from its restart context: the
    update depends on (rank, step), so a step skipped or taken twice
    changes ``w``. On the first attempt rank ``kill_rank`` SIGKILLs
    itself after step ``kill_step``'s save is committed (async write
    joined, then a barrier)."""
    import os
    import signal

    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import restart_context
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    hvd.init()
    ctx = restart_context()
    ckpt = TrainCheckpointer(ckpt_dir, async_save=True)
    w = torch.zeros(4)
    start = 0
    if ctx.resume_step is not None:
        w = ckpt.restore(ctx.resume_step, target={"w": w})["w"]
        start = ckpt.last_restored_step + 1
    saved = []
    for step in range(start, steps):
        g = hvd.allreduce(torch.full((4,), float((hvd.rank() + 1)
                                                 * (step + 1))), op=hvd.Sum)
        w -= 2.0 ** -7 * g  # exact: no rounding to hide a wrong step
        saved.append(ckpt.save(step, {"w": w}))
        ckpt.wait_until_finished()
        hvd.barrier()
        if ctx.attempt == 0 and hvd.rank() == kill_rank and step == kill_step:
            os.kill(os.getpid(), signal.SIGKILL)
    ckpt.close()
    return {"w": w.tolist(), "attempt": ctx.attempt,
            "resume_step": ctx.resume_step,
            "saved": hvd.allgather_object(saved)}


def test_a_sigkilled_rank_is_relaunched_and_resumes_from_its_checkpoint(
        monkeypatch, tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy(
        max_retries=2, backoff_base=0.1, backoff_max=0.2,
        resume_dir=str(ckpt_dir)))
    got = HorovodRunner(np=-2).run(_resumable_main, ckpt_dir=str(ckpt_dir),
                                   steps=5, kill_rank=1, kill_step=2)
    assert got["attempt"] == 1  # exactly one relaunch
    assert got["resume_step"] == 2
    # the uninterrupted run: w -= 2^-7 (1 + 2)(step + 1) for steps 0-4
    want = -2.0 ** -7 * 3 * sum(range(1, 6))
    assert got["w"] == [want] * 4
    # the resumed attempt: rank 0 wrote steps 3 and 4, rank 1 nothing
    assert got["saved"] == [[True, True], [False, False]]
    assert sorted(os.listdir(ckpt_dir)) == ["2", "3", "4"]


def _counting_main(marker_path):
    from sparkdl_tpu_torch import hvd

    hvd.init()
    if hvd.rank() == 0:
        with open(marker_path, "a") as fh:
            fh.write("x")
        raise ValueError("user bug, never worth a relaunch")
    hvd.barrier()  # never met: rank 1 waits until the launcher kills it


def test_a_user_exception_is_never_relaunched(monkeypatch, tmp_path):
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy(
        max_retries=2, backoff_base=0.1))
    marker = tmp_path / "attempts"
    with pytest.raises(supervisor.GangFailure, match="user bug") as exc:
        HorovodRunner(np=-2).run(_counting_main, marker_path=str(marker))
    assert marker.read_text() == "x"  # one attempt
    assert exc.value.kind == "worker_death"
    assert supervisor.classify_failure(exc.value)[0] == supervisor.PERMANENT
