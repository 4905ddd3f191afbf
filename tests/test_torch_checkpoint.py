"""The port's TrainCheckpointer against the JAX package's on the CPU: the
same save, retention and restore sequence, the commit scan on the same
directory layouts, the async snapshot, the torn-step fallback, and a
LoRA run resumed from a checkpoint against the uninterrupted run (bit
for bit) and the JAX train step. No process is spawned."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.utils import checkpoint as jax_ckpt
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.parallel import train as pt_train
from sparkdl_tpu_torch.utils import checkpoint as pt_ckpt
from tests.test_torch_train import _batch, _jax_run, tree  # noqa: F401

torch.set_num_threads(2)


def _states(n):
    rng = np.random.default_rng(7)
    return [{"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal((4,)).astype(np.float32)},
             "count": np.asarray(10 * i, np.int32)} for i in range(n)]


def _to_torch(state):
    if isinstance(state, dict):
        return {k: _to_torch(v) for k, v in state.items()}
    return torch.from_numpy(np.array(state))


def test_save_retention_restore_sequence_matches_jax(tmp_path):
    states = _states(5)
    jc = jax_ckpt.TrainCheckpointer(str(tmp_path / "jax"), max_to_keep=2)
    pc = pt_ckpt.TrainCheckpointer(str(tmp_path / "port"), max_to_keep=2)
    try:
        for step in (0, 1, 3, 4):
            assert jc.save(step, states[step]) is True
            assert pc.save(step, _to_torch(states[step])) is True
            assert pc.latest_step() == jc.latest_step() == step
            assert (pt_ckpt._committed_steps(str(tmp_path / "port"))
                    == jax_ckpt._committed_steps(str(tmp_path / "jax")))
        # a step at or before the latest committed one is not written
        assert pc.save(2, _to_torch(states[2])) is jc.save(2, states[2])
        assert pt_ckpt._committed_steps(str(tmp_path / "port")) == [3, 4]
        for step in (None, 3):
            ref = jc.restore(step)
            got = pc.restore(step)
            assert pc.last_restored_step == jc.last_restored_step
            for k in ("w", "b"):
                np.testing.assert_array_equal(got["params"][k].numpy(),
                                              np.asarray(ref["params"][k]))
            assert int(got["count"]) == int(ref["count"])
    finally:
        jc.close()
        pc.close()


def test_async_snapshot_survives_an_update_in_place(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    state = {"params": {"w": w.clone()}, "step": torch.tensor(1)}
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path), async_save=True)
    assert ckpt.save(1, state)
    state["params"]["w"].mul_(100.0)  # the loop moves on at once
    state["step"].add_(1)
    ckpt.wait_until_finished()
    restored = ckpt.restore()
    assert torch.equal(restored["params"]["w"], w)
    assert int(restored["step"]) == 1
    assert ckpt.last_save["bytes"] == os.path.getsize(
        tmp_path / "1" / pt_ckpt.STATE_FILE)
    assert ckpt.last_save["snapshot_s"] >= 0 and ckpt.last_save["write_s"] > 0


def test_async_save_then_close_commits_without_a_temp_dir(tmp_path):
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path), async_save=True)
    assert ckpt.save(5, {"w": torch.arange(4.0)})
    ckpt.close()  # no wait_until_finished() between
    assert pt_ckpt.latest_complete_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["5"]


def test_restore_of_an_empty_root_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        pt_ckpt.TrainCheckpointer(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("layout", [
    [],
    ["0", "12", "20.orbax-checkpoint-tmp-9", "notes.txt"],
    ["3", "7", "9.tmp-123"],
    ["4", "5.corrupt-77", "6.tmp-1"],
    ["8.tmp-2", "x1", "1x"],
    ["2", "10", "9"],
], ids=["empty", "orbax_tmp_and_file", "port_tmp", "quarantined",
        "no_step", "numeric_order"])
def test_commit_scan_agrees_with_jax(tmp_path, layout):
    for name in layout:
        if name.endswith(".txt"):
            (tmp_path / name).write_text("x")
        else:
            (tmp_path / name).mkdir()
    (tmp_path / "13").write_text("a file, not a step")
    assert (pt_ckpt.latest_complete_step(str(tmp_path))
            == jax_ckpt.latest_complete_step(str(tmp_path)))
    assert (pt_ckpt._committed_steps(str(tmp_path))
            == jax_ckpt._committed_steps(str(tmp_path)))
    missing = str(tmp_path / "missing")
    assert pt_ckpt.latest_complete_step(missing) is None
    assert jax_ckpt.latest_complete_step(missing) is None


def test_torn_newest_step_falls_back_and_is_quarantined(tmp_path):
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path))
    for step in (1, 2, 3):
        ckpt.save(step, {"w": torch.full((3,), float(step))})
    for step in (2, 3):  # a write torn after its commit rename
        path = tmp_path / str(step) / pt_ckpt.STATE_FILE
        path.write_bytes(path.read_bytes()[:40])
    with pytest.raises(Exception):
        ckpt.restore(fallback=False)
    assert pt_ckpt.latest_complete_step(str(tmp_path)) == 3  # untouched
    restored = ckpt.restore()
    assert torch.equal(restored["w"], torch.full((3,), 1.0))
    assert ckpt.last_restored_step == 1
    pid = os.getpid()
    assert sorted(os.listdir(tmp_path)) == [
        "1", f"2.corrupt-{pid}", f"3.corrupt-{pid}"]
    assert pt_ckpt.latest_complete_step(str(tmp_path)) == 1


def test_target_sets_dtype_and_device_and_checks_shape(tmp_path):
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path))
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "opt": {"step": torch.tensor(3.0), "lr": 0.5}}
    ckpt.save(0, state)
    plain = ckpt.restore()
    assert plain["a"].dtype == torch.float32
    assert plain["a"].device.type == "cpu"
    assert plain["opt"]["lr"] == 0.5
    got = ckpt.restore(target={"a": torch.zeros(2, 3, dtype=torch.bfloat16,
                                                device="meta"),
                               "opt": None})
    assert got["a"].dtype == torch.bfloat16 and got["a"].device.type == "meta"
    assert torch.equal(got["opt"]["step"], torch.tensor(3.0))
    with pytest.raises(ValueError, match="target shape"):
        ckpt.restore(target={"a": torch.zeros(3, 2), "opt": None})
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(target={"a": torch.zeros(2, 3)})
    # a mismatch is the caller's error: the step is not quarantined
    assert pt_ckpt.latest_complete_step(str(tmp_path)) == 0


def test_target_mesh_raises_and_forced_resave_of_a_committed_step(tmp_path):
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path))
    ckpt.save(0, {"w": torch.ones(2)})
    # a resharded restore takes the port's Mesh, nothing else
    with pytest.raises(TypeError, match="target_mesh"):
        ckpt.restore(target_mesh=object())
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(0, {"w": torch.ones(2)}, force=True)


def _lora_setup(tree):  # noqa: F811
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, lora_rank=4,
                                    attention="flash")
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu"), tree)
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-3,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = pt_train.make_train_step(pt_train.make_lm_loss_fn(model), opt,
                                    param_mask=mask, device="cpu")
    return named, opt, step


def test_resumed_lora_run_equals_the_uninterrupted_one(  # noqa: F811
        tree, tmp_path):
    """3 masked-AdamW steps, saved after step 1 and resumed for steps 2-3
    by a fresh model and optimizer, against 3 uninterrupted steps: bit for
    bit; against the JAX train step within test_torch_train.py's
    tolerance (losses 1e-5 relative, adapters 1e-5)."""
    batch = _batch()
    named, _, step = _lora_setup(tree)
    ref_losses = [step(batch)["loss"].item() for _ in range(3)]
    ref = {n: p.detach().clone() for n, p in named}

    named, opt, step = _lora_setup(tree)
    losses = [step(batch)["loss"].item()]
    ckpt = pt_ckpt.TrainCheckpointer(str(tmp_path), async_save=True)
    assert ckpt.save(0, {"adapters": dict(named), "opt": opt.state_dict()})
    ckpt.close()

    named, opt, step = _lora_setup(tree)  # a relaunched worker
    state = ckpt.restore(target={"adapters": dict(named), "opt": None})
    assert ckpt.last_restored_step == 0
    with torch.no_grad():
        for n, p in named:
            p.copy_(state["adapters"][n])
    opt.load_state_dict(state["opt"])
    moments = opt.state[named[0][1]]
    assert moments["exp_avg"].dtype == torch.float32
    assert float(moments["step"]) == 1.0
    losses += [step(batch)["loss"].item() for _ in range(2)]

    assert losses == ref_losses
    for n, p in named:
        assert torch.equal(p.detach(), ref[n]), n
    jax_losses, jax_params = _jax_run(tree, jnp.float32, 1)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jax_params[n],
                                   atol=1e-5, err_msg=n)
