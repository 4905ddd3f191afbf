"""The port's own multi-rank program (``sparkdl_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py`` canaries, and the CLI
that lints it (``python -m sparkdl_tpu_torch.analysis --graft N``).

``--graft 8`` is traced in this process as every rank of its ``data 2 x
seq 2 x model 2`` mesh (no spawn, no card memory). The collectives the
JAX HLO canaries assert on (``tests/test_graft_entry.py``) are held
against the trace by kind, and by axis (the ring's hops ride ``seq``,
the pipeline's ``model``); the full-param-allgather rule finds no TP
weight gathered whole; the step is a sharding fixed point (every
trained weight updated in place at its local shape). One gang of two
CPU workers runs ``dryrun_multichip(2)``."""

import collections
import json

import pytest
import torch

from sparkdl_tpu_torch.analysis import Severity, _context_for, run_passes
from sparkdl_tpu_torch.analysis.__main__ import main
from sparkdl_tpu_torch.graft_entry import (
    build_multichip_step,
    dryrun_multichip,
    entry,
    mesh_spec,
)
from sparkdl_tpu_torch.horovod import launcher

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graft8():
    step, params, opt, batch, mesh, shardings = build_multichip_step(
        8, device="cpu", dtype=torch.bfloat16, attention="flash")
    # JAX's blunt size bound is its config's smallest full TP kernel
    # (64 x 64 q/k/v); this config's is 128 x 128 (the head dims of 64)
    ctx = _context_for(step, (batch,), params=params, shardings=shardings,
                       mesh=mesh, name="graft8",
                       options={"allgather_max_elements": 128 * 128})
    return ctx, params, shardings, mesh


def test_entry_forward_shapes():
    fn, (params, tokens) = entry(device="meta")
    out = fn(params, tokens)
    assert out.shape == (tokens.shape[0], tokens.shape[1], 32000)


def test_the_mesh_is_carved_as_the_jax_program():
    assert [mesh_spec(n).axis_sizes() for n in (1, 2, 4, 8)] == [
        (1, 1, 1, 1), (1, 1, 1, 2), (1, 1, 2, 2), (2, 1, 2, 2)]


def test_multichip_trace_has_the_right_collectives(graft8):
    """Every rank issues each parallel form's signature collective: the
    ring's hops on ``seq`` and the pipeline's on ``model``
    (collective-permute), the data-parallel gradient average on ``data``
    and the TP / MoE sums (all-reduce); JAX's bounds on the HLO (permute
    >= 4, all-reduce >= 5, all-gather <= 36) hold, and the ranks agree."""
    ctx, _, _, _ = graft8
    assert sorted(ctx.traces) == list(range(8))
    sigs = {t.signature() for t in ctx.traces.values()}
    assert len(sigs) == 1
    for trace in ctx.traces.values():
        assert trace.complete
        by_kind = collections.Counter(c.kind for c in trace.collectives)
        by_axis = collections.Counter((c.kind, c.axis)
                                      for c in trace.collectives)
        assert by_kind["collective-permute"] >= 4, by_kind
        assert by_kind["all-reduce"] >= 5, by_kind
        assert by_kind["all-gather"] <= 3 * 12, by_kind
        for form in (("collective-permute", "seq"),
                     ("collective-permute", "model"),
                     ("all-reduce", "data"), ("all-reduce", "model"),
                     ("all-reduce", "seq"), ("all-gather", "model")):
            assert by_axis[form] >= 1, (form, by_axis)
        # the ring's blocks are the flash kernels' (traced, not launched)
        assert {k for k in trace.kernel_counts()} == {"B1", "B2", "B3"}


def test_multichip_trace_never_allgathers_a_full_tp_param(graft8):
    """No all-gather makes a tensor-parallel weight whole, and none
    passes the size bound either (the smallest full TP kernel, as JAX
    sets it for its config)."""
    ctx, _, _, _ = graft8
    findings = run_passes(ctx, passes=["full-param-allgather"])
    assert not findings, "\n".join(map(str, findings))
    assert not [f for f in run_passes(ctx) if f.severity >= Severity.ERROR
                or f.severity == Severity.WARNING]


def test_multichip_updated_params_keep_their_shardings(graft8):
    """The step is a sharding fixed point: every trained weight (the
    adapters, the stage, the experts and the router) is updated in place
    at its local shape, so the next step takes the same layout."""
    ctx, params, shardings, mesh = graft8
    trained = {n: tuple(p.shape) for n, p in params.named_parameters()
               if p.requires_grad}
    assert trained and "pipe_w" in trained and "moe.w_gate" in trained
    assert any(n.endswith("lora_b") for n in trained)
    for trace in ctx.traces.values():
        written = {i.path: tuple(i.shape) for i in trace.inputs if i.written}
        for name, shape in trained.items():
            assert written.get(name) == shape, (name, written.get(name))
    # the experts and the stage are this rank's shards of the whole
    assert trained["moe.w_gate"][0] == 4 // mesh.axis_size("seq")
    assert trained["pipe_w"][0] == 1 and shardings["pipe_w"][0] == "model"


def test_cli_graft_comms_fix_json(tmp_path, capsys):
    """``--graft 8 --comms --fix --dry-run``: exit 0 on the stock program,
    the comms and fixit reports written as JSON, and the same documents
    in ``--format json``."""
    comms_out, fixit_out = tmp_path / "comms.json", tmp_path / "fixit.json"
    rc = main(["--graft", "8", "--comms", "--comms-out", str(comms_out),
               "--fix", "--dry-run", "--fixit-out", str(fixit_out),
               "--format", "json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"findings", "comms_reports", "fixit_report"}
    assert not [f for f in doc["findings"] if f["severity"] == "ERROR"]
    (comms,) = json.loads(comms_out.read_text())["reports"]
    assert comms["schema"] == "sparkdl_tpu.analysis.comms_report/1"
    assert comms["assumptions"]["n_devices"] == 8
    assert comms["totals"]["by_kind"]["collective-permute"]["count"] >= 4
    (fixit,) = json.loads(fixit_out.read_text())["reports"]
    assert fixit == doc["fixit_report"]
    assert fixit["schema"] == "sparkdl_tpu.analysis.fixit_report/1"
    assert fixit["mode"] == "dry-run"
    assert fixit["name"] == "build_multichip_step(8)"
    # the in-place AdamW step has nothing to fix
    assert fixit["summary"]["proposed"] == 0


def _f64_program(n_devices, **kwargs):
    """A stand-in program with a fixable ERROR: a float64 argument."""
    from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh

    def step(batch):
        return {"loss": (batch["x"] * 2.0).sum()}

    return (step, None, None, {"x": torch.ones(4, 4, dtype=torch.float64)},
            Mesh(AXES, (1, 1, 1, 1)), {})


def test_cli_exit_follows_the_findings_after_the_fix(monkeypatch, capsys):
    """The exit status keys off the findings left after the fixes: a
    float64 argument is an ERROR (1) the narrowing fix removes (0), in a
    dry run too; the text mode renders the fixit table."""
    from sparkdl_tpu_torch import graft_entry

    monkeypatch.setattr(graft_entry, "build_multichip_step", _f64_program)
    assert main(["--graft", "1"]) == 1
    assert "silent-canonicalization" in capsys.readouterr().out
    for extra in ([], ["--dry-run"]):
        assert main(["--graft", "1", "--fix", *extra]) == 0
        out = capsys.readouterr().out
        assert "narrow-64bit-payload" in out and "(after --fix)" in out
        assert "[applied]" in out if not extra else "[verified]" in out


@pytest.mark.gang
def test_dryrun_multichip_two_ranks(tmp_path, monkeypatch):
    """One real step of the graft program as a gang of two CPU workers
    (``data 1 x seq 1 x model 2``: TP and the pipeline's hops over gloo):
    both ranks' losses finite and equal, the local shapes kept."""
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    ranks = dryrun_multichip(2)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert all(r["shapes_kept"] and r["device"] == "cpu" for r in ranks)


def _graft_grads_main(weightings):
    """Every rank of a ``data 1 x seq 2 x model 2`` gang: one step of the
    graft program a weighting of its loss's terms, then the whole
    gradients and updated weights of every trained leaf (rank 0's
    return)."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.mesh import make_mesh
    from sparkdl_tpu_torch.parallel.sharding import full_host_value

    torch.manual_seed(0)
    hvd.init()
    mesh = make_mesh(mesh_spec(4))
    out = []
    for weights in weightings:
        step, model, _, batch, _, shardings = build_multichip_step(
            4, mesh=mesh, device="cpu", term_weights=weights)
        loss = float(step(batch)["loss"])
        whole = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                spec = shardings.get(name, ())
                whole[name] = (full_host_value(p.grad, spec, mesh).numpy(),
                               full_host_value(p.detach(), spec, mesh)
                               .numpy())
        out.append({"loss": loss, "whole": whole, "batch": batch})
    return out if hvd.rank() == 0 else None


def _plain_step(weights, batch):
    """The graft program's step in one process, over the whole batch and
    the whole weights: the Llama with its own (dense, causal) attention,
    the two stages one after the other, all four experts on every token,
    the three terms' means over the global batch; then AdamW. Returns
    the loss and ``{name: (gradient, updated weight)}`` by the gang's
    names."""
    from sparkdl_tpu_torch.graft_entry import graft_config, whole_weights
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.models.moe import moe_apply, moe_gates
    from sparkdl_tpu_torch.parallel.train import cross_entropy_loss

    cfg = graft_config()
    full, stacked, moe = whole_weights(cfg, 2)
    llama = Llama.from_params(cfg, full, device="cpu")
    mask = lora_mask(llama)
    leaves = {f"llama.{n}": p for n, p in llama.named_parameters()}
    for n, p in leaves.items():
        p.requires_grad_(mask[n[len("llama."):]])
    leaves["pipe_w"] = torch.nn.Parameter(stacked)
    leaves.update({f"moe.{k}": torch.nn.Parameter(v)
                   for k, v in moe.items()})
    trained = {n: p for n, p in leaves.items() if p.requires_grad}
    inputs, targets = (torch.as_tensor(batch[k]) for k in ("inputs",
                                                            "targets"))
    logits = llama(inputs)
    ce = cross_entropy_loss(logits, targets)
    h = logits[..., :16].reshape(-1, 16)
    for s in range(2):
        h = torch.tanh(h @ leaves["pipe_w"][s])
    gates = moe_gates(h.float() @ leaves["moe.router_kernel"]
                      + leaves["moe.router_bias"], 2).to(h.dtype)
    moe_out = moe_apply(h, gates, leaves["moe.w_gate"], leaves["moe.w_up"],
                        leaves["moe.w_down"])
    w_ce, w_pipe, w_moe = weights
    loss = (w_ce * ce + w_pipe * (h ** 2).mean()
            + w_moe * (moe_out ** 2).mean())
    loss.backward()
    opt = torch.optim.AdamW(list(trained.values()), lr=1e-3)
    grads = {n: p.grad.clone() for n, p in trained.items()}
    opt.step()
    return loss.item(), {n: (grads[n].numpy(), p.detach().numpy())
                         for n, p in trained.items()}


@pytest.mark.gang
def test_multichip_step_matches_a_plain_step_over_the_global_loss(
        tmp_path, monkeypatch):
    """One step of the graft program on a ``data 1 x seq 2 x model 2``
    gang of four CPU workers (ring attention over ``seq``, the experts
    split over ``seq``, TP and the pipeline over ``model``) against the
    same step written plainly in one process over the global loss and
    the whole weights: the loss, and every trained leaf's whole gradient
    and updated weight, the expert shards included. Each term of the
    loss alone, and the three together, so that a term whose gradient
    reaches a leaf at half (or twice) its weight fails: every leaf's
    gradient is held within 1e-3 of its norm, every updated weight
    within 1 % of one step's update (AdamW's lr, 1e-3)."""
    import numpy as np

    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.graft_entry import TERM_WEIGHTS

    weightings = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
                  TERM_WEIGHTS]
    runs = HorovodRunner(np=4).run(_graft_grads_main, weightings=weightings)
    for weights, run in zip(weightings, runs):
        loss, plain = _plain_step(weights, run["batch"])
        assert run["loss"] == pytest.approx(loss, rel=1e-5), weights
        assert set(run["whole"]) == set(plain)
        for name, (grad, updated) in run["whole"].items():
            want, want_updated = plain[name]
            assert grad.shape == want.shape, name
            err = np.linalg.norm(grad - want)
            assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (
                weights, name, err, np.linalg.norm(want))
            np.testing.assert_allclose(updated, want_updated, rtol=0,
                                       atol=1e-5, err_msg=name)


def test_dryrun_multichip_one_rank_in_process():
    """``dryrun_multichip(1)`` is local mode: the step in this process,
    here on the CPU (the card's phase 33c runs it on the card)."""
    (rank,) = dryrun_multichip(1, device="cpu")
    assert rank["rank"] == 0 and rank["shapes_kept"]
    assert rank["device"] == "cpu"


class _CountingMesh:
    """A mesh of ``data`` 2 x ``seq`` 2 whose all-reduce doubles its
    input (every rank holding the same value) and records the axis."""

    def __init__(self):
        self.calls = []

    def axis_size(self, axis):
        return {"data": 2, "seq": 2}.get(axis, 1)

    def all_reduce(self, x, axis):
        self.calls.append((tuple(x.shape), axis))
        return x * 2


def test_an_expert_shard_is_not_averaged_over_its_split_axis():
    """The graft program's experts split over ``seq`` (each seq rank
    holds other experts): the step averages their gradients over
    ``data`` only, the rest over ``data`` and ``seq``, as GSPMD's exact
    gradients of the JAX step are."""
    from sparkdl_tpu_torch.parallel.train import _average_grads

    shared, expert = (torch.nn.Parameter(torch.zeros(3)),
                      torch.nn.Parameter(torch.zeros(2)))
    shared.grad, expert.grad = torch.ones(3), torch.ones(2)
    opt = torch.optim.SGD([shared, expert], lr=0.1)
    mesh = _CountingMesh()
    _average_grads(opt, mesh, frozenset(), {id(expert): ("seq",)})
    assert sorted(mesh.calls) == [((2,), "data"), ((3,), "data"),
                                  ((3,), "seq")]
    # identical ranks: the mean over the axes it is averaged over is 1
    assert shared.grad.tolist() == [1.0] * 3
    assert expert.grad.tolist() == [1.0] * 2
