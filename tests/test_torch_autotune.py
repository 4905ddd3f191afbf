"""The port's autotuner against the JAX package's, on the CPU.

The scenarios of ``tests/perf/test_autotune.py`` — its stub runner with
deterministic fake ledger samples, no subprocess — run through both
autotuners, the knob names mapped through the port's registry (a JAX
knob with no port setting is a stub knob with the same fields on both
sides): the same plan (the runner's calls), trials, adopted overrides,
pruned list and profile status. Then the port's own: the ledger
read-back by bench tag, the trial timeout as a failed trial, the refused
bench, the gbdt search over the stub and one real gbdt trial, the CLI's
dry run, and one real search over the ``serve`` harness on the CPU at
the tiny config (subprocess trials)."""

import json
import os

import pytest
import torch

from sparkdl_tpu.perf import autotune as jax_at
from sparkdl_tpu.perf import profile as jax_prof
from sparkdl_tpu.utils import knobs as jax_knobs
from sparkdl_tpu_torch.perf import autotune as at
from sparkdl_tpu_torch.perf import profile as prof
from sparkdl_tpu_torch.utils import knobs

torch.set_num_threads(2)

PRIMARY = "tok_s"


def _m(samples):
    xs = sorted(samples)
    return {PRIMARY: {"value": xs[len(xs) // 2], "samples": list(samples),
                      "unit": "tok/s", "higher_is_better": True}}


class _Side:
    """One autotuner's modules and how its knobs are named."""

    def __init__(self, name):
        self.name = name
        self.at = jax_at if name == "jax" else at
        self.prof = jax_prof if name == "jax" else prof
        self.reg = jax_knobs if name == "jax" else knobs

    def knob(self, env, values=("1", "2"), component=None, default="1"):
        """A registered knob (its port setting on the port side), or a
        stub with these fields on both sides."""
        if self.name == "jax":
            kb = jax_knobs.get(env)
        else:
            kb = knobs.by_env(env)
        if kb is not None:
            return kb
        return self.reg.Knob(
            name=env, type="int", default=default, subsystem="test",
            tunable=True, trial_values=tuple(values),
            benches=("cpu-proxy",), component=component)

    def values(self, kb, values):
        if self.name == "port" and knobs.get(kb.name) is not None:
            return [knobs.parse_value(kb, v) for v in values]
        return list(values)

    def env(self, name):
        """The JAX name of a knob of this side."""
        if self.name == "port" and knobs.get(name) is not None:
            return knobs.get(name).env
        return name


SIDES = [_Side("jax"), _Side("port")]


def _norm(side, overrides):
    return {side.env(k): str(v) for k, v in (overrides or {}).items()}


class StubRunner:
    """The JAX tests' deterministic runner; ``table`` in JAX knob names
    and value spellings, the calls recorded normalized."""

    bench = "cpu-proxy"
    device_kind = "cpu"

    def __init__(self, side, table, default, attribution=None):
        self.side = side
        self.table = {frozenset(k.items()): v for k, v in table}
        self.default = default
        self._attribution = attribution
        self.primary_metric = PRIMARY
        self.calls = []

    def attribution(self):
        return self._attribution

    def run(self, overrides):
        key = _norm(self.side, overrides)
        self.calls.append(key)
        return _m(self.table.get(frozenset(key.items()), self.default))


def _summary(side, runner, result, doc=None):
    out = {
        "calls": runner.calls,
        "trials": [(_norm(side, t.overrides), t.decision,
                    None if t.delta is None else round(t.delta, 9),
                    None if t.threshold is None else round(t.threshold, 9),
                    t.error) for t in result.trials],
        "best": _norm(side, result.best_overrides),
        "pruned": [(side.env(n), r) for n, r in result.pruned],
        "space_size": result.space_size,
    }
    if doc is not None:
        out["status"] = doc["status"]
        out["knobs"] = _norm(side, doc["knobs"])
        out["candidate"] = _norm(side, doc.get("candidate_knobs"))
        ver = doc["evidence"].get("verification")
        out["verification"] = (ver if isinstance(ver, str)
                               else ver["primary"]["status"])
    return out


def _both(scenario):
    got = [scenario(side) for side in SIDES]
    assert got[0] == got[1]
    return got[1]


def _quiet(*_a, **_k):
    return None


# -- the JAX scenarios, through both ------------------------------------------


def test_compute_bound_attribution_prunes_data_knobs():
    def run(side):
        prefetch = side.knob("SPARKDL_TPU_PREFETCH_DEPTH", ("2", "4", "8"),
                             component="data_wait", default="2")
        chunk = side.knob("SPARKDL_TPU_LOSS_CHUNK")
        space = [(prefetch, side.values(prefetch, ["2", "4", "8"])),
                 (chunk, side.values(chunk, ["256", "1024"]))]
        report = {"source": "test",
                  "fractions": {"compute": 0.85, "data_wait": 0.01}}
        kept, pruned = side.at.prune_space(space, report)
        return ([side.env(kb.name) for kb, _ in kept],
                [(side.env(n), r) for n, r in pruned])

    kept, pruned = _both(run)
    assert kept == ["SPARKDL_TPU_LOSS_CHUNK"]
    assert pruned[0][0] == "SPARKDL_TPU_PREFETCH_DEPTH"


@pytest.mark.parametrize("report", [
    {"source": "t", "fractions": {"compute": 0.9}},
    None,
    {"source": "t", "fractions": {"compute": 0.5, "data_wait": 0.2}},
], ids=["no-data-wait-row", "no-attribution", "data-bound"])
def test_prune_rules(report):
    def run(side):
        prefetch = side.knob("SPARKDL_TPU_PREFETCH_DEPTH", ("4",),
                             component="data_wait", default="2")
        kept, pruned = side.at.prune_space([(prefetch, ["4"])], report)
        return len(kept), [(side.env(n), r) for n, r in pruned]

    _both(run)


def test_queue_wait_fraction_prunes_max_queue():
    def run(side):
        mq = side.knob("SPARKDL_TPU_SERVE_MAX_QUEUE")
        report = {"source": "serve",
                  "fractions": {"queue_wait": 0.001}}
        kept, pruned = side.at.prune_space(
            [(mq, side.values(mq, ["16", "64"]))], report)
        return len(kept), [(side.env(n), r) for n, r in pruned]

    n_kept, pruned = _both(run)
    assert n_kept == 0
    assert pruned[0][0] == "SPARKDL_TPU_SERVE_MAX_QUEUE"


def test_pruned_knobs_never_reach_the_runner():
    def run(side):
        prefetch = side.knob("SPARKDL_TPU_PREFETCH_DEPTH", ("4", "8"),
                             component="data_wait", default="2")
        chunk = side.knob("SPARKDL_TPU_LOSS_CHUNK")
        runner = StubRunner(
            side,
            [({"SPARKDL_TPU_LOSS_CHUNK": "1024"}, [1100, 1105, 1110, 1102])],
            default=[1000, 1001, 1002, 1003],
            attribution={"source": "t",
                         "fractions": {"compute": 0.95, "data_wait": 0.0}})
        result = side.at.autotune(
            runner, [(prefetch, ["4", "8"]),
                     (chunk, side.values(chunk, ["1024"]))], log=_quiet)
        return _summary(side, runner, result)

    got = _both(run)
    assert got["best"] == {"SPARKDL_TPU_LOSS_CHUNK": "1024"}
    assert got["pruned"][0][0] == "SPARKDL_TPU_PREFETCH_DEPTH"


@pytest.mark.parametrize("table,default,decision", [
    # median +1 %, relative IQR ~20 %: inside the noise band
    ([700, 900, 1010, 1100, 1300], [980, 1000, 1000, 1010, 1020], "ok"),
    ([1200, 1205, 1210, 1203, 1207], [1000, 1001, 1002, 1003, 1004],
     "improved"),
], ids=["noisy-flat", "quiet-improvement"])
def test_judging_by_the_compare_gate(table, default, decision):
    def run(side):
        kb = side.knob("SPARKDL_TPU_STUB")
        runner = StubRunner(side, [({kb.name: "2"}, table)], default)
        result = side.at.autotune(runner, [(kb, ["2"])], log=_quiet)
        return _summary(side, runner, result)

    got = _both(run)
    assert got["trials"][0][1] == decision


def test_greedy_search_composes_overrides_and_bounds_trials():
    def run(side):
        k1 = side.knob("SPARKDL_TPU_STUB_A")
        k2 = side.knob("SPARKDL_TPU_STUB_B")
        runner = StubRunner(
            side,
            [({"SPARKDL_TPU_STUB_A": "2"}, [1200, 1201, 1202, 1203]),
             ({"SPARKDL_TPU_STUB_A": "2", "SPARKDL_TPU_STUB_B": "2"},
              [1500, 1501, 1502, 1503])],
            default=[1000, 1001, 1002, 1003])
        result = side.at.autotune(runner, [(k1, ["1", "2"]),
                                           (k2, ["1", "2"])], log=_quiet)
        return _summary(side, runner, result)

    got = _both(run)
    assert len(got["calls"]) == 3 <= got["space_size"]
    assert got["best"] == {"SPARKDL_TPU_STUB_A": "2",
                           "SPARKDL_TPU_STUB_B": "2"}


def test_max_trials_refuses_loudly_instead_of_truncating():
    def run(side):
        kb = side.knob("SPARKDL_TPU_STUB", ("1", "2", "3", "4"))
        runner = StubRunner(side, [], default=[1000, 1001, 1002, 1003])
        with pytest.raises(SystemExit, match="max-trials"):
            side.at.autotune(runner, [(kb, ["2", "3", "4"])], max_trials=2,
                             log=_quiet)
        return runner.calls

    assert _both(run) == []


def test_failed_trial_is_recorded_not_fatal():
    def run(side):
        kb = side.knob("SPARKDL_TPU_STUB")

        class Failing(StubRunner):
            def run(self, overrides):
                if overrides:
                    self.calls.append(_norm(self.side, overrides))
                    raise side.at.TrialError("bench crashed")
                return super().run(overrides)

        runner = Failing(side, [], default=[1000, 1001, 1002, 1003])
        result = side.at.autotune(runner, [(kb, ["2"])], log=_quiet)
        return _summary(side, runner, result)

    got = _both(run)
    assert got["best"] == {} and got["trials"][0][1] == "failed"
    assert "crashed" in got["trials"][0][4]


def test_verification_regression_degrades_to_defaults():
    def run(side):
        kb = side.knob("SPARKDL_TPU_STUB")

        class Flaky(StubRunner):
            def run(self, overrides):
                n = len(self.calls)
                out = super().run(overrides)
                if overrides and n >= 2:
                    out[PRIMARY] = {**out[PRIMARY], "value": 800.0,
                                    "samples": [798, 799, 800, 801]}
                return out

        runner = Flaky(side, [({kb.name: "2"}, [1200, 1201, 1202, 1203])],
                       default=[1000, 1001, 1002, 1003])
        result = side.at.autotune(runner, [(kb, ["2"])], log=_quiet)
        doc = side.at.verify_and_emit(runner, result, log=_quiet)
        return _summary(side, runner, result, doc)

    got = _both(run)
    assert got["status"] == "degraded" and got["knobs"] == {}
    assert got["candidate"] == {"SPARKDL_TPU_STUB": "2"}
    assert got["verification"] == "regression"


@pytest.mark.parametrize("protected,status", [(True, "degraded"),
                                              (False, "verified")])
def test_secondary_regression_protection_rules(protected, status):
    def run(side):
        kb = side.knob("SPARKDL_TPU_LOSS_CHUNK")

        class R(StubRunner):
            def run(self, overrides):
                out = super().run(overrides)
                if overrides:   # the winner: the secondary drops 10 %
                    out["secondary"] = (
                        {"value": 90.0, "samples": [89.0, 90.0, 90.0, 91.0],
                         "higher_is_better": True} if protected else
                        {"value": 90.0, "higher_is_better": True})
                else:
                    out["secondary"] = (
                        {"value": 100.0,
                         "samples": [99.0, 100.0, 100.0, 101.0],
                         "higher_is_better": True} if protected else
                        {"value": 100.0, "higher_is_better": True})
                return out

        runner = R(side,
                   [({"SPARKDL_TPU_LOSS_CHUNK": "1024"},
                     [1200, 1201, 1202, 1203])],
                   default=[1000, 1001, 1002, 1003])
        result = side.at.autotune(
            runner, [(kb, side.values(kb, ["1024"]))], log=_quiet)
        doc = side.at.verify_and_emit(runner, result, log=_quiet)
        return _summary(side, runner, result, doc)

    assert _both(run)["status"] == status


def test_verification_pass_emits_verified_profile():
    def run(side):
        kb = side.knob("SPARKDL_TPU_LOSS_CHUNK")
        runner = StubRunner(
            side, [({"SPARKDL_TPU_LOSS_CHUNK": "1024"},
                    [1200, 1201, 1202, 1203])],
            default=[1000, 1001, 1002, 1003])
        result = side.at.autotune(
            runner, [(kb, side.values(kb, ["1024"]))], log=_quiet)
        doc = side.at.verify_and_emit(runner, result, log=_quiet)
        assert doc["schema"] == "sparkdl_tpu.perf.profile/1"
        assert doc["device_kind"] == "cpu"
        return _summary(side, runner, result, doc)

    got = _both(run)
    assert got["status"] == "verified"
    assert got["knobs"] == {"SPARKDL_TPU_LOSS_CHUNK": "1024"}


def test_empty_winner_skips_verification_runs():
    def run(side):
        kb = side.knob("SPARKDL_TPU_STUB")
        runner = StubRunner(side, [], default=[1000, 1001, 1002, 1003])
        result = side.at.autotune(runner, [(kb, ["2"])], log=_quiet)
        doc = side.at.verify_and_emit(runner, result, log=_quiet)
        return _summary(side, runner, result, doc)

    got = _both(run)
    assert len(got["calls"]) == 2 and got["status"] == "verified"
    assert got["knobs"] == {}


def test_derive_space_through_the_registry():
    def names(side, space):
        return sorted(side.env(kb.name) for kb, _ in space)

    def run(side):
        plain = names(side, side.at.derive_space("gbdt"))
        bins = "SPARKDL_TPU_GBDT_MAX_BINS"
        if side.name == "port":
            bins = knobs.by_env(bins).name
        narrowed = side.at.derive_space(
            "gbdt", knob_names=[bins],
            value_overrides={bins: ["64", "256"]})
        with pytest.raises(SystemExit, match="not a registered tunable"):
            side.at.derive_space("gbdt", knob_names=["SPARKDL_TPU_RANK"])
        with pytest.raises(SystemExit, match="match no knob"):
            side.at.derive_space(
                "gbdt", value_overrides={"SPARKDL_TPU_GBDT_MAX_BINZ": ["64"]})
        return plain, [(side.env(kb.name), [str(v) for v in vals])
                       for kb, vals in narrowed]

    plain, narrowed = _both(run)
    assert plain == ["SPARKDL_TPU_GBDT_MAX_BINS"]
    assert narrowed == [("SPARKDL_TPU_GBDT_MAX_BINS", ["64", "256"])]
    # the port's space for serve: its five settings, their typed values
    space = dict((kb.name, v) for kb, v in at.derive_space("serve"))
    assert space["sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK"] == \
        [4, 8, 16]


# -- the port's runners --------------------------------------------------------


def test_trial_ledger_readback_filters_by_bench_tag(tmp_path):
    """Only a NEW ledger line with this harness's bench tag is the
    trial's; a concurrent writer's line never is."""
    from sparkdl_tpu_torch.observe import perf as operf

    history = str(tmp_path / "history.jsonl")

    class Foreign(at.ServeRunner):
        def _bounded_run(self, args, env):
            assert "--settings" in args and "--history" in args
            operf.append_history(operf.history_record(
                {"other": 1.0}, bench="trial:train"), history)
            return 0, "", ""

    with pytest.raises(at.TrialError, match="bench='trial:serve'"):
        Foreign(history_path=history).run({})

    class Good(Foreign):
        def _bounded_run(self, args, env):
            settings = json.loads(args[args.index("--settings") + 1])
            assert settings == {"x": 8}  # the overrides, not the env
            operf.append_history(operf.history_record(
                {"serve_tokens_per_sec": 10.0}, bench="trial:serve",
                device_kind="NVIDIA H100 80GB HBM3"), history)
            operf.append_history(operf.history_record(
                {"other": 1.0}, bench="trial:train"), history)
            return 0, "", ""

    good = Good(history_path=history)
    metrics = good.run({"x": 8})
    assert metrics["serve_tokens_per_sec"]["value"] == 10.0
    assert good.device_kind == "NVIDIA H100 80GB HBM3"
    assert prof.strict_device_kind(good.device_kind) == "h100"


def test_trial_timeout_is_a_failed_trial_not_a_crash(tmp_path):
    runner = at.TrainRunner(history_path=str(tmp_path / "h.jsonl"),
                            timeout=0.3)
    runner.command = lambda overrides: [
        "python", "-c", "import time; time.sleep(30)"]
    with pytest.raises(at.TrialError, match="timed out"):
        runner.run({})


def test_runners_and_refused_benches():
    assert sorted(at.RUNNERS) == ["gbdt", "serve", "train"]
    gbdt = at.make_runner("gbdt", history_path=os.devnull)
    assert (gbdt.ledger_bench, gbdt.primary_metric) == (
        "gbdt_bench", "gbdt_fit_rows_per_sec")
    assert gbdt.command({})[3] == "gbdt"
    assert "gbdt" not in at.REFUSED_BENCHES
    with pytest.raises(NotImplementedError, match="FLASH_BLOCK_Q"):
        at.make_runner("attention")
    # the train trial declares a compute-bound single process: the
    # collective-gated overlap setting is pruned
    rep = at.TrainRunner(history_path=os.devnull).attribution()
    overlap = knobs.get("sparkdl_tpu_torch.parallel.ring_attention.OVERLAP")
    kept, pruned = at.prune_space([(overlap, [False])], rep)
    assert not kept and pruned


def test_gbdt_search_through_both_autotuners():
    """The gbdt bench's one tunable setting (the trial's bin count,
    ``SPARKDL_TPU_GBDT_MAX_BINS``) searched over the stub on both sides:
    the same plan, trials, winner and profile."""
    def run(side):
        runner = StubRunner(
            side, [({"SPARKDL_TPU_GBDT_MAX_BINS": "64"},
                    [1300, 1301, 1302, 1303])],
            default=[1000, 1001, 1002, 1003])
        runner.bench = "gbdt"
        space = side.at.derive_space("gbdt")
        result = side.at.autotune(runner, space, log=_quiet)
        doc = side.at.verify_and_emit(runner, result, log=_quiet)
        return _summary(side, runner, result, doc)

    got = _both(run)
    assert [c for c in got["calls"][:3]] == [
        {}, {"SPARKDL_TPU_GBDT_MAX_BINS": "64"},
        {"SPARKDL_TPU_GBDT_MAX_BINS": "128"}]
    assert got["best"] == {"SPARKDL_TPU_GBDT_MAX_BINS": "64"}
    assert got["status"] == "verified"


def test_gbdt_trial_on_the_cpu(tmp_path):
    """One real gbdt trial subprocess at the JAX bench's tiny shape: its
    ledger line, read back by the runner, under the gbdt_bench tag."""
    from sparkdl_tpu_torch.observe import perf as operf

    history = str(tmp_path / "history.jsonl")
    bins = "sparkdl_tpu_torch.perf.trial.GBDT_MAX_BINS"
    runner = at.GbdtRunner(history_path=history, timeout=300,
                           extra_args=["--device=cpu", "--config=tiny"])
    metrics = runner.run({bins: 64})
    for name in ("gbdt_fit_rows_per_sec", "gbdt_predict_rows_per_sec"):
        assert len(metrics[name]["samples"]) == 4 and \
            metrics[name]["value"] > 0, name
    (line,) = operf.read_history(history)
    assert line["bench"] == "gbdt_bench" and runner.device_kind == "cpu"
    assert (line["rows"], line["features"], line["trees"],
            line["max_depth"], line["max_bins"]) == (2000, 8, 3, 3, 64)
    assert line["settings"] == {bins: 64} and line["train_accuracy"] > 0.6


def test_cli_dry_run_prints_the_plan(capsys):
    chunk = "sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK"
    assert at.main(["--bench", "serve", "--knob", chunk,
                    "--values", f"{chunk}=8", "--dry-run"]) == 0
    plan = json.loads(capsys.readouterr().out)
    assert plan == {"bench": "serve", "knobs": {chunk: [8]}, "pruned": [],
                    "trials": 2}
    assert at.main(["--bench", "serve", "--knob", chunk, "--dry-run"]) == 0
    assert json.loads(capsys.readouterr().out)["knobs"] == {chunk: [4, 8]}


def test_serve_search_end_to_end_on_the_cpu(tmp_path, capsys):
    """The CLI over the real ``serve`` harness (tiny config, CPU): every
    trial appended its line to the history it was given, the profile
    lands under the card kind's key, and its status is decided."""
    chunk = "sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK"
    history = tmp_path / "history.jsonl"
    rc = at.main(["--bench", "serve", "--knob", chunk,
                  "--values", f"{chunk}=4", "--max-trials", "4",
                  "--profile-dir", str(tmp_path / "profiles"),
                  "--history", str(history), "--trial-timeout", "300",
                  "--bench-arg=--device=cpu", "--bench-arg=--config=tiny"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["profile"] == str(tmp_path / "profiles" / "cpu" /
                                 "serve.json")
    doc = prof.load_profile(out["profile"])
    assert doc["status"] in ("verified", "degraded")
    lines = [json.loads(x) for x in history.read_text().splitlines()]
    assert len(lines) in (2, 4)
    assert all(x["bench"] == "trial:serve" for x in lines)
    assert lines[1]["settings"] == {chunk: 4}
    for x in lines:
        samples = x["metrics"]["serve_tokens_per_sec"]["samples"]
        assert len(samples) == 4  # the gate's sample protection is live
        assert x["tokens"] == 4 * 4 * 16
