"""The port's launcher pre-flight lint, on the CPU: off by default; on,
a ``main`` that captures a tensor on a device (a ``device="meta"``
tensor stands in for a CUDA one here) or a live Spark handle is refused
— with the JAX pre-flight's rule and severity for the same captures —
before the launcher reaches ``subprocess.Popen`` (a tripwire, as
``tests/analysis/test_preflight.py`` uses), and local mode is linted
too. The 64-bit payload rule has no counterpart (torch keeps a float64
leaf as it is); ``kwargs`` and ``per_rank_kwargs`` take the capture
rule. The graph passes over registered steps are
``tests/test_torch_graph_lint.py``'s."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.analysis import PREFLIGHT_ENV
from sparkdl_tpu.analysis import PreflightLintError as JaxPreflightError
from sparkdl_tpu.analysis.preflight import preflight_lint as jax_lint
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.analysis import (
    PreflightLintError,
    Severity,
    register_preflight,
)
from sparkdl_tpu_torch.analysis import preflight
from sparkdl_tpu_torch.horovod import launcher, supervisor

torch.set_num_threads(2)

JAX_ON = {PREFLIGHT_ENV: "1"}

# a module global on a device, for the nested-capture case
_META_TABLE = torch.zeros((4,), device="meta")


@pytest.fixture
def lint_on(monkeypatch):
    monkeypatch.setattr(preflight, "ENABLED", True)


def _noop_main(**kwargs):
    return 0


def _spark_like():
    cls = type("SparkContext", (), {"__module__": "pyspark.context"})
    return cls()


def _key(e):
    return [(f.rule_id, int(f.severity), f.message.split(" via ")[1][:10])
            for f in e.findings]


def test_inert_by_default():
    assert preflight.ENABLED is False
    assert preflight.preflight_lint(_noop_main, {}) is None


def test_clean_main_passes(lint_on):
    assert preflight.preflight_lint(_noop_main, {"x": np.zeros(4)}) == []


def test_captured_device_tensor_is_refused_as_jax_refuses_an_array(lint_on):
    table = torch.zeros((8,), device="meta")
    host = torch.zeros((8,))

    def main(**kwargs):
        return table.sum() + host.sum()

    with pytest.raises(PreflightLintError) as port:
        preflight.preflight_lint(main, {})
    (f,) = port.value.findings
    assert (f.op, f.severity) == ("torch.Tensor", Severity.ERROR)
    assert "meta" in f.message and "(8,)" in f.message
    jtable = jnp.zeros((8,))

    def jmain(**kwargs):
        return float(jtable.sum())

    with pytest.raises(JaxPreflightError) as jax_side:
        jax_lint(jmain, {}, environ=JAX_ON)
    assert _key(port.value) == _key(jax_side.value)


def test_capture_inside_a_nested_function(lint_on):
    def main(**kwargs):
        def helper():
            return _META_TABLE.sum()

        return helper()

    with pytest.raises(PreflightLintError) as e:
        preflight.preflight_lint(main, {})
    assert e.value.findings[0].op == "torch.Tensor"
    assert "a module global" in e.value.findings[0].message


def test_live_spark_handle_is_refused_by_both(lint_on):
    sc = _spark_like()

    def main(**kwargs):
        return sc

    with pytest.raises(PreflightLintError) as port:
        preflight.preflight_lint(main, {})
    with pytest.raises(JaxPreflightError) as jax_side:
        jax_lint(main, {}, environ=JAX_ON)
    assert [(f.rule_id, f.op, int(f.severity), f.message)
            for f in port.value.findings] == [
        (f.rule_id, f.op, int(f.severity), f.message)
        for f in jax_side.value.findings]


def test_what_has_no_counterpart(lint_on):
    # torch keeps a float64 leaf as it is: no silent canonicalization
    assert preflight.preflight_lint(
        _noop_main, {"x": np.zeros(4, np.float64)}) == []
    with pytest.raises(JaxPreflightError):
        jax_lint(_noop_main, {"x": np.zeros(4, np.float64)}, environ=JAX_ON)
    # per_rank_kwargs are linted as kwargs are (the JAX rule over both):
    # here that is the capture rule, with no 64-bit half
    assert preflight.preflight_lint(
        _noop_main, {}, per_rank_kwargs=[{"x": np.zeros(4, np.float64)}]
    ) == []
    with pytest.raises(JaxPreflightError):
        jax_lint(_noop_main, {}, per_rank_kwargs=[
            {"x": np.zeros(4, np.float64)}], environ=JAX_ON)
    with pytest.raises(PreflightLintError, match=r"per_rank_kwargs\[0\]"):
        preflight.preflight_lint(_noop_main, {}, per_rank_kwargs=[
            {"x": torch.zeros(2, device="meta")}])
    # register takes a step or a trace (the graph lints); anything else
    # is refused by name
    with pytest.raises(TypeError, match="register_preflight takes a step"):
        register_preflight(object())


class _WorkerSpawned(Exception):
    """Tripwire: the launcher reached subprocess.Popen."""


@pytest.fixture
def popen_tripwire(monkeypatch):
    def boom(*a, **k):
        raise _WorkerSpawned(a[0] if a else "?")

    monkeypatch.setattr(launcher.subprocess, "Popen", boom)
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy())


def _meta_main():
    return _META_TABLE.sum()


def test_launcher_refuses_before_any_spawn(popen_tripwire, lint_on):
    with pytest.raises(PreflightLintError):
        HorovodRunner(np=-2).run(_meta_main)


def test_lint_off_reaches_spawn(popen_tripwire):
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_meta_main)


def test_clean_main_with_lint_on_reaches_spawn(popen_tripwire, lint_on):
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_noop_main)


def test_local_mode_is_linted_too(lint_on):
    with pytest.raises(PreflightLintError):
        HorovodRunner(np=-1).run(_meta_main)
