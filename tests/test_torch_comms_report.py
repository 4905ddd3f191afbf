"""The port's comms report against the JAX package's: the ring pricing
(``collective_wire_bytes``) number for number, the report's schema key
for key, the traced collectives priced, and one gang of two as
``tests/analysis/test_comms.py``'s end-to-end gate: the bytes predicted
for a rank's step within 2x of the ``collective_bytes_total{op="reduce"}``
it measured, with the launcher's pre-flight leaving the registered
step's report in the run directory as ``comms_report.json``."""

import glob
import json
import os
import re
import sys

import cloudpickle
import pytest
import torch

from sparkdl_tpu.analysis import comms as jcomms
from sparkdl_tpu_torch import HorovodRunner, hvd, observe
from sparkdl_tpu_torch.analysis import comms, preflight, register_preflight
from sparkdl_tpu_torch.analysis.trace import trace_step
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "collective-broadcast", "barrier")


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_are_the_jax_packages(kind):
    for n in (None, 1, 2, 4, 8):
        for nbytes in (0, 4, 1000, 65536, 3 << 20):
            assert comms.collective_wire_bytes(kind, nbytes, n) == \
                jcomms.collective_wire_bytes(kind, nbytes, n), (kind, n)


_HLO = """
HloModule step, num_partitions=4
ENTRY %main {
  %p0 = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %r = f32[1024]{0} add(f32[1024]{0} %ar, f32[1024]{0} %p0)
}
"""

_M4 = Mesh(AXES, (4, 1, 1, 1))


def _keys(doc):
    """The report's key tree: each dict's keys, the first entry of each
    list."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(doc[0])] if doc else []
    return None


def test_report_keys_are_the_jax_schema():
    j = jcomms.comms_report(_HLO, name="step")
    trace = trace_step(lambda x: _M4.all_reduce(x, "data") + x,
                       torch.ones(1024), mesh=_M4, rank=0)
    p = comms.comms_report(trace, name="step")
    assert p["schema"] == j["schema"] == comms.COMMS_SCHEMA
    assert _keys(p) == _keys(j)
    # the same collective, priced alike (the interconnect rows differ)
    (je,), (pe,) = j["collectives"], p["collectives"]
    for k in ("kind", "dtype", "shape", "group_size", "result_bytes",
              "wire_bytes_per_device"):
        assert pe[k] == je[k], k
    assert p["device_kind"] == "h100"
    assert p["ici_bytes_per_sec"] == 900e9
    assert pe["predicted_s"] == pe["wire_bytes_per_device"] / 900e9


def test_each_traced_collective_is_priced_by_kind():
    mesh = Mesh(AXES, (2, 1, 1, 4))

    def step(x):
        y = mesh.all_reduce(x, "model")                  # 4 KiB, n 4
        z = mesh.all_gather(y, "model", dim=0)           # 16 KiB whole
        w = mesh.reduce_scatter(z, "data", dim=0)        # 8 KiB shard
        return mesh.ppermute(w, "data")                  # 8 KiB hop

    report = comms.comms_report(trace_step(step, torch.ones(256, 4),
                                           mesh=mesh, rank=5))
    got = [(e["kind"], e["group_size"], e["result_bytes"],
            e["wire_bytes_per_device"]) for e in report["collectives"]]
    assert got == [("all-reduce", 4, 4096, 2 * 3 / 4 * 4096),
                   ("all-gather", 4, 16384, 3 / 4 * 16384),
                   ("reduce-scatter", 2, 8192, 8192.0),
                   ("collective-permute", 2, 8192, 8192.0)]
    assert report["totals"]["count"] == 4
    assert report["assumptions"]["n_devices"] == 8
    assert report["totals"]["by_kind"]["all-gather"]["count"] == 1


def test_group_size_of_reads_the_group():
    trace = trace_step(lambda x: _M4.all_reduce(x, "data"), torch.ones(4),
                       mesh=_M4, rank=2)
    (col,) = trace.collectives
    assert comms.group_size_of(col) == 4 and col.ranks == (0, 1, 2, 3)


def test_write_report_wraps_a_list(tmp_path):
    for doc in ({"schema": "x"}, [{"schema": "x"}], {"reports": []}):
        path = comms.write_report(doc, str(tmp_path / "r.json"))
        with open(path) as f:
            assert "reports" in json.load(f)


# -- a gang of two -----------------------------------------------------------


def _allreduce_step(x):
    return hvd.allreduce(x, op=hvd.Sum)


def _crosscheck_main(n_steps, elems):
    """Each rank reduces its payload ``n_steps`` times, then prices the
    same step from its own trace (the gang's world, this rank)."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.analysis.comms import comms_report
    from sparkdl_tpu_torch.analysis.trace import trace_step

    torch.set_num_threads(2)
    hvd.init()
    x = torch.full((elems,), float(hvd.rank() + 1))
    for _ in range(n_steps):
        hvd.allreduce(x, op=hvd.Sum)
    report = comms_report(trace_step(_allreduce_step, x))
    return hvd.allgather_object({
        "rank": hvd.rank(), "payload_nbytes": x.numel() * x.element_size(),
        "predicted_per_step": report["totals"]["wire_bytes_per_device"],
        "collectives": report["totals"]["count"]})


@pytest.mark.gang
def test_gang_predicted_vs_measured_within_2x(tmp_path, monkeypatch):
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setattr(preflight, "ENABLED", True)
    observe._reset_for_tests()
    preflight.clear()
    n_steps, elems = 4, 1 << 14          # 64 KiB a step
    try:
        register_preflight(_allreduce_step, torch.ones(elems),
                           mesh={"data": 2})
        ranks = HorovodRunner(np=-2).run(_crosscheck_main, n_steps=n_steps,
                                         elems=elems)
    finally:
        preflight.clear()
        observe._reset_for_tests()
    (run,) = glob.glob(str(tmp_path / "run-*"))
    with open(os.path.join(run, "comms_report.json")) as f:
        (driver,) = json.load(f)["reports"]
    assert driver["schema"] == comms.COMMS_SCHEMA
    with open(os.path.join(run, "metrics.prom")) as f:
        prom = f.read()
    measured = {int(r): float(v) for r, v in re.findall(
        r'collective_bytes_total\{op="reduce",rank="(\d+)"\}\s+(\S+)', prom)}
    assert set(measured) == {0, 1}, prom
    for r in ranks:
        predicted = r["predicted_per_step"]
        assert r["collectives"] == 1 and predicted > 0
        assert predicted == driver["totals"]["wire_bytes_per_device"]
        ratio = measured[r["rank"]] / n_steps / predicted
        assert 0.5 <= ratio <= 2.0, (r, measured, ratio)
