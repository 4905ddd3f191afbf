"""The port's settings registry against the JAX package's knob registry:
every JAX knob stands for one registered port setting or is listed with
the reason the port has none; every registered setting exists with its
registered default; the tunable space per bench, the reader, the
command-line parser; and the port's module-level settings themselves
drift into the registry (a setting a JAX knob stands for is never left
out of it)."""

import re
from pathlib import Path

import pytest
import torch

from sparkdl_tpu.utils import knobs as jax_knobs
from sparkdl_tpu_torch.utils import knobs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_every_jax_knob_is_mapped_or_listed_with_a_reason():
    missing = sorted(n for n in jax_knobs.KNOBS
                     if knobs.by_env(n) is None and n not in knobs.UNMAPPED)
    assert missing == [], missing
    both = sorted(n for n in jax_knobs.KNOBS
                  if knobs.by_env(n) is not None and n in knobs.UNMAPPED)
    assert both == [], both
    # nothing listed that the JAX registry lacks, and every reason says
    # something
    assert set(knobs.UNMAPPED) <= set(jax_knobs.KNOBS)
    assert all(len(r) > 20 for r in knobs.UNMAPPED.values())
    envs = [kb.env for kb in knobs.all_knobs() if kb.env]
    assert len(envs) == len(set(envs))
    assert set(envs) <= set(jax_knobs.KNOBS)


@pytest.mark.parametrize("name", sorted(knobs.KNOBS))
def test_registered_setting_exists_with_its_default(name):
    kb = knobs.get(name)
    assert name.startswith("sparkdl_tpu_torch.")
    # every registered setting has its module (the GBDT bin count, the
    # last placeholder, is the gbdt trial's since the estimators' port)
    assert knobs.read(name) == kb.default


def test_tunable_settings_keep_the_jax_decisions():
    """The same knobs are tunable, with the JAX trial values (as
    values) and gating components; the benches map cpu-proxy to train."""
    bench_map = {"cpu-proxy": "train", "serve": "serve", "gbdt": "gbdt"}
    unmapped_tunables = {"SPARKDL_TPU_PREFETCH_DEPTH",
                         "SPARKDL_TPU_FLASH_BLOCK_Q",
                         "SPARKDL_TPU_FLASH_BLOCK_KV",
                         "SPARKDL_TPU_PAGED_PAGES_PER_BLOCK",
                         "SPARKDL_TPU_KERNEL_QUANT_MATMUL"}
    for jk in jax_knobs.tunable_knobs():
        kb = knobs.by_env(jk.name)
        if jk.name in unmapped_tunables:
            assert kb is None and jk.name in knobs.UNMAPPED
            continue
        assert kb is not None and kb.tunable, jk.name
        assert kb.component == jk.component
        assert sorted(bench_map[b] for b in jk.benches) == \
            sorted(kb.benches)
        if jk.name == "SPARKDL_TPU_KV_PAGE_SIZE":
            # the port serves paged by default (64-token pages, phase 3)
            assert kb.trial_values == (0, 64) and kb.default == 64
        elif jk.name == "SPARKDL_TPU_SERVE_QUANT":
            # int8, the paged int8 engine, is the port's default
            assert kb.trial_values == ("", "int8")
            assert kb.default == "int8"
        else:
            assert [str(v).lower() for v in kb.trial_values] == \
                [{"0": "false", "1": "true"}.get(v, v)
                 if kb.type == "bool" else str(knobs.parse_value(kb, v))
                 for v in jk.trial_values], jk.name
    assert {kb.name for kb in knobs.tunable_knobs("serve")} == {
        f"sparkdl_tpu_torch.perf.trial.SERVE_{n}" for n in
        ("PAGE_SIZE", "DECODE_CHUNK", "REPLICAS", "MAX_QUEUE", "QUANT")}
    assert [kb.name for kb in knobs.tunable_knobs("train")] == [
        "sparkdl_tpu_torch.perf.trial.LOSS_CHUNK"]
    assert [kb.env for kb in knobs.tunable_knobs("gbdt")] == [
        "SPARKDL_TPU_GBDT_MAX_BINS"]


def test_tile_knobs_have_no_counterpart():
    for env in ("SPARKDL_TPU_FLASH_BLOCK", "SPARKDL_TPU_FLASH_BLOCK_Q",
                "SPARKDL_TPU_FLASH_BLOCK_KV",
                "SPARKDL_TPU_PAGED_PAGES_PER_BLOCK",
                "SPARKDL_TPU_KERNEL_QUANT_MATMUL",
                "SPARKDL_TPU_BENCH_NO_DONATE",
                "SPARKDL_TPU_PREFETCH_DEPTH",
                "SPARKDL_TPU_COMPILE_CACHE_DIR"):
        assert env in knobs.UNMAPPED


def test_read_follows_the_setting_and_refuses_unregistered(monkeypatch):
    from sparkdl_tpu_torch.observe import alerts
    from sparkdl_tpu_torch.parallel import ring_attention

    monkeypatch.setattr(alerts, "CHECK_S", 0.25)
    assert knobs.read("sparkdl_tpu_torch.observe.alerts.CHECK_S") == 0.25
    with pytest.raises(KeyError, match="unregistered"):
        knobs.read("sparkdl_tpu_torch.observe.alerts.NOPE")
    # the ring's overlap=None reads the registered setting at call time
    monkeypatch.setattr(ring_attention, "OVERLAP", False)
    assert ring_attention.resolve_overlap(None) is False
    assert ring_attention.resolve_overlap(True) is True
    assert knobs.read(
        "sparkdl_tpu_torch.horovod.supervisor.RetryPolicy.relaunch_np") \
        is None


def test_parse_value_by_type():
    chunk = knobs.get("sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK")
    overlap = knobs.get("sparkdl_tpu_torch.parallel.ring_attention.OVERLAP")
    quant = knobs.get("sparkdl_tpu_torch.perf.trial.SERVE_QUANT")
    queue = knobs.get("sparkdl_tpu_torch.perf.trial.SERVE_MAX_QUEUE")
    assert knobs.parse_value(chunk, "8") == 8
    assert knobs.parse_value(overlap, "0") is False
    assert knobs.parse_value(overlap, "true") is True
    assert knobs.parse_value(quant, "") == ""
    assert knobs.parse_value(queue, "none") is None
    with pytest.raises(ValueError):
        knobs.parse_value(overlap, "maybe")


def test_settings_that_stand_for_jax_knobs_are_registered():
    """The drift gate's port twin: a module setting whose comment or
    docstring names the JAX knob it replaces is registered under that
    knob."""
    envs = {kb.env for kb in knobs.all_knobs()}
    text = "\n".join(p.read_text() for p in
                     (REPO / "sparkdl_tpu_torch").rglob("*.py")
                     if p.name != "knobs.py")
    named = set(re.findall(r"SPARKDL_TPU_[A-Z0-9_]*[A-Z0-9]", text))
    dynamic = {"SPARKDL_TPU_CHAOS", "SPARKDL_TPU_ALERT",
               "SPARKDL_TPU_MEM", "SPARKDL_TPU_SERVING",
               "SPARKDL_TPU_ELASTIC"}  # family names in prose
    stray = sorted(n for n in named - dynamic
                   if n not in envs and n not in knobs.UNMAPPED)
    assert stray == [], stray
