"""Llama-3.1's long context and the memory readings a benchmark takes,
against the JAX package on the CPU:

- ``LlamaConfig.llama31_8b`` field for field, with and without overrides;
- a tiny model with the llama3 RoPE rescale over a 16-token "original
  window", served far past it: a ~100-token prompt through the paged
  engine in chunked prefill segments, token-exact with the JAX engine;
- ``observe.mem``'s ``set_category_bytes`` (the category table equal to
  the JAX module's, telemetry on and off), ``device_peak_bytes`` (None
  on the CPU, where the JAX module falls back to live bytes; the bound
  card first, then the current device of a process with a CUDA context)
  and ``__all__``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu import observe as jobs
from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import serving as jax_serving
from sparkdl_tpu.observe import mem as jmem
from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.from_jax import load_jax_params
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.observe import health, mem

torch.set_num_threads(2)

# the llama3 rescale of Llama-3.1 (factor 8, low and high frequency
# factors 1 and 4) over an original window of 16 positions
SCALING = ("llama3", 8.0, 1.0, 4.0, 16)
MAX_LEN, PAGE, PREFILL_CHUNK = 128, 8, 16
# a prompt 6x the original window, and a short companion
PROMPTS, BUDGETS = (100, 9), (20, 6)


# -- the config --------------------------------------------------------------


def _fields(cfg):
    """The config's fields both packages have, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if isinstance(value, torch.dtype):
            value = str(value).rsplit(".", 1)[-1]
        elif f.name == "dtype":
            value = jnp.dtype(value).name
        out[f.name] = value
    return out


@pytest.mark.parametrize("kw", [
    {}, {"max_cache_len": 16384, "quant": "int8"},
    {"rope_scaling": ("linear", 2.0)}, {"rope_scaling": None}])
def test_llama31_8b_is_the_jax_config(kw):
    cfg = pt_llama.LlamaConfig.llama31_8b(**dict(kw))
    ref = jax_llama.LlamaConfig.llama31_8b(**dict(kw))
    got, want = _fields(cfg), _fields(ref)
    shared = set(got) & set(want)
    assert {"vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
            "d_ff", "rope_theta", "rope_scaling", "max_cache_len",
            "quant", "dtype"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    if "rope_scaling" not in kw:
        assert cfg.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 8192)
    # the 3.0 widths underneath
    base = pt_llama.LlamaConfig.llama3_8b(**dict(kw))
    assert dataclasses.replace(cfg, rope_scaling=base.rope_scaling) == base


def test_llama31_8b_takes_a_cut_depth():
    """A width field overrides too (the port's llama3_8b takes any
    field); the JAX classmethod passes the widths itself, so there a
    second n_layers is a TypeError."""
    cfg = pt_llama.LlamaConfig.llama31_8b(n_layers=2, max_cache_len=16384)
    assert (cfg.n_layers, cfg.d_model, cfg.max_cache_len) == (2, 4096, 16384)
    assert cfg.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 8192)
    with pytest.raises(TypeError, match="n_layers"):
        jax_llama.LlamaConfig.llama31_8b(n_layers=2)


# -- serving past the original window ----------------------------------------


@pytest.fixture(scope="module")
def long_models():
    """One JAX tiny Llama with the rescale and its port twin (weights
    carried by from_jax), beside an unscaled twin of the port model."""
    kw = dict(n_layers=1, max_cache_len=MAX_LEN, rope_scaling=SCALING)
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)
    flat = jax.tree.map(np.asarray, params)
    tcfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, **kw)
    tmodel = load_jax_params(pt_llama.Llama(tcfg, device="cpu"), flat)
    unscaled = load_jax_params(pt_llama.Llama(
        dataclasses.replace(tcfg, rope_scaling=None), device="cpu"), flat)
    return jmodel, params, tmodel, unscaled


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in PROMPTS]


def _serve(engine, prompts):
    rids = [engine.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    results = engine.run()
    return ([np.asarray(results[r]) for r in rids],
            [np.asarray(engine.logprobs[r]) for r in rids],
            [engine.finish_reasons[r] for r in rids], dict(engine.stats))


@pytest.mark.parametrize("quant", ["", "int8"])
def test_serving_past_the_window_is_the_jax_engines(long_models, quant):
    jmodel, params, tmodel, _ = long_models
    engine = dict(n_slots=2, chunk=4, page_size=PAGE,
                  prefill_chunk=PREFILL_CHUNK, quant=quant)
    prompts = _prompts(tmodel.cfg.vocab_size)
    jtoks, jlps, jreasons, jstats = _serve(
        jax_serving.ContinuousBatchingEngine(
            jmodel, params, quant_kernel="off" if quant else "", **engine),
        prompts)
    ttoks, tlps, treasons, tstats = _serve(
        ContinuousBatchingEngine(tmodel, tmodel.state_dict(), device="cpu",
                                 **engine), prompts)
    for i, (t, j) in enumerate(zip(ttoks, jtoks)):
        np.testing.assert_array_equal(t, j, err_msg=f"request {i}")
        np.testing.assert_allclose(tlps[i], jlps[i], atol=1e-4,
                                   err_msg=f"request {i} logprobs")
    assert treasons == jreasons == ["length", "length"]
    assert [len(t) for t in ttoks] == list(BUDGETS)
    # the long prompt prefilled in 7 segments of at most 16 tokens
    assert tstats["prefill_segments"] == jstats["prefill_segments"] == 7 + 1
    for key in ("steps", "active_slot_steps", "total_slot_steps"):
        assert tstats[key] == jstats[key], key


def test_the_rescale_moves_the_long_request(long_models):
    """The same weights without the rescale serve the long request
    otherwise: the test above exercises the llama3 frequencies."""
    _, _, tmodel, unscaled = long_models
    prompts = _prompts(tmodel.cfg.vocab_size)
    engine = dict(n_slots=2, chunk=4, page_size=PAGE,
                  prefill_chunk=PREFILL_CHUNK, device="cpu")
    _, scaled_lps, _, _ = _serve(ContinuousBatchingEngine(
        tmodel, tmodel.state_dict(), **engine), prompts)
    _, plain_lps, _, _ = _serve(ContinuousBatchingEngine(
        unscaled, unscaled.state_dict(), **engine), prompts)
    assert np.abs(scaled_lps[0][0] - plain_lps[0][0]) > 1e-3


def test_the_rope_table_covers_the_cache(long_models):
    """Decode reads RoPE at every position up to max_cache_len - 1, as
    the JAX model sizes its table to max(s, max_cache_len)."""
    _, _, tmodel, _ = long_models
    cos, sin = tmodel._rope_tables(torch.device("cpu"), MAX_LEN)
    jc, js = jax_llama.rope_freqs(16, MAX_LEN, tmodel.cfg.rope_theta,
                                  SCALING)
    assert cos.shape[0] == MAX_LEN
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=2e-6)


# -- observe.mem ---------------------------------------------------------------


@pytest.fixture
def both_on(tmp_path, monkeypatch):
    """Both packages' telemetry switched on, fresh state."""
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "port"))
    monkeypatch.setenv(jobs.TELEMETRY_DIR_ENV, str(tmp_path / "jax"))
    observe._reset_for_tests()
    jobs._reset_for_tests()
    yield
    monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV)
    observe._reset_for_tests()
    jobs._reset_for_tests()


@pytest.fixture
def both_off(monkeypatch):
    monkeypatch.setattr(observe, "TELEMETRY_DIR", None)
    monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV, raising=False)
    observe._reset_for_tests()
    jobs._reset_for_tests()
    yield
    observe._reset_for_tests()
    jobs._reset_for_tests()


def _category_calls(module):
    """The same point updates through either module: set, replace, a
    float byte count, clear."""
    returned = [module.set_category_bytes("kv_pages", 4096),
                module.set_category_bytes("params", 1 << 20),
                module.set_category_bytes("kv_pages", 8192.9)]
    before_clear = module.category_bytes()
    module.clear_category("params")
    return returned, before_clear, module.category_bytes()


def test_set_category_bytes_is_the_jax_modules(both_on):
    got, ref = _category_calls(mem), _category_calls(jmem)
    assert got == ref
    assert got[1] == {"kv_pages": 8192, "params": 1 << 20}
    assert got[2] == {"kv_pages": 8192}


def test_set_category_bytes_does_nothing_with_telemetry_off(both_off):
    got, ref = _category_calls(mem), _category_calls(jmem)
    assert got == ref == ([None, None, None], {}, {})


def test_device_peak_bytes_is_none_on_the_cpu(monkeypatch):
    """No bound card and no CUDA context: None, and no CUDA call (the
    JAX module gives the live buffers' bytes here; the port keeps no
    list of live tensors)."""
    def no_call(*a, **k):
        raise AssertionError("device_peak_bytes made a CUDA call")

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", no_call)
    monkeypatch.setattr(torch.cuda, "current_device", no_call)
    assert health.bound_card() is None
    assert not torch.cuda.is_initialized()
    assert mem.device_peak_bytes() is None


def test_device_peak_bytes_reads_the_bound_card_then_the_current_device(
        monkeypatch):
    """The order, with the card's calls stood in for: the card hvd.init()
    bound, else the current device once a CUDA context exists."""
    peaks = {1: 7 << 30, 0: 3 << 30}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda dev: peaks[
        dev if isinstance(dev, int) else dev.index])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(health, "bound_card",
                        lambda: torch.device("cuda", 1))
    assert mem.device_peak_bytes() == 7 << 30
    monkeypatch.setattr(health, "bound_card", lambda: None)
    assert mem.device_peak_bytes() == 3 << 30


def test_all_is_the_jax_modules_less_the_static_budget():
    # the static budget (note_budget, static_budget_bytes) came with the
    # graph lints' trace: the port's list is now the JAX module's whole
    assert set(mem.__all__) == set(jmem.__all__)
    assert len(mem.__all__) == len(set(mem.__all__))
    assert all(callable(getattr(mem, n)) or n.isupper() for n in mem.__all__)
