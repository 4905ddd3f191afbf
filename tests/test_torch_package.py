"""Rules of the PyTorch port: it imports nothing of JAX or the JAX
package, its entry points never move to the CPU on their own, and its
chip smoke script refuses to run without a card."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.models.generate import generate
from sparkdl_tpu_torch.models.serving import (
    ContinuousBatchingEngine,
    SpeculativeBatchingEngine,
)
from sparkdl_tpu_torch.models.speculative import speculative_generate
from sparkdl_tpu_torch.ops import _build
from sparkdl_tpu_torch.ops import quantized_matmul as pt_qmm
from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel import train as pt_train

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sparkdl_tpu", "sparkdl",
             "horovod"}
PORT_FILES = sorted((REPO / "sparkdl_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


# the HorovodRunner slices' modules and the JAX file each one ports
GANG_COUNTERPARTS = {
    "sparkdl_tpu_torch/hvd/__init__.py": "sparkdl_tpu/hvd/__init__.py",
    "sparkdl_tpu_torch/hvd/_state.py": "sparkdl_tpu/hvd/_state.py",
    "sparkdl_tpu_torch/hvd/_collectives.py":
        "sparkdl_tpu/hvd/_collectives.py",
    "sparkdl_tpu_torch/hvd/optim.py": "horovod/torch/__init__.py",
    "sparkdl_tpu_torch/horovod/__init__.py":
        "sparkdl_tpu/horovod/__init__.py",
    "sparkdl_tpu_torch/horovod/topology.py":
        "sparkdl_tpu/horovod/topology.py",
    "sparkdl_tpu_torch/horovod/control_plane.py":
        "sparkdl_tpu/horovod/control_plane.py",
    "sparkdl_tpu_torch/horovod/_worker.py": "sparkdl_tpu/horovod/_worker.py",
    "sparkdl_tpu_torch/horovod/launcher.py":
        "sparkdl_tpu/horovod/launcher.py",
    "sparkdl_tpu_torch/horovod/runner_base.py":
        "sparkdl_tpu/horovod/runner_base.py",
    "sparkdl_tpu_torch/horovod/supervisor.py":
        "sparkdl_tpu/horovod/supervisor.py",
    # HorovodRunner on Spark
    "sparkdl_tpu_torch/horovod/spark_backend.py":
        "sparkdl_tpu/horovod/spark_backend.py",
    "sparkdl_tpu_torch/version.py": "sparkdl_tpu/version.py",
    "sparkdl_tpu_torch/utils/checkpoint.py":
        "sparkdl_tpu/utils/checkpoint.py",
    "sparkdl_tpu_torch/utils/data.py": "sparkdl_tpu/utils/data.py",
    "sparkdl_tpu_torch/compat/horovod_torch.py": "horovod/torch/__init__.py",
    # tensor-parallel serving and the fleet
    "sparkdl_tpu_torch/parallel/mesh.py": "sparkdl_tpu/parallel/mesh.py",
    "sparkdl_tpu_torch/parallel/sharding.py":
        "sparkdl_tpu/parallel/sharding.py",
    "sparkdl_tpu_torch/models/fleet.py": "sparkdl_tpu/models/fleet.py",
    # the mixture of experts and its expert parallelism
    "sparkdl_tpu_torch/models/moe.py": "sparkdl_tpu/models/moe.py",
    # sequence and pipeline parallelism
    "sparkdl_tpu_torch/parallel/ring_attention.py":
        "sparkdl_tpu/parallel/ring_attention.py",
    "sparkdl_tpu_torch/parallel/pipeline.py":
        "sparkdl_tpu/parallel/pipeline.py",
    # the reshard plan of the resharded restore
    "sparkdl_tpu_torch/analysis/core.py": "sparkdl_tpu/analysis/core.py",
    "sparkdl_tpu_torch/analysis/comms.py": "sparkdl_tpu/analysis/comms.py",
    # the model zoo and the HF Llama conversion
    "sparkdl_tpu_torch/models/mnist_cnn.py":
        "sparkdl_tpu/models/mnist_cnn.py",
    "sparkdl_tpu_torch/models/resnet.py": "sparkdl_tpu/models/resnet.py",
    "sparkdl_tpu_torch/models/bert.py": "sparkdl_tpu/models/bert.py",
    "sparkdl_tpu_torch/models/convert.py": "sparkdl_tpu/models/convert.py",
    # gang and serving telemetry
    "sparkdl_tpu_torch/observe/__init__.py": "sparkdl_tpu/observe/__init__.py",
    "sparkdl_tpu_torch/observe/metrics.py": "sparkdl_tpu/observe/metrics.py",
    "sparkdl_tpu_torch/observe/timeline.py":
        "sparkdl_tpu/observe/timeline.py",
    "sparkdl_tpu_torch/observe/flightrec.py":
        "sparkdl_tpu/observe/flightrec.py",
    "sparkdl_tpu_torch/observe/perf.py": "sparkdl_tpu/observe/perf.py",
    "sparkdl_tpu_torch/observe/health.py": "sparkdl_tpu/observe/health.py",
    "sparkdl_tpu_torch/observe/mem.py": "sparkdl_tpu/observe/mem.py",
    "sparkdl_tpu_torch/observe/aggregate.py":
        "sparkdl_tpu/observe/aggregate.py",
    "sparkdl_tpu_torch/observe/serving.py": "sparkdl_tpu/observe/serving.py",
    # the live tier and the readers
    "sparkdl_tpu_torch/observe/alerts.py": "sparkdl_tpu/observe/alerts.py",
    "sparkdl_tpu_torch/observe/statusz.py": "sparkdl_tpu/observe/statusz.py",
    "sparkdl_tpu_torch/observe/capture.py": "sparkdl_tpu/observe/capture.py",
    "sparkdl_tpu_torch/observe/forensics.py":
        "sparkdl_tpu/observe/forensics.py",
    "sparkdl_tpu_torch/observe/doctor.py": "sparkdl_tpu/observe/doctor.py",
    "sparkdl_tpu_torch/observe/compare.py": "sparkdl_tpu/observe/compare.py",
    "sparkdl_tpu_torch/observe/trend.py": "sparkdl_tpu/observe/trend.py",
    "sparkdl_tpu_torch/observe/top.py": "sparkdl_tpu/observe/top.py",
    # the GBDT estimators and the pyspark.ml stand-ins
    **{f"sparkdl_tpu_torch/ml/{m}.py": f"sparkdl_tpu/ml/{m}.py" for m in (
        "__init__", "param", "base", "shared", "util", "dataframe",
        "evaluation", "pipeline", "classification")},
    **{f"sparkdl_tpu_torch/xgboost/{m}.py": f"sparkdl_tpu/xgboost/{m}.py"
       for m in ("__init__", "booster", "xgboost")},
}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\n"
                 "def g():\n    from sparkdl_tpu.models import llama\n")
    assert _imported_roots(f) >= {"jax", "sparkdl_tpu"}


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for want in ("sparkdl_tpu_torch/ops/_dispatch.py",
                 "sparkdl_tpu_torch/ops/_build.py",
                 "sparkdl_tpu_torch/ops/quantized_matmul.py",
                 "sparkdl_tpu_torch/ops/paged_attention.py",
                 "sparkdl_tpu_torch/models/llama.py",
                 "sparkdl_tpu_torch/models/quant.py",
                 "sparkdl_tpu_torch/models/generate.py",
                 "sparkdl_tpu_torch/models/serving.py",
                 "sparkdl_tpu_torch/models/from_jax.py",
                 "sparkdl_tpu_torch/models/lora.py",
                 "sparkdl_tpu_torch/ops/flash_attention.py",
                 "sparkdl_tpu_torch/ops/attention.py",
                 "sparkdl_tpu_torch/parallel/train.py",
                 "sparkdl_tpu_torch/parallel/ring_attention.py",
                 "sparkdl_tpu_torch/parallel/pipeline.py",
                 "sparkdl_tpu_torch/models/server.py",
                 "sparkdl_tpu_torch/models/speculative.py",
                 "sparkdl_tpu_torch/observe/metrics.py",
                 *GANG_COUNTERPARTS,
                 "chip_smoke.py"):
        assert want in names, want
    csrc = REPO / "sparkdl_tpu_torch" / "ops" / "csrc"
    for src in ("quantized_matmul.cu", "paged_attention.cu",
                "flash_attention.cu", "quantized_matmul_int4.cu"):
        text = (csrc / src).read_text()
        # each kernel names the TPU kernel it replaces
        assert "Replaces: sparkdl_tpu/ops/pallas/" in text, src


@pytest.mark.parametrize("module,counterpart", sorted(
    GANG_COUNTERPARTS.items()))
def test_gang_module_docstrings_name_their_jax_counterpart(module,
                                                          counterpart):
    doc = ast.get_docstring(ast.parse((REPO / module).read_text()))
    assert doc and f"``{counterpart}``" in doc, module
    assert (REPO / counterpart).exists(), counterpart


def test_model_zoo_exports_the_names_the_jax_package_locks():
    """``tests/test_api_lock.py``'s model-zoo names, on the port."""
    import sparkdl_tpu_torch.models as pt_models

    for name in ("Llama", "LlamaConfig", "Bert", "BertConfig",
                 "BertForQuestionAnswering",
                 "BertForSequenceClassification", "ResNet", "ResNet50",
                 "MnistCNN", "lora_mask"):
        assert name in pt_models.__all__ and hasattr(pt_models, name), name
    from sparkdl_tpu_torch.models import convert

    for name in ("config_from_hf", "params_from_hf", "params_to_hf"):
        assert callable(getattr(convert, name)), name


def test_observe_exports_the_jax_facades_names():
    """The JAX facade's ``__all__``, every name of which this port's
    telemetry slice ports; no environment variable is its switch."""
    import sparkdl_tpu.observe as jax_observe
    import sparkdl_tpu_torch.observe as pt_observe

    assert set(jax_observe.__all__) <= set(pt_observe.__all__)
    for name in jax_observe.__all__:
        assert hasattr(pt_observe, name), name
    assert pt_observe.TELEMETRY_DIR is None and not pt_observe.enabled()
    for path in (REPO / "sparkdl_tpu_torch" / "observe").glob("*.py"):
        assert "os.environ" not in path.read_text(), path.name


def test_a_port_gangs_horovod_torch_is_the_port():
    """What a port gang binds for ``import horovod.torch`` imports
    nothing of the JAX shim it stands in for."""
    from sparkdl_tpu_torch.compat import horovod_torch

    with horovod_torch.bound():
        import horovod.torch as hvd

        assert hvd is horovod_torch
        assert hvd.DistributedOptimizer.__module__.startswith(
            "sparkdl_tpu_torch.")
    assert not _imported_roots(REPO / "sparkdl_tpu_torch" / "compat"
                               / "horovod_torch.py") & FORBIDDEN


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = pt_llama.LlamaConfig.tiny(n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_llama.Llama(cfg)
    model = pt_llama.Llama(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(model, model.state_dict(), page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_qmm.quantize_params({"q_proj.kernel": np.ones((4, 4),
                                                         np.float32)})
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeculativeBatchingEngine(model, model.state_dict(),
                                  model.state_dict())
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, None, prompt, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speculative_generate(model, None, None, prompt, max_new_tokens=2)
    # a gang of one worker a card fails fast, before any worker exists
    for np_arg in (1, 2):
        with pytest.raises(RuntimeError, match="one worker a CUDA card"):
            HorovodRunner(np=np_arg).run(lambda: None)


def test_the_gbdt_entry_points_default_to_cuda(no_cuda, monkeypatch):
    """``booster.train``, ``Booster.predict_margin`` and the estimators
    (``xgboost.DEVICE`` None) run on the card and raise without one."""
    import pandas as pd

    import sparkdl_tpu_torch.xgboost as xgb
    from sparkdl_tpu_torch.xgboost import booster

    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        booster.train({"n_estimators": 1}, X, y)
    bst = booster.train({"n_estimators": 1, "max_depth": 2}, X, y,
                        device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bst.predict_margin(X)
    df = pd.DataFrame({"features": list(X), "label": y})
    assert xgb.DEVICE is None
    for est in (xgb.XgboostClassifier, xgb.XgboostRegressor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est(n_estimators=1).fit(df)
    monkeypatch.setattr(xgb, "DEVICE", "cpu")
    model = xgb.XgboostClassifier(n_estimators=1).fit(df)
    assert len(model.transform(df)) == 40


def test_training_entry_points_default_to_cuda(no_cuda):
    cfg = pt_llama.LlamaConfig.tiny(lora_rank=4, attention="flash")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_llama.Llama(cfg)
    model = pt_llama.init_weights(pt_llama.Llama(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0))
    mask = lora_mask(model)
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=1e-4,
        weight_decay=1e-4)
    loss_fn = pt_train.make_lm_loss_fn(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_train.make_train_step(loss_fn, opt, param_mask=mask)
    step = pt_train.make_train_step(loss_fn, opt, param_mask=mask,
                                    device="cpu")
    batch = pt_train.global_batch(np.random.default_rng(0), 256, 1, 8)
    assert torch.isfinite(step(batch)["loss"])


def test_tpu_and_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="flash_block"):
        pt_llama.LlamaConfig.llama3_8b(attention="flash", flash_block=64)
    # MoE is ported (attention_fn too: ring attention): n_experts takes
    # the JAX config checks
    with pytest.raises(ValueError, match="moe_top_k"):
        pt_llama.LlamaConfig.tiny(n_experts=1)
    with pytest.raises(ValueError, match="moe_every"):
        pt_llama.LlamaConfig.tiny(n_experts=2, moe_every=0)


def test_parallel_forms_are_ported_under_the_jax_names():
    import sparkdl_tpu_torch.parallel as pt_parallel
    from sparkdl_tpu_torch.parallel import pipeline, ring_attention

    jax_names = {"sparkdl_tpu/parallel/ring_attention.py": (
        "make_ring_attention", "ring_self_attention",
        "ring_flash_attention"),
        "sparkdl_tpu/parallel/pipeline.py": ("pipeline_apply",
                                             "make_pipeline")}
    for path, names in jax_names.items():
        source = (REPO / path).read_text()
        for name in names:
            assert f"def {name}(" in source, name
            assert callable(getattr(pt_parallel, name)), name
    assert pt_parallel.make_pipeline is pipeline.make_pipeline
    assert pt_parallel.ring_flash_attention is \
        ring_attention.ring_flash_attention


def test_ring_attention_takes_flash_for_cuda_tensors(monkeypatch):
    """``impl=None`` follows the tensors' device at each call (the JAX
    package's ``use_pallas()``): the flash ring for CUDA tensors, the
    dense ring for CPU ones. No CUDA tensor exists here, so the rings
    are stubbed and a stand-in carries the device."""
    import types

    from sparkdl_tpu_torch.parallel import ring_attention as ra
    from sparkdl_tpu_torch.parallel.mesh import make_mesh

    calls = []
    for name in ("ring_flash_attention", "ring_self_attention"):
        monkeypatch.setattr(ra, name, lambda q, k, v, _n=name, **kw:
                            calls.append((_n, kw["axis_name"])))
    attend = ra.make_ring_attention(make_mesh())
    attend(*[types.SimpleNamespace(device=torch.device("cuda"))] * 3)
    attend(*[torch.zeros(1)] * 3)
    assert calls == [("ring_flash_attention", "seq"),
                     ("ring_self_attention", "seq")]


def test_chip_smoke_exits_nonzero_without_cuda(no_cuda, capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_library_path_follows_the_source_its_headers_and_the_flags(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")  # a pure function of content
    assert first.startswith(os.path.join(_build.BUILD_DIR, "k-"))

    # an edited header builds anew, as an edited source does
    (tmp_path / "shared.cuh").write_text("// v2\n")
    by_header = _build.library_path("k")
    assert by_header != first
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    by_source = _build.library_path("k")
    assert by_source not in (first, by_header)
    # a new header counts too; other sources and the flags as well
    (tmp_path / "other.cuh").write_text("\n")
    with_new_header = _build.library_path("k")
    assert with_new_header != by_source
    (tmp_path / "unrelated.cu").write_text("\n")
    assert _build.library_path("k") == with_new_header
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k") != with_new_header


def _c_body(text, name):
    """The body of the C function or kernel ``name`` (from its name to
    the closing brace at column 0)."""
    start = text.index(f"{name}(")
    return text[start:text.index("\n}\n", start)]


def test_flash_forward_and_dq_are_warp_specialised_wgmma_kernels():
    csrc = REPO / "sparkdl_tpu_torch" / "ops" / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    hopper = (csrc / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    assert "cp.async.bulk.tensor" in _c_body(hopper, "tma_load")
    assert "mbarrier.try_wait" in _c_body(hopper, "mbar_wait")
    assert "wgmma.mma_async" in _c_body(hopper, "wgmma_ss_n128")
    assert "wgmma.mma_async" in _c_body(hopper, "wgmma_rs_n128")
    for name in ("produce", "produce_dkv"):
        producer = _c_body(src, name)
        assert "mbar_wait" in producer and "tma_tile" in producer
    for kernel, produce in (("flash_fwd_kernel", "produce<"),
                            ("flash_bwd_dq_kernel", "produce<"),
                            ("flash_bwd_dkv_kernel", "produce_dkv<")):
        body = _c_body(src, kernel)
        # a producer role apart from the consumer warpgroups
        assert produce in body and "setmaxnreg_dec" in body
        assert "setmaxnreg_inc" in body
        assert "hopper::wgmma_ss" in body and "hopper::wgmma_rs" in body
        assert "hopper::mbar_wait(ring." in body
        # no warp-level mma.sync product
        assert "mma(" not in body.replace("wgmma", "")
        assert "mma.sync.aligned" not in body
    # no flash kernel is left on mma.sync
    assert "mma.sync.aligned" not in src
    assert "mma.sync.aligned" not in hopper


def test_int4_bf16_products_reach_the_tensor_cores():
    """Both of the int4 matmul's bf16 kernels multiply through mma.sync
    in the source; fp32 x stays on the CUDA-core kernel, which has no
    tensor-core product."""
    src = (REPO / "sparkdl_tpu_torch" / "ops" / "csrc"
           / "quantized_matmul_int4.cu").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in \
        _c_body(src, "mma16816")
    for kernel in ("q4mm_gemv_kernel", "q4mm_gemm_kernel"):
        assert "mma16816(" in _c_body(src, kernel)
    assert "mma" not in _c_body(src, "q4mm_kernel")
    bf16 = _c_body(src, "int q4mm_bf16")
    assert "launch_tc(" in bf16 and "tc_takes(N, group)" in bf16
    assert "launch_simt<float>" in _c_body(src, "int q4mm_f32")


@pytest.mark.parametrize("source,tensor_core,cuda_core,entry", [
    ("quantized_matmul",
     {"gemv_step": "mma16816(", "qmm_gemv_kernel": "gemv_step(",
      "qmm_gemm_kernel": "wgmma_rs_n128_kb("},
     "qmm_kernel", ("int qmm_bf16", "launch_tc(")),
    ("paged_attention", {"paged_split_kernel": "mma16816("},
     "paged_decode_kernel", ("int paged_decode_bf16", "launch_split(")),
])
def test_int8_and_paged_bf16_products_reach_the_tensor_cores(
        source, tensor_core, cuda_core, entry):
    """The redesigned int8 matmul and paged decode multiply bf16 through
    mma.sync or wgmma in their own source (no library product); fp32
    inputs keep the CUDA-core kernel, which has no tensor-core product;
    the bf16 entry point routes to the tensor-core path by shape."""
    csrc = REPO / "sparkdl_tpu_torch" / "ops" / "csrc"
    src = (csrc / f"{source}.cu").read_text()
    hopper = (csrc / "hopper.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in \
        _c_body(src, "mma16816")
    assert "wgmma.mma_async" in _c_body(hopper, "wgmma_rs_n128_kb")
    for kernel, product in tensor_core.items():
        assert product in _c_body(src, kernel)
    assert "mma" not in _c_body(src, cuda_core)
    name, launch = entry
    assert launch in _c_body(src, name)
    assert "cublas" not in src.lower() and "cutlass" not in src.lower()


@pytest.mark.parametrize("kernel,full,empty", [
    ("flash_bwd_dq_kernel", "ring.k_full(st), phase", "ring.k_empty(st)"),
    ("flash_bwd_dkv_kernel", "ring.full(st), phase", "ring.empty(st)"),
])
def test_flash_backward_skip_waits_for_the_stage_it_releases(kernel, full,
                                                            empty):
    """A causal tile that a consumer warpgroup skips is still waited for
    before the warpgroup releases its stage: a parity wait passes at once
    while the barrier's previous phase is incomplete, so a consumer that
    skipped a phase could read the stage's next use before it arrived
    (seen on the card as a wrong dk block, about one run in six)."""
    src = (REPO / "sparkdl_tpu_torch" / "ops" / "csrc"
           / "flash_attention.cu").read_text()
    body = _c_body(src, kernel)
    skip = body[body.index("if (causal &&"):]
    skip = skip[:skip.index("continue;")]
    assert f"hopper::mbar_wait({full})" in skip
    assert skip.index(f"hopper::mbar_wait({full})") < skip.index(
        f"hopper::mbar_arrive({empty})")
