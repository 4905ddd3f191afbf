"""Rules of the PyTorch port: it imports nothing of JAX or the JAX
package, its entry points never move to the CPU on their own, and its
chip smoke script refuses to run without a card."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
from sparkdl_tpu_torch.ops import quantized_matmul as pt_qmm
from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel import train as pt_train

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sparkdl_tpu", "sparkdl",
             "horovod"}
PORT_FILES = sorted((REPO / "sparkdl_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


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
                 "chip_smoke.py"):
        assert want in names, want
    csrc = REPO / "sparkdl_tpu_torch" / "ops" / "csrc"
    for src in ("quantized_matmul.cu", "paged_attention.cu",
                "flash_attention.cu"):
        text = (csrc / src).read_text()
        # each kernel names the TPU kernel it replaces
        assert "Replaces: sparkdl_tpu/ops/pallas/" in text, src


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
    with pytest.raises(NotImplementedError, match="attention_fn"):
        pt_llama.Llama(pt_llama.LlamaConfig.tiny(), device="cpu",
                       attention_fn=lambda q, k, v: q)


def test_chip_smoke_exits_nonzero_without_cuda(no_cuda, capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
