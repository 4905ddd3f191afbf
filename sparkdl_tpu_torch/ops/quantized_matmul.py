"""Weight-only int8 matmul: x @ dequant(w_q) with per-column scales.

Counterpart of ``sparkdl_tpu/ops/pallas/quantized_matmul.py`` (int8
only; int4 is not ported yet). Weights stay int8 on the card with fp32
scales, half the bytes of bf16: a decode step is bound by the bytes of
its weights. ``quantized_matmul`` takes its path from the device of its
inputs: CPU tensors run :func:`quantized_matmul_reference`, CUDA
tensors launch the hand-written kernel in ``csrc/quantized_matmul.cu``
or raise. There is no fallback from the kernel to the plain version.
"""

import ctypes

import torch

from sparkdl_tpu_torch.ops import _build
from sparkdl_tpu_torch.ops._dispatch import resolve_device

# Dense layers quantized by default: every 2-D projection of the
# decoder family; embeddings stay dense (a lookup reads one row).
DEFAULT_QUANT_TARGETS = ("gate_proj", "up_proj", "down_proj",
                         "q_proj", "k_proj", "v_proj",
                         "o_proj", "lm_head")

_KERNEL_DTYPES = {torch.bfloat16: "qmm_bf16", torch.float32: "qmm_f32"}


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantization of a (K, N)
    weight matrix → (w_q int8 (K, N), scales fp32 (N,)), on ``w``'s
    device. Bit-identical to the JAX package's numpy version:
    ``torch.round`` rounds half to even, as ``np.round`` does."""
    w = w.to(torch.float32)
    scales = w.abs().amax(dim=0) / 127.0
    scales = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    w_q = torch.clamp(torch.round(w / scales[None, :]), -127, 127)
    return w_q.to(torch.int8), scales


def quantize_params(params, targets=DEFAULT_QUANT_TARGETS, bits=8,
                    device=None):
    """Quantize the matching 2-D ``<module>.kernel`` entries of a flat
    state dict → (new dict, bytes saved). Each weight is quantized on
    ``device`` (default CUDA) one matrix at a time; ``<name>.kernel``
    becomes ``<name>.kernel_q`` (int8) + ``<name>.kernel_scale`` (fp32),
    the JAX package's leaf names. Other entries pass through as they
    are. Accepts tensors or numpy arrays."""
    if bits == 4:
        raise NotImplementedError("bits=4 (int4) is not ported yet")
    if bits != 8:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    device = resolve_device(device)
    out, saved = {}, 0
    for name, value in params.items():
        module, _, leaf = name.rpartition(".")
        owner = module.rpartition(".")[2]
        value = torch.as_tensor(value)
        if leaf == "kernel" and value.ndim == 2 and any(
                t in owner for t in targets):
            w_q, s = quantize_int8(value.to(device))
            # savings against the ORIGINAL dtype (bf16 kernels are 2
            # bytes an element, not 4)
            saved += (value.numel() * value.element_size()
                      - w_q.numel() - 4 * s.numel())
            out[module + ".kernel_q"] = w_q
            out[module + ".kernel_scale"] = s
        else:
            out[name] = value
    return out, saved


def quantized_matmul_reference(x, w_q, scales):
    """The plain version: the JAX package's XLA dequant lowering,
    ``(x.f32 @ (w_q.f32 * scales)).astype(x.dtype)``."""
    w = w_q.to(torch.float32) * scales[None, :]
    return (x.to(torch.float32) @ w).to(x.dtype)


def _check(x, w_q, scales):
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(
            f"quantized_matmul needs x (M, K) and w_q (K, N); got "
            f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    if tuple(scales.shape) != (w_q.shape[1],):
        # caller bug: a mis-shaped scale vector would broadcast into a
        # wrong-SHAPED product, so there is nothing correct to compute
        raise ValueError(
            f"scales shape {tuple(scales.shape)} does not match "
            f"N={w_q.shape[1]}")


def quantized_matmul(x, w_q, scales):
    """x (M, K) @ dequant(w_q (K, N) int8) with per-column fp32 scales
    (N,) → (M, N) in x's dtype. CPU inputs: the plain version. CUDA
    inputs: the kernel, which takes x in bf16 or fp32, w_q int8 and
    scales fp32, all contiguous on one card (w_q 8-byte aligned);
    anything else raises. A non-int8 weight raises on CUDA (the JAX
    dispatch degrades it to its XLA lowering with a warning)."""
    _check(x, w_q, scales)
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_q, scales)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (w_q.device == x.device and scales.device == x.device):
        raise ValueError("x, w_q and scales must be on one CUDA device")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes bf16 or fp32")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q dtype {w_q.dtype} is not int8")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales dtype {scales.dtype} is not fp32")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("quantized_matmul needs contiguous inputs")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    splits, k_per_split = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.qmm_plan(
        m, k, n, torch.cuda.get_device_properties(x.device)
        .multi_processor_count, ctypes.byref(splits),
        ctypes.byref(k_per_split)), "quantized_matmul plan")
    splits = splits.value
    # fp32 partial sums of the K splits, summed in order by a second pass
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = getattr(lib, _KERNEL_DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(),
                 partial.data_ptr() if partial is not None else None,
                 m, k, n, splits, k_per_split.value, stream)
    # the kernel refuses (cudaErrorInvalidValue) a w_q that is not
    # 8-byte aligned: see launch() in csrc/quantized_matmul.cu
    _build.check(lib, err, f"quantized_matmul ({m}, {k}, {n})")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0


_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_PLAN_SIGNATURE = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2


def _library():
    signatures = {name: _SIGNATURE for name in _KERNEL_DTYPES.values()}
    signatures["qmm_plan"] = _PLAN_SIGNATURE
    return _build.load("quantized_matmul", signatures)
