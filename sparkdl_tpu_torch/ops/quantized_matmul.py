"""Weight-only int8 and int4 matmuls: x @ dequant(w) with fp32 scales.

Counterpart of ``sparkdl_tpu/ops/pallas/quantized_matmul.py``. int8
weights carry one fp32 scale a column, half the bytes of bf16; int4
weights are nibble-packed two rows to a byte with one fp32 scale per
``group`` rows of a column, a quarter of the bytes of bf16 plus 1/8 of
that in scales. A decode step is bound by the bytes of its weights.
Each wrapper takes its path from the device of its inputs: CPU tensors
run the plain version (:func:`quantized_matmul_reference`,
:func:`quantized_matmul_int4_reference`), CUDA tensors launch the
hand-written kernel (``csrc/quantized_matmul.cu``,
``csrc/quantized_matmul_int4.cu``) or raise, and ``meta`` tensors (a
traced step) take the kernel's checks and return its empty output with
one kernel event. There is no fallback from a kernel to its plain
version.
"""

import ctypes
import warnings

import torch

from sparkdl_tpu_torch.ops import _build
from sparkdl_tpu_torch.ops._dispatch import (
    count_launch,
    launch_on,
    resolve_device,
    sm_count,
    traced_launch,
)

# Dense layers quantized by default: every 2-D projection of the
# decoder family; embeddings stay dense (a lookup reads one row).
DEFAULT_QUANT_TARGETS = ("gate_proj", "up_proj", "down_proj",
                         "q_proj", "k_proj", "v_proj",
                         "o_proj", "lm_head")

# int4 group size (rows of a column per scale)
INT4_GROUP = 64

_KERNEL_DTYPES = {torch.bfloat16: "qmm_bf16", torch.float32: "qmm_f32"}
_Q4_KERNEL_DTYPES = {torch.bfloat16: "q4mm_bf16", torch.float32: "q4mm_f32"}

# split plans by (plan function, device index, shape, x is bf16): a plan
# depends on nothing else, and a decode step asks for the same few
# hundreds of times
_PLANS = {}


def _plan(lib, plan_fn, what, device, *shape):
    """(splits, k_per_split) of a C plan function for ``shape``, asked
    of the library once per shape and device."""
    key = (plan_fn, device.index, *shape)
    plan = _PLANS.get(key)
    if plan is None:
        splits, k_per_split = ctypes.c_int(), ctypes.c_int()
        _build.check(lib, getattr(lib, plan_fn)(
            *shape, sm_count(device), ctypes.byref(splits),
            ctypes.byref(k_per_split)), what)
        plan = _PLANS[key] = (splits.value, k_per_split.value)
    return plan


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


def quantize_int4(w, group=INT4_GROUP):
    """Group-wise symmetric int4 quantization of a (K, N) weight matrix
    → (packed int8 (K/2, N), scales fp32 (K/group, N)), on ``w``'s
    device. Row 2i rides the LOW nibble of packed row i, row 2i+1 the
    HIGH nibble. Bit-identical to the JAX package's numpy version."""
    w = w.to(torch.float32)
    k, n = w.shape
    if k % max(group, 2):
        raise ValueError(f"K={k} must be divisible by group={group} (and 2)")
    g = w.reshape(k // group, group, n)
    scales = g.abs().amax(dim=1) / 7.0                 # (K/group, N)
    scales = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    w_q = torch.clamp(torch.round(g / scales[:, None, :]), -7, 7)
    w_q = w_q.reshape(k, n).to(torch.int8).to(torch.uint8)
    packed = (w_q[0::2] & 0x0F) | ((w_q[1::2] & 0x0F) << 4)
    return packed.view(torch.int8), scales


def unpack_int4(packed):
    """(K/2, N) packed int8 → (K, N) int8: both nibbles sign-extended
    (the low one by an arithmetic shift pair, the high one by one)."""
    p = packed.to(torch.int8)
    low = (p << 4) >> 4
    high = p >> 4
    kh, n = p.shape
    return torch.stack([low, high], dim=1).reshape(2 * kh, n)


def _dequant_int4(packed, scales, group):
    w = unpack_int4(packed).to(torch.float32)
    return w * scales.repeat_interleave(group, dim=0)


def quantize_params(params, targets=DEFAULT_QUANT_TARGETS, bits=8,
                    group=INT4_GROUP, device=None):
    """Quantize the matching 2-D ``<module>.kernel`` entries of a flat
    state dict → (new dict, bytes saved). Each weight is quantized on
    ``device`` (default CUDA) one matrix at a time. ``bits=8``:
    ``<name>.kernel`` becomes ``<name>.kernel_q`` (int8) +
    ``<name>.kernel_scale`` (fp32, per column); ``bits=4``:
    ``<name>.kernel_q4`` (nibble-packed int8, (K/2, N)) +
    ``<name>.kernel_scale4`` (fp32, (K/group, N)) — the JAX package's
    leaf names. Other entries pass through as they are. Accepts tensors
    or numpy arrays."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    device = resolve_device(device)
    out, saved = {}, 0
    for name, value in params.items():
        module, _, leaf = name.rpartition(".")
        owner = module.rpartition(".")[2]
        value = torch.as_tensor(value)
        if leaf == "kernel" and value.ndim == 2 and any(
                t in owner for t in targets):
            if bits == 8:
                w_q, s = quantize_int8(value.to(device))
                names = ("kernel_q", "kernel_scale")
            else:
                w_q, s = quantize_int4(value.to(device), group=group)
                names = ("kernel_q4", "kernel_scale4")
            # savings against the ORIGINAL dtype (bf16 kernels are 2
            # bytes an element, not 4)
            saved += (value.numel() * value.element_size()
                      - w_q.numel() - 4 * s.numel())
            out[f"{module}.{names[0]}"] = w_q
            out[f"{module}.{names[1]}"] = s
        else:
            out[name] = value
    return out, saved


def dequantize_params(qparams, dtype=torch.bfloat16):
    """The inverse layout of :func:`quantize_params`: every
    (``kernel_q``, ``kernel_scale``) or (``kernel_q4``,
    ``kernel_scale4``) pair of a flat state dict becomes a dense
    ``kernel`` in ``dtype`` again (the int4 group from the scale
    shape). Other entries pass through."""
    out = {}
    for name, value in qparams.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel_q":
            w = (value.to(torch.float32)
                 * qparams[f"{module}.kernel_scale"][None, :])
        elif leaf == "kernel_q4":
            scales = qparams[f"{module}.kernel_scale4"]
            w = _dequant_int4(value, scales,
                              2 * value.shape[0] // scales.shape[0])
        elif leaf in ("kernel_scale", "kernel_scale4"):
            continue
        else:
            out[name] = value
            continue
        out[f"{module}.kernel"] = w.to(dtype)
    return out


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
    scales fp32, all contiguous on one card; anything else raises. bf16
    x at N a multiple of 16 and K a multiple of 8, with x, w_q, scales
    and the output 16-byte aligned, runs on the tensor cores (a
    ``mma.sync`` GEMV at M <= 8, a ``wgmma`` GEMM above); fp32 x (the
    ``lm_head``) and every other bf16 call run on the CUDA cores, which
    need w_q 8-byte aligned. A non-int8 weight raises on CUDA (the JAX
    dispatch degrades it to its XLA lowering with a warning)."""
    _check(x, w_q, scales)
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_q, scales)
    if x.device.type not in ("cuda", "meta"):
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
    if x.is_meta:
        return traced_launch(quantized_matmul, "B5", (x, w_q, scales),
                             (out,), 2 * m * k * n)[0]
    if m == 0 or n == 0:
        return out
    lib = _library()
    splits, k_per_split = _plan(lib, "qmm_plan", "quantized_matmul plan",
                                x.device, m, k, n,
                                int(x.dtype == torch.bfloat16))
    # fp32 partial sums of the K splits, summed in order by a second pass
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    err = launch_on(x.device, getattr(lib, _KERNEL_DTYPES[x.dtype]),
                    x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                    out.data_ptr(),
                    partial.data_ptr() if partial is not None else None,
                    m, k, n, splits, k_per_split)
    # the kernel refuses (cudaErrorInvalidValue) a w_q that is not
    # 8-byte aligned on the CUDA cores: see launch_simt() in
    # csrc/quantized_matmul.cu
    _build.check(lib, err, f"quantized_matmul ({m}, {k}, {n})")
    count_launch(quantized_matmul)
    return out


quantized_matmul.launches = 0


_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# M, K, N, x is bf16, SMs; splits, k_per_split out
_PLAN_SIGNATURE = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2


def _library():
    signatures = {name: _SIGNATURE for name in _KERNEL_DTYPES.values()}
    signatures["qmm_plan"] = _PLAN_SIGNATURE
    return _build.load("quantized_matmul", signatures)


# -- int4 --------------------------------------------------------------


def quantized_matmul_int4_reference(x, packed, scales, group=INT4_GROUP):
    """The plain version: the JAX package's XLA lowering,
    ``(x.f32 @ (unpack(packed).f32 * repeat(scales, group))).astype(
    x.dtype)``."""
    w = _dequant_int4(packed, scales, group)
    return (x.to(torch.float32) @ w).to(x.dtype)


def _int4_group(x, packed, scales, group):
    """The JAX dispatch's shape checks; returns the group to compute
    with. A ``group`` that does not cover K with the given scale rows
    warns and yields the group the shapes imply; scales that no group
    can cover raise."""
    if x.ndim != 2 or packed.ndim != 2 or scales.ndim != 2:
        raise ValueError(
            f"quantized_matmul_int4 needs x (M, K), packed (K/2, N) and "
            f"scales (K/group, N); got {tuple(x.shape)}, "
            f"{tuple(packed.shape)} and {tuple(scales.shape)}")
    k, s_rows = x.shape[1], scales.shape[0]
    if k != 2 * packed.shape[0]:
        raise ValueError(
            f"packed int4 weight has {packed.shape[0]} rows; K={k} "
            "activations need K//2")
    if scales.shape[1] != packed.shape[1]:
        raise ValueError(
            f"scales shape {tuple(scales.shape)} does not match "
            f"N={packed.shape[1]}")
    if group <= 0 or group * s_rows != k:
        if s_rows == 0 or k % s_rows:
            raise ValueError(
                f"int4 scales with {s_rows} rows cannot cover K={k} "
                f"under any group (requested group={group})")
        inferred = k // s_rows
        warnings.warn(
            f"int4 group={group} does not cover K={k} with {s_rows} scale "
            f"rows; using inferred group={inferred}", RuntimeWarning,
            stacklevel=3)
        group = inferred
    return group


def quantized_matmul_int4(x, packed, scales, group=INT4_GROUP):
    """x (M, K) @ dequant(packed (K/2, N) int8, two nibbles a byte)
    with group-wise fp32 scales (K/group, N) → (M, N) in x's dtype.
    CPU inputs: the plain version. CUDA inputs: the kernel, which takes
    x in bf16 or fp32, packed int8 and scales fp32, all contiguous on
    one card; anything else raises. bf16 x at N a multiple of 16 and
    group 32, 64 or 128 runs on the tensor cores, which need x, packed,
    scales and the output 16-byte aligned; fp32 x and other bf16 shapes
    run on the CUDA cores, which need packed 8-byte and scales 16-byte
    aligned. A ``group`` that disagrees with the scale rows
    warns and computes with the inferred group on the same route, as
    the JAX dispatch does; a non-int8 packed weight raises on CUDA (the
    JAX dispatch degrades it to its XLA lowering with a warning)."""
    group = _int4_group(x, packed, scales, group)
    if x.device.type == "cpu":
        return quantized_matmul_int4_reference(x, packed, scales, group)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    if not (packed.device == x.device and scales.device == x.device):
        raise ValueError("x, packed and scales must be on one CUDA device")
    if x.dtype not in _Q4_KERNEL_DTYPES:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes bf16 or fp32")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed dtype {packed.dtype} is not int8")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales dtype {scales.dtype} is not fp32")
    if not (x.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("quantized_matmul_int4 needs contiguous inputs")
    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.is_meta:
        return traced_launch(quantized_matmul_int4, "B6",
                             (x, packed, scales), (out,), 2 * m * k * n)[0]
    if m == 0 or n == 0:
        return out
    lib = _library_int4()
    splits, k_per_split = _plan(lib, "q4mm_plan",
                                "quantized_matmul_int4 plan", x.device,
                                m, k, n, group,
                                int(x.dtype == torch.bfloat16))
    # fp32 partial sums of the K splits, summed in order by a second pass
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    err = launch_on(x.device, getattr(lib, _Q4_KERNEL_DTYPES[x.dtype]),
                    x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                    out.data_ptr(),
                    partial.data_ptr() if partial is not None else None,
                    m, k, n, group, splits, k_per_split)
    # the C entry point refuses (cudaErrorInvalidValue) an odd K, a
    # group that does not divide K and misaligned inputs: see
    # launch_tc() and launch_simt() in csrc/quantized_matmul_int4.cu
    _build.check(lib, err, f"quantized_matmul_int4 ({m}, {k}, {n}), "
                           f"group {group}")
    count_launch(quantized_matmul_int4)
    return out


quantized_matmul_int4.launches = 0

_Q4_SIGNATURE = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
# M, K, N, group, x is bf16, SMs; splits, k_per_split out
_Q4_PLAN_SIGNATURE = ([ctypes.c_int] * 6
                      + [ctypes.POINTER(ctypes.c_int)] * 2)


def _library_int4():
    signatures = {name: _Q4_SIGNATURE for name in _Q4_KERNEL_DTYPES.values()}
    signatures["q4mm_plan"] = _Q4_PLAN_SIGNATURE
    return _build.load("quantized_matmul_int4", signatures)
