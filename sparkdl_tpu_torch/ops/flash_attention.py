"""Flash attention kernels: the forward with its per-row logsumexp, and
the two backward kernels (dq; dk and dv).

Counterpart of ``sparkdl_tpu/ops/pallas/flash_attention.py``. Tensors
keep the models' layout, (B, S, H, D), with k and v carrying as many
heads as q (GQA repeated by the caller); ``lse`` and ``delta`` are
(B, H, S) fp32. Each wrapper takes its path from the device of its
inputs: CPU tensors run the plain version beside it, CUDA tensors launch
the hand-written kernel in ``csrc/flash_attention.cu`` or raise, and
``meta`` tensors (a traced step) take the kernel's checks and return its
empty outputs with one kernel event (``_dispatch.traced_launch``). Any S
is taken as it is: the kernels mask keys >= S themselves, so nothing is
padded.
"""

import ctypes

import torch

from sparkdl_tpu_torch.ops import _build
from sparkdl_tpu_torch.ops._dispatch import count_launch, traced_launch

NEG_INF = -1e30

def flash_flops(kind, b, s, h, d, causal):
    """Operations of one flash call: 4 (forward), 6 (dq) or 8 (dk/dv)
    * D flops a visible (query, key) pair."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return {"fwd": 4, "dq": 6, "dkv": 8}[kind] * pairs * d


def _scale(q, scale):
    # the JAX package's ``scale or d ** -0.5``: 0 and None take the default
    return scale or q.shape[-1] ** -0.5


def _visible(sq, sk, causal, device):
    """(sq, sk) bool: key j visible from query i (all, or j <= i)."""
    if not causal:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def _scores(q, k, scale):
    # bf16 products are exact in fp32: the sum is the kernels' fp32 one
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def flash_attention_reference(q, k, v, causal=True, scale=None):
    """The plain version of :func:`flash_fwd`: dense fp32 scores, masked
    to -1e30, softmax state in fp32, probabilities cast to v's dtype for
    the PV product (fp32 accumulation). Returns (o in q's dtype, lse
    (B, H, S) fp32)."""
    scale = _scale(q, scale)
    s = _scores(q, k, scale)
    s = s.masked_fill(~_visible(q.shape[1], k.shape[1], causal, q.device),
                      NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p.masked_fill(m <= NEG_INF / 2, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """p = exp(s - lse) (zero where masked) and ds = p (dp - delta) scale,
    both (B, H, Sq, Sk) fp32."""
    scale = _scale(q, scale)
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    p = p.masked_fill(~_visible(q.shape[1], k.shape[1], causal, q.device),
                      0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=True,
                           scale=None):
    """The plain version of :func:`flash_bwd_dq`: dq = sum ds k, ds cast to
    k's dtype before the product."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True,
                            scale=None):
    """The plain version of :func:`flash_bwd_dkv`: dk = sum ds^T q and
    dv = sum p^T do, ds and p cast to the operands' dtype first."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, do, lse, delta, causal=True,
                                  scale=None):
    """(dq, dk, dv) of the plain versions, from the saved (q, k, v, lse)
    and delta = sum(do * o, -1) as (B, H, S) fp32."""
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                         scale))


def _check(q, k, v, *rest):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"need q, k, v of one shape (B, S, H, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, _ = q.shape
    for t in rest:
        if t.ndim == 4 and t.shape != q.shape:
            raise ValueError(f"need do of shape {tuple(q.shape)}; got "
                             f"{tuple(t.shape)}")
        if t.ndim != 4 and tuple(t.shape) != (b, h, s):
            raise ValueError(f"need lse and delta of shape {(b, h, s)}; got "
                             f"{tuple(t.shape)}")


def _on_cuda(name, tensors, vectors=()):
    """Raise unless the inputs are what the kernel takes: one CUDA
    device (or ``meta``, which stands for one), bf16 (B, S, H, D)
    tensors and fp32 (B, H, S) vectors, all contiguous."""
    device = tensors[0].device
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {device}")
    if any(t.device != device for t in (*tensors, *vectors)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(
            f"{name}: the kernel takes bf16 q, k, v (and do); got "
            f"{[str(t.dtype) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in vectors):
        raise TypeError(f"{name}: lse and delta must be fp32")
    if not all(t.is_contiguous() for t in (*tensors, *vectors)):
        raise ValueError(f"{name} needs contiguous inputs")


def _launch(name, *args):
    lib = _library()
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = getattr(lib, name)(*ptrs, stream)
    # the kernel refuses (cudaErrorInvalidValue) the shapes its tiling
    # cannot take: see refused() in csrc/flash_attention.cu
    b, s, h, d = args[0].shape
    _build.check(lib, err, f"{name} (B {b}, S {s}, H {h}, D {d})")


def flash_fwd(q, k, v, causal=True, scale=None):
    """Attention of q over k, v, all (B, S, H, D): returns (o in q's
    dtype, lse (B, H, S) fp32), lse = m + log(l) of each row's softmax.
    CPU inputs run :func:`flash_attention_reference`; CUDA inputs launch
    the kernel (bf16, contiguous; head dims the kernel takes are listed in
    its source)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _on_cuda("flash_fwd", (q, k, v))
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.is_meta:
        return traced_launch(flash_fwd, "B1", (q, k, v), (o, lse),
                             flash_flops("fwd", b, s, h, d, causal))
    if o.numel() == 0:
        return o, lse
    _launch("flash_fwd", q, k, v, o, lse, b, s, h, d, int(causal),
            float(_scale(q, scale)))
    count_launch(flash_fwd)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=None):
    """dq from the saved (q, k, v, lse), the output gradient do and
    delta = sum(do * o, -1) (B, H, S) fp32. CPU inputs run
    :func:`flash_bwd_dq_reference`; CUDA inputs launch the kernel."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    _on_cuda("flash_bwd_dq", (q, k, v, do), (lse, delta))
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    if q.is_meta:
        return traced_launch(flash_bwd_dq, "B2", (q, k, v, do, lse, delta),
                             (dq,), flash_flops("dq", b, s, h, d, causal))[0]
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd_dq", q, k, v, do, lse, delta, dq, b, s, h, d,
            int(causal), float(_scale(q, scale)))
    count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=None):
    """(dk, dv) from the same inputs as :func:`flash_bwd_dq`. CPU inputs
    run :func:`flash_bwd_dkv_reference`; CUDA inputs launch the kernel."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       scale)
    _on_cuda("flash_bwd_dkv", (q, k, v, do), (lse, delta))
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.is_meta:
        return traced_launch(flash_bwd_dkv, "B3",
                             (q, k, v, do, lse, delta), (dk, dv),
                             flash_flops("dkv", b, s, h, d, causal))
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv, b, s, h, d,
            int(causal), float(_scale(q, scale)))
    count_launch(flash_bwd_dkv)
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = [_I] * 5 + [ctypes.c_float, _P]  # B, S, H, D, causal, scale, stream


def _library():
    return _build.load("flash_attention", {
        "flash_fwd": [_P] * 5 + _TAIL,
        "flash_bwd_dq": [_P] * 7 + _TAIL,
        "flash_bwd_dkv": [_P] * 8 + _TAIL,
        "flash_smem_bytes": [_I, _I],
    })
