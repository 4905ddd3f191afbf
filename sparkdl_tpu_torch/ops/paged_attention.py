"""Paged-attention decode: attend a single-step query over a POOLED
paged KV cache through per-row block tables, reading only the pages a
row owns.

Counterpart of ``sparkdl_tpu/ops/pallas/paged_attention.py`` (the
single-device binding; the tensor-parallel one is not ported yet). The
pool layout is the serving engine's: page-major (n_pages, page, Hkv, D),
page 0 the dump page for padding junk. ``paged_attention_decode`` takes
its path from the device of its inputs: CPU tensors run
:func:`paged_attention_decode_reference`, CUDA tensors launch the
hand-written kernel in ``csrc/paged_attention.cu`` or raise.
"""

import ctypes

import torch

from sparkdl_tpu_torch.ops import _build

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.bfloat16: "paged_decode_bf16",
                  torch.float32: "paged_decode_f32"}


def paged_attention_decode_reference(q, k_pool, v_pool, tables, lens,
                                     scale=None):
    """The plain version, the gather path of the JAX model's paged
    branch: gather each row's pages into its logical view, mask
    positions >= lens, softmax in fp32 over input-dtype scores, probs
    cast to v's dtype for the PV product (fp32 accumulation)."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pool.shape
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    tables = tables.long()
    length = tables.shape[1] * page
    k = k_pool[tables].reshape(b, length, hkv, d)
    v = v_pool[tables].reshape(b, length, hkv, d)
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,blgd->bgrl", qg, k.float()) * scale
    mask = (torch.arange(length, device=q.device)[None, :]
            < lens.long()[:, None])                       # (b, L)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bgrl,blgd->bgrd", probs.float(), v.float())
    return o.reshape(b, h, d).to(q.dtype)


def _check(q, k_pool, v_pool, tables, lens):
    if q.ndim != 3 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"need q (B, H, D) and pools (n_pages, page, Hkv, D); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}")
    b, h, d = q.shape
    _, _, hkv, dk = k_pool.shape
    if dk != d or h % hkv:
        raise ValueError(
            f"head dims disagree or H={h} is not a multiple of Hkv={hkv}")
    if tables.ndim != 2 or tables.shape[0] != b or tuple(lens.shape) != (b,):
        raise ValueError(
            f"need tables (B, max_pages) and lens (B,) for B={b}; got "
            f"{tuple(tables.shape)} and {tuple(lens.shape)}")


def paged_attention_decode(q, k_pool, v_pool, tables, lens, scale=None):
    """One decode step over the paged pool.

    Args:
      q: (B, H, D) this step's queries, H = Hkv * rep (GQA: query head
        i reads kv head i // rep).
      k_pool, v_pool: (n_pages, page, Hkv, D) pooled physical cache.
      tables: (B, max_pages) int32 block tables; entries past a row's
        length may point anywhere valid (the dump page 0).
      lens: (B,) int32 visible tokens per row (position + 1).
    Returns: (B, H, D) in q's dtype.

    CPU inputs run the plain version; CUDA inputs launch the kernel,
    which takes q and the pools in bf16 or fp32 (one dtype), int32
    tables and lens, all contiguous on one card, and raises otherwise
    (also on a tile the kernel cannot hold: the C entry point refuses
    it).
    """
    _check(q, k_pool, v_pool, tables, lens)
    if q.device.type == "cpu":
        return paged_attention_decode_reference(q, k_pool, v_pool, tables,
                                                lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = (q, k_pool, v_pool, tables, lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            f"q/k_pool/v_pool dtypes {q.dtype}/{k_pool.dtype}/"
            f"{v_pool.dtype}: the kernel takes one of bf16 or fp32")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("tables and lens must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_decode needs contiguous inputs")
    b, h, d = q.shape
    _, page, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    lib = _library()
    fn = getattr(lib, _KERNEL_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 b, h, hkv, d, page, tables.shape[1], float(scale), stream)
    # the kernel refuses (cudaErrorInvalidValue) the shapes its tiling
    # cannot take: see launch() in csrc/paged_attention.cu
    _build.check(lib, err, f"paged_attention_decode (H {h}, Hkv {hkv}, "
                 f"D {d}, page {page}, {q.dtype})")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0

_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
              + [ctypes.c_float, ctypes.c_void_p])


def _library():
    return _build.load("paged_attention",
                       {name: _SIGNATURE for name in _KERNEL_DTYPES.values()})
