"""Paged-attention decode: attend a single-step query over a POOLED
paged KV cache through per-row block tables, reading only the pages a
row owns.

Counterpart of ``sparkdl_tpu/ops/pallas/paged_attention.py``: the
single-device call and its tensor-parallel binding
(:func:`paged_attention_decode_sharded`, one call a rank on its own kv
heads). The pool layout is the serving engine's: page-major (n_pages,
page, Hkv, D), page 0 the dump page for padding junk.
``paged_attention_decode`` takes its path from the device of its
inputs: CPU tensors run :func:`paged_attention_decode_reference`, CUDA
tensors launch the hand-written kernel in ``csrc/paged_attention.cu``
or raise, and ``meta`` tensors (a traced step) take the kernel's checks
and return its empty output with one kernel event.
"""

import ctypes

import torch

from sparkdl_tpu_torch.ops import _build
from sparkdl_tpu_torch.ops._dispatch import (
    count_launch,
    launch_on,
    sm_count,
    traced_launch,
)

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.bfloat16: "paged_decode_bf16",
                  torch.float32: "paged_decode_f32"}

# split plans by (B, H, Hkv, D, page, max_pages, element bytes, device
# index), asked of the library once each
_PLANS = {}


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
    it). bf16 pools with D 64, 128 or 256, H / Hkv <= 8 and pages of a
    multiple of 16 rows take the split kernel: the pages of a row split
    over blocks (the table's width decides how many; ``lens`` is never
    read on the host), each on the tensor cores, then a merge pass in
    logsumexp form, with an fp32 workspace of B * H * splits * (D + 2)
    allocated here. fp32 pools and other bf16 shapes take the
    page-serial kernel.
    """
    _check(q, k_pool, v_pool, tables, lens)
    if q.device.type == "cpu":
        return paged_attention_decode_reference(q, k_pool, v_pool, tables,
                                                lens, scale)
    if q.device.type not in ("cuda", "meta"):
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
    if q.is_meta:
        # lens is data: the work counted is what the tables can hold
        visible = b * tables.shape[1] * page
        return traced_launch(paged_attention_decode, "B4", tensors, (out,),
                             visible * h * d * 2 * 2)[0]
    if b == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    lib = _library()
    splits, per = _split_plan(q, k_pool, tables)
    # the split kernel's partials (o, m, l of each split), merged in order
    work = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 0 else None)
    err = launch_on(q.device, getattr(lib, _KERNEL_DTYPES[q.dtype]),
                    q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                    work.data_ptr() if work is not None else None,
                    b, h, hkv, d, page, tables.shape[1], splits, per,
                    float(scale))
    # the kernel refuses (cudaErrorInvalidValue) the shapes its tiling
    # cannot take: see launch_serial() and launch_split() in
    # csrc/paged_attention.cu
    _build.check(lib, err, f"paged_attention_decode (H {h}, Hkv {hkv}, "
                 f"D {d}, page {page}, {q.dtype})")
    count_launch(paged_attention_decode)
    return out


paged_attention_decode.launches = 0


def paged_attention_decode_sharded(mesh, *, axis_name="model", scale=None,
                                   n_heads=None, n_kv_heads=None):
    """Bind the paged decode to a tensor-parallel mesh: each rank's pool
    holds its own kv heads (the serving engine's cache under ``mesh``)
    and each rank runs the decode on them. Every kv head's GQA query
    group lives on the same rank, so the binding runs no collective;
    the o_proj that follows does the sum.

    Returns ``f(q, k_pool, v_pool, tables, lens)`` on this rank's
    LOCAL tensors: q (B, H/m, D), pools (n_pages, page, Hkv/m, D),
    tables and lens whole, m the size of ``axis_name``. ``n_heads`` and
    ``n_kv_heads`` (the model's, when given) check that the heads are
    this rank's share. CUDA tensors launch the kernel
    (:func:`paged_attention_decode`), CPU ones run its plain version."""
    size = mesh.axis_size(axis_name)

    def local_fn(q, k_pool, v_pool, tables, lens):
        for what, total, local in (("query", n_heads, q.shape[1]),
                                   ("kv", n_kv_heads, k_pool.shape[2])):
            if total is not None and local * size != total:
                raise ValueError(
                    f"{local} local {what} heads on a {axis_name} axis of "
                    f"{size}; the model has {total}")
        # looked up at call time: the module attribute is the call
        return paged_attention_decode(q, k_pool, v_pool, tables, lens,
                                      scale=scale)

    return local_fn


def _split_plan(q, k_pool, tables):
    """(splits, pages a split) of a CUDA call: the C plan's choice for
    the call's shapes, asked of the library once per shape and device;
    (0, 0) on the page-serial route. Only shapes decide it, never the
    lengths."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pool.shape
    key = (b, h, hkv, d, page, tables.shape[1], q.element_size(),
           q.device.index)
    plan = _PLANS.get(key)
    if plan is None:
        lib = _library()
        splits, per = ctypes.c_int(), ctypes.c_int()
        _build.check(lib, lib.paged_decode_plan(
            *key[:-1], sm_count(q.device), ctypes.byref(splits),
            ctypes.byref(per)), "paged_attention_decode plan")
        plan = _PLANS[key] = (splits.value, per.value)
    return plan


# q, k, v, tables, lens, out, work; B, H, Hkv, D, page, max_pages,
# splits, pages a split; scale; stream
_SIGNATURE = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
              + [ctypes.c_float, ctypes.c_void_p])
# B, H, Hkv, D, page, max_pages, element bytes, SMs; splits, pages a
# split out
_PLAN_SIGNATURE = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 2


def _library():
    signatures = {name: _SIGNATURE for name in _KERNEL_DTYPES.values()}
    signatures["paged_decode_plan"] = _PLAN_SIGNATURE
    return _build.load("paged_attention", signatures)
