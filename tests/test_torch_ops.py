"""Port ops vs the JAX package's kernels on the CPU: the int8 quantizer
bit for bit, the plain quant matmul and paged decode attention against
the Pallas kernels run in interpret mode, at small shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.pallas import paged_attention as jax_paged
from sparkdl_tpu.ops.pallas import quantized_matmul as jax_qmm
from sparkdl_tpu_torch.ops import _build, _dispatch
from sparkdl_tpu_torch.ops import paged_attention as pt_paged
from sparkdl_tpu_torch.ops import quantized_matmul as pt_qmm

torch.set_num_threads(2)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (7 explicit mantissa bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# -- quantization -------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48), (130, 7)])
def test_quantize_int8_bit_identical(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    w[:, 1] = 0.0                      # an all-zero column: scale 1
    # scale 1/128 exactly; x.5 quotients hit round-half-to-even
    w[:, 2] = 2.5 / 128
    w[:4, 2] = [127 / 128, 3.5 / 128, -2.5 / 128, -0.5 / 128]
    jq, js = jax_qmm.quantize_int8(w)
    tq, ts = pt_qmm.quantize_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_quantize_params_matches_jax_tree():
    rng = np.random.default_rng(1)
    tree = {
        "embed": {"embedding": rng.standard_normal((32, 16)).astype(
            np.float32)},
        "layer_0": {"attn": {"q_proj": {"kernel": rng.standard_normal(
            (16, 16)).astype(np.float32)}},
            "attn_norm": {"scale": np.ones(16, np.float32)}},
        "lm_head": {"kernel": rng.standard_normal((16, 32)).astype(
            np.float32)},
    }
    jtree, jsaved = jax_qmm.quantize_params(tree, bits=8)
    flat = {"embed.embedding": tree["embed"]["embedding"],
            "layers.0.attn.q_proj.kernel":
                tree["layer_0"]["attn"]["q_proj"]["kernel"],
            "layers.0.attn_norm.scale": tree["layer_0"]["attn_norm"]["scale"],
            "lm_head.kernel": tree["lm_head"]["kernel"]}
    out, saved = pt_qmm.quantize_params(flat, bits=8, device="cpu")
    assert saved == jsaved
    q = jtree["layer_0"]["attn"]["q_proj"]
    np.testing.assert_array_equal(
        out["layers.0.attn.q_proj.kernel_q"].numpy(), q["kernel_q"])
    np.testing.assert_array_equal(
        out["layers.0.attn.q_proj.kernel_scale"].numpy(), q["kernel_scale"])
    np.testing.assert_array_equal(
        out["lm_head.kernel_q"].numpy(), jtree["lm_head"]["kernel_q"])
    # non-targets pass through untouched
    np.testing.assert_array_equal(out["embed.embedding"].numpy(),
                                  tree["embed"]["embedding"])
    assert "layers.0.attn.q_proj.kernel" not in out


def test_quantize_params_refuses_unknown_bits():
    with pytest.raises(ValueError, match="bits"):
        pt_qmm.quantize_params({}, bits=3, device="cpu")


# -- quantized matmul ---------------------------------------------------

def _qmm_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q, s = jax_qmm.quantize_int8(
        rng.standard_normal((k, n)).astype(np.float32))
    return x, w_q, s


@pytest.mark.parametrize("m", [1, 3, 17])
def test_quantized_matmul_fp32_matches_pallas(m):
    # K = 520 leaves a ragged tail on the kernel's 512-row K tile
    x, w_q, s = _qmm_inputs(m, 520, 136, seed=m)
    ref = np.asarray(jax_qmm.quantized_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s), interpret=True))
    out = pt_qmm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                                  torch.from_numpy(s))
    assert out.dtype == torch.float32 and out.shape == (m, 136)
    # dequant-then-sum vs sum-then-scale: fp32 rounding order only
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("m", [1, 3, 17])
def test_quantized_matmul_bf16_within_one_ulp(m):
    x, w_q, s = _qmm_inputs(m, 520, 136, seed=10 + m)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_qmm.quantized_matmul(
        xb, jnp.asarray(w_q), jnp.asarray(s), interpret=True)
    ).astype(np.float32)
    xt = torch.from_numpy(np.asarray(xb).astype(np.float32)).to(
        torch.bfloat16)
    out = pt_qmm.quantized_matmul(xt, torch.from_numpy(w_q),
                                  torch.from_numpy(s))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    # both round the same fp32 sum (up to its order) to bf16: at most
    # one ulp apart, or 1e-5 of the scale where cancellation nears 0
    tol = np.maximum(_bf16_ulp(ref), 1e-5 * np.abs(ref).max())
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def test_quantized_matmul_misshaped_scales_raise_in_both():
    x, w_q, s = _qmm_inputs(2, 16, 8)
    with pytest.raises(ValueError, match="scales shape"):
        jax_qmm.quantized_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                 jnp.asarray(s[:-1]), interpret=True)
    with pytest.raises(ValueError, match="scales shape"):
        pt_qmm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                                torch.from_numpy(s[:-1]))
    with pytest.raises(ValueError, match="w_q"):
        pt_qmm.quantized_matmul(torch.from_numpy(x[:, :5]),
                                torch.from_numpy(w_q), torch.from_numpy(s))


# -- paged attention ----------------------------------------------------

def _paged_inputs(rng, b, hkv, rep, d, page, ppr):
    n_pages = b * ppr + 1
    q = rng.standard_normal((b, hkv * rep, d)).astype(np.float32)
    k_pool = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    # the dump page holds junk that must never be attended
    k_pool[0] = 1e4
    v_pool[0] = -1e4
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, ppr + 2), np.int32)   # padded with page 0
    for i in range(b):
        tables[i, :ppr] = perm[i * ppr:(i + 1) * ppr]
    return q, k_pool, v_pool, tables


@pytest.mark.parametrize("rep", [1, 2])
def test_paged_attention_matches_pallas(rep):
    rng = np.random.default_rng(rep)
    b, hkv, d, page, ppr = 4, 2, 16, 8, 3
    q, k_pool, v_pool, tables = _paged_inputs(rng, b, hkv, rep, d, page, ppr)
    # ragged lengths: one token, a page boundary, mid-page, full
    lens = np.array([1, page, page + 3, page * ppr], np.int32)
    ref = np.asarray(jax_paged.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True))
    out = pt_paged.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables),
        torch.from_numpy(lens))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_paged_attention_scale_argument():
    rng = np.random.default_rng(5)
    q, k_pool, v_pool, tables = _paged_inputs(rng, 2, 2, 2, 16, 8, 2)
    lens = np.array([5, 11], np.int32)
    args = [jnp.asarray(a) for a in (q, k_pool, v_pool, tables, lens)]
    ref = np.asarray(jax_paged.paged_attention_decode(
        *args, scale=0.5, interpret=True))
    out = pt_paged.paged_attention_decode(
        *[torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, lens)],
        scale=0.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_paged_attention_rejects_bad_shapes():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(3, 8, 3, 16)        # 4 heads over 3 kv heads
    with pytest.raises(ValueError, match="multiple"):
        pt_paged.paged_attention_decode(q, pool, pool,
                                        torch.zeros(2, 1, dtype=torch.int32),
                                        torch.ones(2, dtype=torch.int32))
    pool = torch.zeros(3, 8, 2, 16)
    with pytest.raises(ValueError, match="tables"):
        pt_paged.paged_attention_decode(q, pool, pool,
                                        torch.zeros(3, 1, dtype=torch.int32),
                                        torch.ones(2, dtype=torch.int32))


# -- the tensor-core kernels' arithmetic, emulated -----------------------
#
# Plain emulations of the order in which the CUDA kernels sum (not the
# port's path), held against the plain versions within the chip smoke's
# phase-2 tolerances: the argument that lets those tolerances stay as
# they were when the kernels moved to the tensor cores.

def _int8_to_bf16_bits(b):
    """The kernels' int8 -> bf16 route in numpy bit operations: flip the
    sign bit (u = b + 128), place u under the exponent of 2^23, subtract
    2^23 + 128 in fp32, keep the float's high 16 bits."""
    u = (b.astype(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388736.0)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def test_every_int8_round_trips_exactly_through_bf16():
    v = np.arange(-128, 128).astype(np.int8)
    bits = _int8_to_bf16_bits(v)
    np.testing.assert_array_equal(
        (bits.astype(np.uint32) << 16).view(np.float32), v.astype(np.float32))
    # the same bits as torch's own rounding of the value to bf16
    tb = torch.from_numpy(v.astype(np.float32)).bfloat16()
    np.testing.assert_array_equal(bits, tb.view(torch.int16).numpy()
                                  .view(np.uint16))


def _int8_tensor_core_order(x, w_q, s, interleave):
    """fp32 sums of exact bf16 x times int8 products, 16 K rows (one
    k16 step) at a time: each step's 16 exact products summed and
    rounded to fp32, the steps added in fp32 into ``interleave``
    accumulators (step i into i % interleave: the decode GEMV's 8 warps),
    those added in order, the fp32 scale applied once at the end."""
    m, k = x.shape
    accs = np.zeros((interleave, m, w_q.shape[1]), np.float32)
    for i, k0 in enumerate(range(0, k, 16)):
        part = (x[:, k0:k0 + 16].astype(np.float64)
                @ w_q[k0:k0 + 16].astype(np.float64)).astype(np.float32)
        accs[i % interleave] = (accs[i % interleave] + part).astype(
            np.float32)
    acc = accs[0]
    for a in accs[1:]:
        acc = (acc + a).astype(np.float32)
    return (acc * s[None, :]).astype(np.float32)


@pytest.mark.parametrize("m,interleave", [(8, 8), (8, 1), (512, 1)])
def test_int8_tensor_core_order_within_the_chip_tolerance(m, interleave):
    """B5 on the tensor cores sums exact bf16 x int8 products in fp32 k16
    steps (the decode GEMV in 8 interleaved warp sums, the prefill GEMM
    in one) and scales once: a bf16 output within 1e-5 of the sum of
    |terms| plus one bf16 ulp of the plain version (phase 2's bound) at
    a decode (M 8) and a prefill (M 512) row count. -128, +-127 and an
    all-(-128) column appear; x is bf16, the scales any fp32."""
    k, n = 512, 48
    rng = np.random.default_rng(m + interleave)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).bfloat16()
    w_q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    w_q[:3, 0] = [-128, 127, -127]
    w_q[:, 1] = -128                       # an all-(-128) column
    s = (rng.random(n) * 1e-2 + 1e-4).astype(np.float32)
    ref = pt_qmm.quantized_matmul_reference(x, torch.from_numpy(w_q),
                                            torch.from_numpy(s))
    assert ref.dtype == torch.bfloat16
    ref = ref.float().numpy()
    xf = x.float().numpy()
    emulated = _int8_tensor_core_order(xf, w_q, s, interleave)
    got = torch.from_numpy(emulated).bfloat16().float().numpy()
    terms = np.abs(xf) @ (np.abs(w_q.astype(np.float32)) * s[None, :])
    tol = 1e-5 * terms + _bf16_ulp(ref)
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()
    # the fp32 sums themselves differ from the exact sum by the order
    exact = (xf.astype(np.float64) @ w_q.astype(np.float64)) * s[None, :]
    assert np.all(np.abs(emulated - exact) <= 1e-5 * terms)


def _paged_split_merge(q, k_pool, v_pool, tables, lens, pps, round_p,
                       scale=None):
    """B4's split kernel and merge pass in numpy: each split of ``pps``
    pages takes its max m (scores in log2 units), p = exp2(s - m), l =
    sum p and o = p v in fp32 (p rounded to bf16 first when
    ``round_p``), a split past the row's length is empty (m = -1e30,
    l = 0); the splits merge in order, in logsumexp form, skipping the
    empty ones; out = sum w o / max(sum w l, 1e-30)."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pool.shape
    rep = h // hkv
    scale = d ** -0.5 if scale is None else scale
    c = np.float32(scale * np.log2(np.e))
    n_splits = -(-tables.shape[1] // pps)
    out = np.zeros((b, h, d), np.float32)
    for bi in range(b):
        used = -(-int(lens[bi]) // page)
        for hq in range(h):
            parts = []
            for sp in range(n_splits):
                n_pg = min(pps, used - sp * pps)
                if n_pg <= 0:
                    parts.append((np.float32(-1e30), np.float32(0), None))
                    continue
                pages = tables[bi, sp * pps:sp * pps + n_pg]
                keys = k_pool[pages, :, hq // rep].reshape(-1, d)
                vals = v_pool[pages, :, hq // rep].reshape(-1, d)
                sc = (keys.astype(np.float32) @ q[bi, hq].astype(
                    np.float32)).astype(np.float32) * c
                pos = sp * pps * page + np.arange(len(sc))
                sc = np.where(pos < lens[bi], sc, np.float32(-1e30))
                mx = sc.max()
                p = np.exp2(sc - mx).astype(np.float32)
                pv = (torch.from_numpy(p).bfloat16().float().numpy()
                      if round_p else p)
                parts.append((mx, p.sum(dtype=np.float32),
                              (pv @ vals.astype(np.float32)).astype(
                                  np.float32)))
            mx = max((m for m, l_, _ in parts if l_ > 0),
                     default=np.float32(-1e30))
            acc = np.zeros(d, np.float32)
            total = np.float32(0)
            for m, l_, o in parts:
                if l_ > 0:
                    w = np.exp2(np.float32(m - mx))
                    acc = (acc + w * o).astype(np.float32)
                    total = np.float32(total + w * l_)
            out[bi, hq] = acc / max(total, np.float32(1e-30))
    return out


def _split_case(pps, dtype_round):
    """Rows at B4's boundaries for ``pps`` pages a split of 16 rows: one
    token (every later split empty), a length ending on a split
    boundary, one past it, a full row, and an inactive row whose every
    table entry is the dump page 0 (frozen length 5)."""
    rng = np.random.default_rng(10 + pps)
    b, hkv, rep, d, page, ppr = 5, 2, 4, 32, 16, 6
    q, k_pool, v_pool, tables = _paged_inputs(rng, b, hkv, rep, d, page,
                                              ppr)
    span = pps * page
    lens = np.array([1, span, span + 1, page * ppr, 5], np.int32)
    tables[-1] = 0
    if dtype_round:  # bf16-exact inputs, as the card's pools hold
        q, k_pool, v_pool = (torch.from_numpy(a).bfloat16().float().numpy()
                             for a in (q, k_pool, v_pool))
    return q, k_pool, v_pool, tables, lens


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_paged_split_merge_order_within_the_chip_tolerance(pps):
    """B4's split-and-merge order with p rounded to bf16 before P.V
    against the plain version in bf16, within phase 2's tolerance (2^-8
    of the probability-weighted |v| plus one bf16 ulp plus 1e-5)."""
    q, k_pool, v_pool, tables, lens = _split_case(pps, True)
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool)]
    ref = pt_paged.paged_attention_decode_reference(
        *(a.bfloat16() for a in args), torch.from_numpy(tables),
        torch.from_numpy(lens)).float().numpy()
    weighted = pt_paged.paged_attention_decode_reference(
        args[0], args[1], args[2].abs(), torch.from_numpy(tables),
        torch.from_numpy(lens)).numpy()
    got = torch.from_numpy(_paged_split_merge(
        q, k_pool, v_pool, tables, lens, pps, True)).bfloat16().float() \
        .numpy()
    assert np.isfinite(got).all()
    tol = 2.0 ** -8 * weighted + _bf16_ulp(ref) + 1e-5
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_paged_split_merge_order_matches_pallas(pps):
    """The same order in fp32 (p not rounded) against the Pallas kernel
    in interpret mode, at the tolerance of
    test_paged_attention_matches_pallas."""
    q, k_pool, v_pool, tables, lens = _split_case(pps, False)
    ref = np.asarray(jax_paged.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True))
    got = _paged_split_merge(q, k_pool, v_pool, tables, lens, pps, False)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# -- dispatch and build helpers ------------------------------------------

def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel: the library is not even
    loaded, and the launch counters stay put."""
    def no_kernel(*a, **k):
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_kernel)
    n_qmm = pt_qmm.quantized_matmul.launches
    n_pa = pt_paged.paged_attention_decode.launches
    x, w_q, s = _qmm_inputs(2, 16, 8)
    out = pt_qmm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                                  torch.from_numpy(s))
    ref = pt_qmm.quantized_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(s))
    assert torch.equal(out, ref)
    rng = np.random.default_rng(0)
    q, k_pool, v_pool, tables = _paged_inputs(rng, 2, 2, 2, 16, 8, 2)
    args = [torch.from_numpy(a) for a in
            (q, k_pool, v_pool, tables, np.array([3, 9], np.int32))]
    assert torch.equal(pt_paged.paged_attention_decode(*args),
                       pt_paged.paged_attention_decode_reference(*args))
    assert pt_qmm.quantized_matmul.launches == n_qmm
    assert pt_paged.paged_attention_decode.launches == n_pa


def test_build_cache_key_follows_the_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    assert _build.sources() == ["k"]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pad_to_matches_jax(axis):
    from sparkdl_tpu.ops._dispatch import pad_to as jax_pad_to

    x = np.arange(15, dtype=np.float32).reshape(3, 5)
    jp, jpad = jax_pad_to(jnp.asarray(x), 4, axis)
    tp, tpad = _dispatch.pad_to(torch.from_numpy(x), 4, axis)
    assert tpad == jpad
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("size", [1, 8, 100, 128, 4096])
def test_block_for_matches_jax(size):
    from sparkdl_tpu.ops._dispatch import block_for as jax_block_for

    assert _dispatch.block_for(size) == jax_block_for(size)
    assert _dispatch.block_for(size, tile=64, floor=16) == jax_block_for(
        size, tile=64, floor=16)
