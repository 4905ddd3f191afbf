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


def test_quantize_params_refuses_int4():
    with pytest.raises(NotImplementedError, match="int4"):
        pt_qmm.quantize_params({}, bits=4, device="cpu")
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
