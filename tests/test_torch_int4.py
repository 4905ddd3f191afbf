"""Port int4 weight-only path vs the JAX package's on the CPU: the int4
quantizer, packing and dequant bit for bit, the plain int4 matmul
against the Pallas kernel in interpret mode and against its XLA
lowering, the dispatch's warnings and errors, ``QuantDense4``, loading a
JAX int4 tree, and the paged int4 Llama's logits."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as jax_llama
from sparkdl_tpu.models import quant as jax_quant
from sparkdl_tpu.ops.pallas import quantized_matmul as jax_qmm
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.models import quant as pt_quant
from sparkdl_tpu_torch.models.from_jax import (
    flatten_jax_tree,
    load_jax_params,
)
from sparkdl_tpu_torch.ops import _build
from sparkdl_tpu_torch.ops import quantized_matmul as pt_qmm

torch.set_num_threads(2)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (7 explicit mantissa bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _weights(k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    w[:, 1] = 0.0                     # an all-zero column: scale 1
    # a group whose max is 7/128, so q = w * 128 / 7 hits x.5 quotients
    w[:, 2] = 0.0
    w[:8, 2] = np.array([7, 3.5, -2.5, 0.5, -0.5, 1.5, -7, 6.5]) / 128
    return w


# -- quantization ---------------------------------------------------------

@pytest.mark.parametrize("group", [32, 64])
def test_quantize_int4_bit_identical(group):
    w = _weights(192, 40)
    jq, js = jax_qmm.quantize_int4(w, group=group)
    tq, ts = pt_qmm.quantize_int4(torch.from_numpy(w), group=group)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (96, 40)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (192 // group, 40)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_quantize_int4_refuses_a_group_that_does_not_divide_k():
    with pytest.raises(ValueError, match="divisible"):
        pt_qmm.quantize_int4(torch.zeros(96, 4), group=64)
    with pytest.raises(ValueError, match="divisible"):
        jax_qmm.quantize_int4(np.zeros((96, 4), np.float32), group=64)


def test_unpack_int4_round_trips_every_nibble():
    """Every (low, high) pair of nibble values in -8..7: packed the way
    the quantizer packs, unpacked sign-extended, as JAX unpacks."""
    vals = np.arange(-8, 8, dtype=np.int8)
    low, high = np.meshgrid(vals, vals, indexing="ij")
    q = np.stack([low.reshape(-1), high.reshape(-1)], axis=0)  # (2, 256)
    q = np.tile(q, (3, 1))                                     # (6, 256)
    u = q.astype(np.uint8)
    packed = ((u[0::2] & 0x0F) | ((u[1::2] & 0x0F) << 4)).view(np.int8)
    out = pt_qmm.unpack_int4(torch.from_numpy(packed))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), q)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_qmm.unpack_int4(jnp.asarray(packed))))


def _flat_tree(rng):
    tree = {
        "embed": {"embedding": rng.standard_normal((32, 64)).astype(
            np.float32)},
        "layer_0": {"mlp": {"down_proj": {"kernel": rng.standard_normal(
            (128, 64)).astype(np.float32)}},
            "attn_norm": {"scale": np.ones(64, np.float32)}},
        "lm_head": {"kernel": rng.standard_normal((64, 32)).astype(
            np.float32)},
    }
    return tree, flatten_jax_tree(tree)


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_params_int4_matches_jax_tree(group):
    tree, flat = _flat_tree(np.random.default_rng(group))
    jtree, jsaved = jax_qmm.quantize_params(tree, bits=4, group=group)
    out, saved = pt_qmm.quantize_params(flat, bits=4, group=group,
                                        device="cpu")
    assert saved == jsaved
    jflat = flatten_jax_tree(jtree)
    assert set(out) == set(jflat)
    for name, value in jflat.items():
        assert out[name].numpy().dtype == value.dtype, name
        np.testing.assert_array_equal(out[name].numpy(), value,
                                      err_msg=name)
    assert out["lm_head.kernel_scale4"].shape == (64 // group, 32)


@pytest.mark.parametrize("bits,group", [(8, 64), (4, 32), (4, 64)])
def test_dequantize_params_matches_jax(bits, group):
    tree, flat = _flat_tree(np.random.default_rng(bits + group))
    jtree, _ = jax_qmm.quantize_params(tree, bits=bits, group=group)
    tq, _ = pt_qmm.quantize_params(flat, bits=bits, group=group,
                                   device="cpu")
    for jdtype, tdtype in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
        jdense = flatten_jax_tree(jax.tree.map(
            np.asarray, jax_qmm.dequantize_params(jtree, dtype=jdtype)))
        tdense = pt_qmm.dequantize_params(tq, dtype=tdtype)
        assert set(tdense) == set(jdense) == set(flat)
        for name, value in jdense.items():
            np.testing.assert_array_equal(
                tdense[name].to(torch.float32).numpy(), value,
                err_msg=name)


# -- the int4 matmul --------------------------------------------------------

def _q4_inputs(m, k, n, group, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed, s = jax_qmm.quantize_int4(_weights(k, n, seed), group=group)
    return x, packed, s


def _terms(x, packed, s, group):
    """Σ_k |x_mk| |w_kn| of the dequantized weight: the scale of the
    fp32 summation-order error."""
    w = np.asarray(jax_qmm._dequant_int4(jnp.asarray(packed),
                                         jnp.asarray(s), group))
    return np.abs(x) @ np.abs(w)


@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("m", [1, 5, 130])
def test_quantized_matmul_int4_fp32_matches_pallas(m, group):
    # K = 576 leaves a ragged tail on the kernel's 512-row K tile
    x, packed, s = _q4_inputs(m, 576, 136, group, seed=m + group)
    args = [jnp.asarray(a) for a in (x, packed, s)]
    interp = np.asarray(jax_qmm.quantized_matmul_int4(
        *args, group=group, interpret=True))
    lowered = np.asarray(jax_qmm.quantized_matmul_int4(
        *args, group=group, mode="off"))
    out = pt_qmm.quantized_matmul_int4(
        torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(s),
        group=group)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, 136)
    # the same dequantized weights, fp32 sums in another order
    tol = 1e-5 * _terms(x, packed, s, group)
    for ref in (interp, lowered):
        assert np.all(np.abs(out.numpy() - ref) <= tol), \
            np.abs(out.numpy() - ref).max()


@pytest.mark.parametrize("m", [1, 5, 130])
def test_quantized_matmul_int4_bf16_within_one_ulp(m):
    group = 32
    x, packed, s = _q4_inputs(m, 576, 136, group, seed=20 + m)
    xb = jnp.asarray(x, jnp.bfloat16)
    args = (xb, jnp.asarray(packed), jnp.asarray(s))
    xt = torch.from_numpy(np.asarray(xb).astype(np.float32)).to(
        torch.bfloat16)
    out = pt_qmm.quantized_matmul_int4(xt, torch.from_numpy(packed),
                                       torch.from_numpy(s), group=group)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    terms = _terms(np.asarray(xb).astype(np.float32), packed, s, group)
    for kw in (dict(interpret=True), dict(mode="off")):
        ref = np.asarray(jax_qmm.quantized_matmul_int4(
            *args, group=group, **kw)).astype(np.float32)
        # both round an fp32 sum (up to its order) to bf16: at most one
        # ulp apart, plus the order's 1e-5 of the terms
        tol = _bf16_ulp(ref) + 1e-5 * terms
        assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def _tensor_core_order(x, packed, s, group):
    """A plain fp32 emulation of the CUDA tensor-core kernel's sums (not
    the port's path): each group's exact nibble x x products summed in
    fp32, that partial times the column's fp32 scale, added in fp32 group
    after group."""
    q = pt_qmm.unpack_int4(torch.from_numpy(packed)).numpy().astype(
        np.float32)
    k = q.shape[0]
    acc = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for g in range(k // group):
        rows = slice(g * group, (g + 1) * group)
        part = (x[:, rows].astype(np.float32) @ q[rows]).astype(np.float32)
        acc = (acc + part * s[g][None, :]).astype(np.float32)
    return acc


@pytest.mark.parametrize("m", [8, 256])
def test_tensor_core_sum_order_within_the_chip_tolerance(m):
    """The argument that lets the kernel's tolerance stay unchanged:
    summing s_g (sum of q x over a group) instead of x (q s) moves a
    bf16 output by at most 1e-5 of the sum of |terms| plus one bf16 ulp
    (the chip smoke's phase 2c bound), at a decode (M 8) and a prefill
    (M 256) row count. Every nibble value appears, one column is all
    -8, and x and the scales are bf16-exact, as on the card."""
    k, n, group = 512, 48, 64
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).bfloat16()
    nib = rng.integers(-8, 8, (k, n)).astype(np.int8)
    nib[:16, 0] = np.arange(-8, 8)         # every value in one column
    nib[:, 1] = -8                         # an all-(-8) column
    u = nib.astype(np.uint8)
    packed = ((u[0::2] & 0x0F) | ((u[1::2] & 0x0F) << 4)).view(np.int8)
    s = torch.from_numpy((rng.random((k // group, n)) * 1e-2 + 1e-4)
                         .astype(np.float32)).bfloat16().float().numpy()
    ref = pt_qmm.quantized_matmul_int4_reference(
        x, torch.from_numpy(packed), torch.from_numpy(s), group)
    assert ref.dtype == torch.bfloat16
    ref = ref.float().numpy()
    xf = x.float().numpy()
    got = torch.from_numpy(_tensor_core_order(xf, packed, s, group)) \
        .bfloat16().float().numpy()
    tol = 1e-5 * _terms(xf, packed, s, group) + _bf16_ulp(ref)
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()
    # the fp32 sums themselves differ by the order alone
    exact = (xf.astype(np.float64) @ (nib.astype(np.float64)
                                      * np.repeat(s, group, 0)))
    assert np.all(np.abs(_tensor_core_order(xf, packed, s, group) - exact)
                  <= 1e-5 * _terms(xf, packed, s, group))


def test_quantized_matmul_int4_group_mismatch_warns_like_jax():
    """A group that does not match the scale rows: both warn and compute
    with the group the shapes imply, the same numbers as that group."""
    x, packed, s = _q4_inputs(3, 128, 24, 32, seed=5)
    with pytest.warns(RuntimeWarning, match="inferred group=32"):
        out = pt_qmm.quantized_matmul_int4(
            torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(s), group=64)
    with pytest.warns(RuntimeWarning, match="inferred group=32"):
        ref = np.asarray(jax_qmm.quantized_matmul_int4(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), group=64,
            mode="off"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        same = pt_qmm.quantized_matmul_int4(
            torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(s), group=32)
    assert torch.equal(out, same)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_quantized_matmul_int4_shape_errors_like_jax():
    x, packed, s = _q4_inputs(2, 128, 16, 32, seed=6)
    xt, pt, st = (torch.from_numpy(a) for a in (x, packed, s))
    with pytest.raises(ValueError, match="K//2"):
        pt_qmm.quantized_matmul_int4(xt[:, :64], pt, st, group=32)
    with pytest.raises(ValueError, match="K//2"):
        jax_qmm.quantized_matmul_int4(jnp.asarray(x[:, :64]),
                                      jnp.asarray(packed), jnp.asarray(s))
    # 3 scale rows cannot cover K=128 under any group
    with pytest.raises(ValueError, match="cannot cover"):
        pt_qmm.quantized_matmul_int4(xt, pt, st[:3], group=32)
    with pytest.raises(ValueError, match="cannot cover"):
        jax_qmm.quantized_matmul_int4(jnp.asarray(x), jnp.asarray(packed),
                                      jnp.asarray(s[:3]), group=32)
    with pytest.raises(ValueError, match="scales shape"):
        pt_qmm.quantized_matmul_int4(xt, pt, st[:, :-1], group=32)


def test_int4_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_kernel)
    n = pt_qmm.quantized_matmul_int4.launches
    x, packed, s = (torch.from_numpy(a)
                    for a in _q4_inputs(4, 64, 8, 32, seed=7))
    out = pt_qmm.quantized_matmul_int4(x, packed, s, group=32)
    assert torch.equal(
        out, pt_qmm.quantized_matmul_int4_reference(x, packed, s, 32))
    assert pt_qmm.quantized_matmul_int4.launches == n


# -- QuantDense4, loading and the model -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dense4_matches_jax(dtype):
    group, d_in, feat = 32, 128, 48
    rng = np.random.default_rng(8)
    packed, s = jax_qmm.quantize_int4(_weights(d_in, feat, 8), group=group)
    x = rng.standard_normal((2, 3, d_in)).astype(np.float32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jax_quant.QuantDense4(feat, dtype=jdtype, group=group,
                                 kernel="off")
    ref = np.asarray(jmod.apply(
        {"params": {"kernel_q4": jnp.asarray(packed),
                    "kernel_scale4": jnp.asarray(s)}},
        jnp.asarray(x, jdtype))).astype(np.float32)
    tmod = pt_quant.QuantDense4(d_in, feat, tdtype, "cpu", group=group)
    with torch.no_grad():
        tmod.kernel_q4.copy_(torch.from_numpy(packed))
        tmod.kernel_scale4.copy_(torch.from_numpy(s))
        out = tmod(torch.from_numpy(x).to(tdtype))
    assert out.dtype == tdtype and tuple(out.shape) == (2, 3, feat)
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref) + 1e-4)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = jax_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    # spread the weights so int4 quantization is non-trivial
    return jax.tree.map(lambda p: p * 1.7 if p.ndim == 2 else p, params)


def test_jax_int4_tree_loads_untouched(jax_params):
    tree = jax.tree.map(np.asarray, jax_quant.quantize_llama_params(
        jax_params, bits=4, group=32))
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32, quant="int4",
                                    quant_group=32)
    model = load_jax_params(pt_llama.Llama(cfg, device="cpu"), tree)
    state = model.state_dict()
    for name, value in flatten_jax_tree(tree).items():
        if name.endswith(("kernel_q4", "kernel_scale4")):
            assert state[name].dtype == (torch.int8 if value.dtype == np.int8
                                         else torch.float32), name
            np.testing.assert_array_equal(state[name].numpy(), value,
                                          err_msg=name)
    assert isinstance(model.lm_head, pt_quant.QuantDense4)
    assert tuple(model.layers[0].mlp.down_proj.kernel_scale4.shape) == (
        128 // 32, 64)


def test_quantize_llama_params_int4_matches_jax(jax_params):
    cfg = pt_llama.LlamaConfig.tiny(dtype=torch.float32)
    dense = load_jax_params(pt_llama.Llama(cfg, device="cpu"),
                            jax.tree.map(np.asarray, jax_params))
    q = pt_quant.quantize_llama_params(dense.state_dict(), bits=4, group=32,
                                       device="cpu")
    jq = flatten_jax_tree(jax.tree.map(np.asarray,
                                       jax_quant.quantize_llama_params(
                                           jax_params, bits=4, group=32)))
    assert set(q) == set(jq)
    for name, value in jq.items():
        np.testing.assert_array_equal(q[name].numpy(), value, err_msg=name)
    model = pt_llama.Llama.from_params(
        dataclasses.replace(cfg, quant="int4", quant_group=32), q,
        device="cpu")
    assert (model.layers[1].attn.q_proj.kernel_q4.data_ptr()
            == q["layers.1.attn.q_proj.kernel_q4"].data_ptr())


@pytest.mark.parametrize("group", [32, 64])
def test_paged_int4_model_logits_match_jax(jax_params, group):
    """Prefill 7 tokens into two rows' pages, then 3 single-token steps,
    at quant_group 32 (K = 64 spans 2 groups, 128 spans 4) and 64."""
    params = jax_quant.quantize_llama_params(jax_params, bits=4,
                                             group=group)
    page, n_pages, max_len = 8, 9, 32
    jcfg = jax_llama.LlamaConfig.tiny(
        dtype=jnp.float32, decode=True, page_size=page, n_pages=n_pages,
        max_cache_len=max_len, paged_kernel="off", quant_kernel="off",
        quant="int4", quant_group=group)
    tcfg = pt_llama.LlamaConfig.tiny(
        dtype=torch.float32, decode=True, page_size=page, n_pages=n_pages,
        max_cache_len=max_len, quant="int4", quant_group=group)
    tables = np.array([[3, 1, 4, 0], [2, 8, 5, 0]], np.int32)
    rng = np.random.default_rng(group)
    jm = jax_llama.Llama(jcfg)
    cache = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
                    positions=jnp.zeros((2, 1), jnp.int32),
                    block_tables=jnp.asarray(tables))["cache"]
    tm = load_jax_params(pt_llama.Llama(tcfg, device="cpu"),
                         jax.tree.map(np.asarray, params))
    tcache = tm.init_cache()
    steps = [(rng.integers(0, 256, (2, 7)),
              np.broadcast_to(np.arange(7), (2, 7)))]
    steps += [(rng.integers(0, 256, (2, 1)), np.full((2, 1), 7 + i))
              for i in range(3)]
    for toks, pos in steps:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        ref, st = jm.apply({"params": params, "cache": cache},
                           jnp.asarray(toks), positions=jnp.asarray(pos),
                           block_tables=jnp.asarray(tables),
                           mutable=["cache"])
        cache = st["cache"]
        with torch.no_grad():
            out = tm(torch.from_numpy(toks), torch.from_numpy(pos),
                     torch.from_numpy(tables), tcache)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_int4_config_fields():
    cfg = pt_llama.LlamaConfig.llama3_8b(quant="int4")
    ref = jax_llama.LlamaConfig.llama3_8b(quant="int4")
    assert cfg.quant_group == ref.quant_group == 64
    with pytest.raises(TypeError, match="quant_kernel"):
        pt_llama.LlamaConfig.tiny(quant="int4", quant_kernel="off")
    with pytest.raises(ValueError, match="requires lora_rank=0"):
        pt_llama.LlamaConfig.tiny(quant="int4", lora_rank=4)
