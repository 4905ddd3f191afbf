"""Port flash attention vs the JAX package on the CPU: the plain versions
of the three kernels against the Pallas kernels run in interpret mode,
gradients through ``flash_attention`` against ``jax.grad``, the dense
oracle, and the wrappers' refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import attention as jax_attention
from sparkdl_tpu.ops.pallas import flash_attention as jax_flash
from sparkdl_tpu.parallel import ring_attention as jax_ring
from sparkdl_tpu_torch.ops import attention as pt_attention
from sparkdl_tpu_torch.ops import flash_attention as pt_flash
from sparkdl_tpu_torch.parallel import ring_attention as pt_ring

torch.set_num_threads(2)

B, H = 2, 2


def _qkv(seed, s, d, b=B, h=H):
    """q, k, v as numpy (B, S, H, D) fp32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _bhsd(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


def _bshd(x):
    return np.asarray(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("s", [40, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_plain_matches_pallas(causal, s, d):
    """(o, lse) of the plain forward against the Pallas forward kernel;
    the JAX tests' own tolerance (fp32, another summation order)."""
    q, k, v = _qkv(s + d, s, d)
    jo, jlse = jax_flash.flash_attention_bhsd(
        _bhsd(q), _bhsd(k), _bhsd(v), causal=causal, interpret=True,
        return_lse=True)
    o, lse = pt_flash.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal)
    np.testing.assert_allclose(o.numpy(), _bshd(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,d", [(40, 32), (128, 32), (200, 64),
                                 (200, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_matches_pallas(causal, s, d):
    """(dq, dk, dv) of the plain backward against the Pallas dq and dk/dv
    kernels on the same do, lse and delta. S = 200 is ragged for the
    CUDA kernels' 64-row tiles (rows past S arrive as TMA zeros there)
    at the head dims they take; Pallas runs it in blocks of 40."""
    q, k, v = _qkv(s, s, d)
    do = np.random.default_rng(s + 1).standard_normal(q.shape).astype(
        np.float32)
    jq, jk, jv, jdo = map(_bhsd, (q, k, v, do))
    blk = 40 if s % 128 else 128
    jo, jlse = jax_flash.flash_attention_bhsd(
        jq, jk, jv, causal=causal, bq=blk, bk=blk, interpret=True,
        return_lse=True)
    jdelta = jnp.sum(jdo * jo, axis=-1, keepdims=True)
    ref = jax_flash.flash_attention_bwd_bhsd(
        jq, jk, jv, jdo, jlse, jdelta, causal=causal, bq=blk, bk=blk,
        interpret=True)
    got = pt_flash.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, do)),
        torch.from_numpy(np.array(jlse)[..., 0]),
        torch.from_numpy(np.array(jdelta)[..., 0]), causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), _bshd(r), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("s,causal", [(64, True), (136, True),
                                      (136, False)])
def test_gradients_through_flash_attention_match_jax(s, causal):
    """Gradients of sum(w * flash_attention(q, k, v)) in q, k, v against
    ``jax.grad`` of the JAX function (interpret mode). At S = 136 the
    JAX wrapper pads to 256 (and, non-causal, falls back to its dense
    path); the port pads nothing."""
    d = 16
    q, k, v = _qkv(7 * s, s, d)
    w = np.random.default_rng(s).standard_normal(q.shape).astype(np.float32)

    def jax_loss(q_, k_, v_):
        o = jax_attention.flash_attention(q_, k_, v_, causal=causal,
                                          interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    ref = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = pt_attention.flash_attention(tq, tk, tv, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    for name, g, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_jax(causal):
    q, k, v = _qkv(3, 24, 16)
    ref = jax_ring.attention_reference(*map(jnp.asarray, (q, k, v)),
                                       causal=causal)
    out = pt_ring.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_attention_reference_bf16_matches_jax():
    """bf16 operands, fp32 scores and accumulation, bf16 output: within
    one bf16 ulp of the JAX function (the two round the probabilities
    and the output at the same points)."""
    q, k, v = _qkv(4, 24, 16)
    ref = jax_ring.attention_reference(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True)
    out = pt_ring.attention_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=2.0 ** -7 * np.abs(ref).max())


def test_flash_matches_dense_oracle_and_scale():
    """The port's flash path against its own dense oracle, with an
    explicit scale (0 and None take d ** -0.5, as in JAX)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 33, 16))
    for scale in (None, 0, 0.3):
        o = pt_attention.flash_attention(q, k, v, scale=scale)
        ref = pt_ring.attention_reference(q, k, v, scale=scale)
        np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["interpret", "block", "block_q",
                                  "block_kv"])
def test_tpu_settings_raise_by_name(name):
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(NotImplementedError, match=name):
        pt_attention.flash_attention(q, q, q, **{name: 64})


def test_wrappers_check_shapes_and_count_only_kernel_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 20, 16))
    before = (pt_flash.flash_fwd.launches, pt_flash.flash_bwd_dq.launches,
              pt_flash.flash_bwd_dkv.launches)
    o, lse = pt_flash.flash_fwd(q, k, v)
    assert lse.shape == (B, H, 20) and lse.dtype == torch.float32
    delta = (o * o).sum(-1).transpose(1, 2).contiguous()
    pt_flash.flash_bwd_dq(q, k, v, o, lse, delta)
    pt_flash.flash_bwd_dkv(q, k, v, o, lse, delta)
    # CPU tensors take the plain versions: no launch is counted
    assert (pt_flash.flash_fwd.launches, pt_flash.flash_bwd_dq.launches,
            pt_flash.flash_bwd_dkv.launches) == before
    with pytest.raises(ValueError, match="one shape"):
        pt_flash.flash_fwd(q, k[:, :10], v)
    with pytest.raises(ValueError, match="lse and delta"):
        pt_flash.flash_bwd_dq(q, k, v, o, lse[:, :1], delta)
    # meta tensors (a traced step) take the kernel's own checks and give
    # its empty outputs, launching and counting nothing
    with pytest.raises(TypeError, match="bf16"):
        pt_flash.flash_fwd(*(t.to("meta") for t in (q, k, v)))
    mo, mlse = pt_flash.flash_fwd(*(t.to("meta", torch.bfloat16)
                                    for t in (q, k, v)))
    assert (mo.is_meta, mo.shape, mlse.shape) == (True, q.shape, lse.shape)
    assert pt_flash.flash_fwd.launches == before[0]
