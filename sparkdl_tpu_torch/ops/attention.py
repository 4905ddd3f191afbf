"""Flash attention on the models' (B, S, H, D) layout, forward and
backward through the kernels of :mod:`sparkdl_tpu_torch.ops.flash_attention`.

Counterpart of ``sparkdl_tpu/ops/attention.py``. The forward saves only
(q, k, v, o, lse); the backward computes delta = sum(do * o, -1) in fp32
here, outside the kernels as the JAX package does, then calls the dq and
the dk/dv kernel. CPU tensors take the plain versions, CUDA tensors the
kernels (or an error). The JAX wrapper pads S to its tile and falls back
to dense attention for a padded non-causal call; the kernels here mask
ragged keys themselves, so neither happens.
"""

import torch

from sparkdl_tpu_torch.ops import flash_attention as _flash


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _flash.flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = _flash.flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                 ctx.scale)
        dk, dv = _flash.flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                      ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, interpret=None,
                    block=None, block_q=None, block_kv=None):
    """Fused attention on (batch, seq, heads, head_dim) tensors, k and v
    with q's head count; differentiable in q, k and v.

    ``interpret``, ``block``, ``block_q`` and ``block_kv`` of the JAX
    function are TPU settings (Pallas interpret mode, TPU tile sizes)
    with no meaning for the CUDA kernels: each raises NotImplementedError
    when given."""
    for name, value in (("interpret", interpret), ("block", block),
                        ("block_q", block_q), ("block_kv", block_kv)):
        if value is not None:
            raise NotImplementedError(
                f"flash_attention: {name} is a TPU setting and is not "
                "ported")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale)
