"""Dense single-device attention, the oracle of the flash kernels and
the ``attention="reference"`` path of the Llama training forward.

Counterpart of ``attention_reference`` in
``sparkdl_tpu/parallel/ring_attention.py``; ring attention itself (the
sequence-parallel form) is not ported yet.
"""

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal=True, scale=None):
    """Attention on (B, S, H, D) tensors, k and v with q's head count.

    Scores and the PV product take input-dtype operands with fp32
    accumulation (the operands are widened to fp32, where the products
    of bf16 values are exact, so the sum is the JAX package's
    ``preferred_element_type=float32`` one); the softmax is fp32; the
    output comes back in v's dtype."""
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)
