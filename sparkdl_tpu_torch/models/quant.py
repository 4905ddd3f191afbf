"""Weight-only int8 serving mode for the decoder.

Counterpart of ``sparkdl_tpu/models/quant.py`` (int8 only). A decode
step is bound by the bytes of its weights: int8 weights with
per-output-channel fp32 scales halve them against bf16, and every
projection and the ``lm_head`` run through
:func:`sparkdl_tpu_torch.ops.quantized_matmul.quantized_matmul`.

Usage (serving)::

    cfg_q = dataclasses.replace(cfg, quant="int8")
    q_params = quantize_llama_params(model.state_dict())
    model_q = Llama.from_params(cfg_q, q_params)
"""

import torch
from torch import nn

from sparkdl_tpu_torch.ops import quantized_matmul as _qmm

# which Llama layers go int8 (embeddings stay dense: a lookup reads one
# row, quantization saves nothing there)
LLAMA_QUANT_TARGETS = _qmm.DEFAULT_QUANT_TARGETS


class QuantDense(nn.Module):
    """Drop-in Dense over int8 weights + fp32 per-column scales, kept in
    the JAX layout: ``kernel_q`` (in, out) int8, ``kernel_scale`` (out,)
    fp32. Activations enter and leave in ``dtype``."""

    def __init__(self, d_in, features, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = nn.Parameter(
            torch.empty((d_in, features), dtype=torch.int8, device=device),
            requires_grad=False)
        self.kernel_scale = nn.Parameter(
            torch.empty((features,), dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1]).to(self.dtype).contiguous()
        out = _qmm.quantized_matmul(flat, self.kernel_q, self.kernel_scale)
        return out.reshape(*lead, out.shape[-1]).to(self.dtype)


def quantize_llama_params(params, targets=LLAMA_QUANT_TARGETS, bits=8,
                          device=None):
    """Convert a dense Llama state dict to the layout
    ``Llama(cfg with quant="int8")`` expects, quantizing on ``device``
    (default CUDA) one matrix at a time."""
    q_params, _ = _qmm.quantize_params(params, targets=targets, bits=bits,
                                       device=device)
    return q_params
