"""Weight-only int8 and int4 serving modes for the decoder.

Counterpart of ``sparkdl_tpu/models/quant.py``. A decode step is bound
by the bytes of its weights: int8 weights with per-output-channel fp32
scales halve them against bf16, nibble-packed int4 weights with
group-wise fp32 scales quarter them (plus 1/8 of that in scales at
group 64). Every projection and the ``lm_head`` run through
:func:`sparkdl_tpu_torch.ops.quantized_matmul.quantized_matmul` (int8)
or :func:`~sparkdl_tpu_torch.ops.quantized_matmul.quantized_matmul_int4`.

:func:`quantize_llama_params` takes, by the JAX rule, only 2-D
``kernel`` leaves whose module name contains a target: an MoE layer's
stacked (E, d, f) experts and its router stay as they are (dense, in
the model dtype and fp32), so a quantized MoE model quantizes its
attention and its head.

Usage (serving)::

    cfg_q = dataclasses.replace(cfg, quant="int4", quant_group=64)
    q_params = quantize_llama_params(model.state_dict(), bits=4, group=64)
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


class QuantDense4(nn.Module):
    """Drop-in Dense over nibble-packed int4 weights + group-wise fp32
    scales, kept in the JAX layout: ``kernel_q4`` (in/2, out) int8,
    ``kernel_scale4`` (in/group, out) fp32. The group the matmul runs
    with comes from the scale shape (``in // scale rows``), as in the
    JAX module; ``group`` only sizes the scales. Activations enter and
    leave in ``dtype``."""

    def __init__(self, d_in, features, dtype, device, group=_qmm.INT4_GROUP):
        super().__init__()
        self.dtype = dtype
        self.kernel_q4 = nn.Parameter(
            torch.empty((d_in // 2, features), dtype=torch.int8,
                        device=device), requires_grad=False)
        self.kernel_scale4 = nn.Parameter(
            torch.empty((d_in // group, features), dtype=torch.float32,
                        device=device), requires_grad=False)

    def forward(self, x):
        lead = x.shape[:-1]
        d_in = x.shape[-1]
        flat = x.reshape(-1, d_in).to(self.dtype).contiguous()
        out = _qmm.quantized_matmul_int4(
            flat, self.kernel_q4, self.kernel_scale4,
            group=d_in // self.kernel_scale4.shape[0])
        return out.reshape(*lead, out.shape[-1]).to(self.dtype)


def quantize_llama_params(params, targets=LLAMA_QUANT_TARGETS, bits=8,
                          group=_qmm.INT4_GROUP, device=None):
    """Convert a dense Llama state dict to the layout
    ``Llama(cfg with quant="int8"/"int4")`` expects (int4 with
    ``group`` rows a scale), quantizing on ``device`` (default CUDA)
    one matrix at a time."""
    q_params, _ = _qmm.quantize_params(params, targets=targets, bits=bits,
                                       group=group, device=device)
    return q_params
