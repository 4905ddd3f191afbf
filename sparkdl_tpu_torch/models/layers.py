"""The layers of the model zoo (MnistCNN, ResNet, BERT) in flax's
conventions, which the JAX package's models take from ``flax.linen``.

Every parameter is fp32 (flax's ``param_dtype``) and is cast to the
layer's compute ``dtype`` at each call, as flax casts it: a bf16 model
trains fp32 weights through bf16 products. Dense kernels keep flax's
(in, out) layout; a convolution's ``kernel`` is torch's (out, in, kh,
kw) (:func:`~sparkdl_tpu_torch.models.from_jax.load_jax_variables`
transposes flax's (kh, kw, in, out)). Convolutions and batch norms work
on NCHW views; a model that takes NHWC images (flax's layout) permutes
them once, which on NHWC-contiguous data is a channels-last NCHW
tensor, cuDNN's fast layout on the card. Initialisers are flax's
defaults, drawn from an optional ``torch.Generator``: kernels
lecun-normal (truncated at two deviations), embeddings normal with
variance 1 / features, biases zeros, norm scales ones.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

# the deviation of a standard normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t, fan_in, generator=None):
    """flax's default kernel init in place: truncated normal with
    variance 1 / ``fan_in``. A meta tensor is left as it is."""
    if t.is_meta:
        return t
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def _zeros(shape, device):
    return nn.Parameter(torch.zeros(shape, device=device))


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``, kernel
    (in, out)."""

    def __init__(self, d_in, features, dtype, device, *, bias=True,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((d_in, features),
                                               device=device))
        lecun_normal_(self.kernel, d_in, generator)
        self.bias = _zeros((features,), device) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                        bias)


def same_pads(size, kernel, stride):
    """flax's ``"SAME"`` padding of one spatial dim: (before, after),
    the odd pixel after. A stride-2 3x3 window on an even size pads
    (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax's ``nn.Conv`` on an NCHW view: ``padding`` is ``"SAME"`` or
    explicit ((top, bottom), (left, right)); the product runs in
    ``dtype``."""

    def __init__(self, d_in, features, kernel_size, dtype, device, *,
                 strides=1, padding="SAME", bias=False, generator=None):
        super().__init__()
        self.dtype = dtype
        self.strides = strides
        self.padding = padding
        kh, kw = kernel_size
        self.kernel = nn.Parameter(torch.empty((features, d_in, kh, kw),
                                               device=device))
        lecun_normal_(self.kernel, d_in * kh * kw, generator)
        self.bias = _zeros((features,), device) if bias else None

    def forward(self, x):
        kh, kw = self.kernel.shape[2:]
        if self.padding == "SAME":
            pads = (same_pads(x.shape[2], kh, self.strides),
                    same_pads(x.shape[3], kw, self.strides))
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        x = x.to(self.dtype)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        x = x.contiguous(memory_format=torch.channels_last)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias, self.strides,
                        padding)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over dim 1 of an NCHW view, computed and
    returned in fp32. In training mode (``module.training``) it
    normalises by the batch's statistics and moves the running ones
    toward them as flax does, ``ra = momentum * ra + (1 - momentum) *
    stat``, with the BIASED batch variance (``torch.nn.BatchNorm2d``
    takes the unbiased one); in eval mode it normalises by the running
    statistics. The running statistics are the buffers ``mean`` and
    ``var`` (flax's ``batch_stats``)."""

    def __init__(self, features, device, *, momentum=0.9, eps=1e-5,
                 scale_init=1.0):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.full((features,), float(scale_init),
                                             device=device))
        self.bias = _zeros((features,), device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x):
        x = x.to(torch.float32)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        # one pass: torch's batch norm moves the mean as flax does and a
        # copy of the variance toward the UNBIASED batch variance, which
        # is corrected to the biased one after (n values a channel)
        n = x.numel() // x.shape[1]
        var = self.var.clone()
        out = F.batch_norm(x, self.mean, var, self.scale, self.bias, True,
                           1 - self.momentum, self.eps)
        with torch.no_grad():
            kept = self.momentum * self.var
            self.var.copy_(kept + (var - kept) * ((n - 1) / n))
        return out


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=float32)`` over the last dim: fp32 in
    and out, ``scale`` and ``bias``."""

    def __init__(self, features, eps, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = _zeros((features,), device)

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), self.scale.shape,
                            self.scale, self.bias, self.eps)


class Embed(nn.Module):
    """flax's ``nn.Embed``: the (vocab, features) table cast to
    ``dtype``, then the rows looked up (so its gradient is summed in
    ``dtype``, as flax sums it)."""

    def __init__(self, vocab, features, dtype, device, generator=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty((vocab, features),
                                                  device=device))
        if not self.embedding.is_meta:
            with torch.no_grad():
                self.embedding.normal_(0.0, math.sqrt(1.0 / features),
                                       generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.embedding.to(self.dtype))
