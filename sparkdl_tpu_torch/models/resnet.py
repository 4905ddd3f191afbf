"""ResNet family (BASELINE.json config 2: ResNet-50/ImageNet).

Counterpart of ``sparkdl_tpu/models/resnet.py``, under its module names
(``conv_init``, ``bn_init``, ``stage<i>_block<j>`` with ``conv1``-``conv3``,
``bn1``-``bn3``, ``conv_proj``, ``bn_proj``, ``classifier``). Convolutions
run in ``dtype`` (bf16 for :func:`ResNet50`) through cuDNN on a
channels-last layout; every batch norm computes and returns fp32 (its
statistics too), and the next convolution casts back, so the residual
stream between blocks is fp32, as in the JAX model. The head is fp32 on
the fp32 mean-pool. ``bn3``'s scale starts at zero (each residual
branch starts as the identity).

Differences kept on purpose:

- the images are NHWC, as in flax, and ``forward`` permutes them once
  to an NCHW view; the blocks take that view;
- ``module.training`` (``model.train()`` / ``model.eval()``) takes the
  place of flax's ``train=`` and ``mutable=["batch_stats"]``: a
  training-mode forward updates the ``mean`` and ``var`` buffers in
  place, with flax's momentum and biased variance
  (:class:`~sparkdl_tpu_torch.models.layers.BatchNorm`);
- a block's projection shortcut is decided at construction (the input
  width differs from ``4 * features`` or the stride is 2), where flax
  compares the two branches' shapes at the call;
- the stem takes ``in_channels`` (3) at construction; flax infers it.

Strided 3x3 convolutions pad flax's ``"SAME"``: (0, 1) on an even size.
"""

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import BatchNorm, Conv, Dense
from sparkdl_tpu_torch.ops._dispatch import resolve_device


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 x 4 with a batch norm after each, and a
    projected shortcut where the shape changes. Takes and returns an
    NCHW view (fp32 out)."""

    def __init__(self, in_features, features, strides=1,
                 dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv(in_features, features, (1, 1), dtype, **kw)
        self.bn1 = BatchNorm(features, device)
        self.conv2 = Conv(features, features, (3, 3), dtype,
                          strides=strides, **kw)
        self.bn2 = BatchNorm(features, device)
        self.conv3 = Conv(features, features * 4, (1, 1), dtype, **kw)
        self.bn3 = BatchNorm(features * 4, device, scale_init=0.0)
        if in_features != features * 4 or strides != 1:
            self.conv_proj = Conv(in_features, features * 4, (1, 1), dtype,
                                  strides=strides, **kw)
            self.bn_proj = BatchNorm(features * 4, device)
        else:
            self.conv_proj = self.bn_proj = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.bn_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """The stem (7x7 stride 2, batch norm, 3x3 max-pool stride 2), the
    bottleneck stages of ``stage_sizes`` (widths 64 x 2^i, the first
    block of every later stage strided), the mean-pool and the fp32
    ``classifier``. Weights on ``device`` (CUDA unless named), drawn from
    ``generator`` with flax's initialisers."""

    def __init__(self, stage_sizes, num_classes=1000, dtype=torch.bfloat16,
                 device=None, generator=None, in_channels=3):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv_init = Conv(in_channels, 64, (7, 7), dtype, device=device,
                              strides=2, padding=((3, 3), (3, 3)),
                              generator=generator)
        self.bn_init = BatchNorm(64, device)
        self.block_names = []
        width = 64
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                name = f"stage{i}_block{j}"
                self.add_module(name, BottleneckBlock(
                    width, 64 * 2 ** i, 2 if i > 0 and j == 0 else 1,
                    dtype, device, generator))
                self.block_names.append(name)
                width = 64 * 2 ** i * 4
        self.classifier = Dense(width, num_classes, torch.float32,
                                device=device, generator=generator)

    def forward(self, x):
        """``x`` (B, H, W, C) images → fp32 logits (B, num_classes)."""
        x = self.conv_init(x.permute(0, 3, 1, 2))
        x = F.relu(self.bn_init(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.classifier(x.mean(dim=(2, 3)))


def ResNet50(num_classes=1000, dtype=torch.bfloat16, device=None,
             generator=None):
    return ResNet((3, 4, 6, 3), num_classes=num_classes, dtype=dtype,
                  device=device, generator=generator)


def ResNet18Thin(num_classes=10, dtype=torch.float32, device=None,
                 generator=None):
    """CI-size variant (same block machinery, tiny stages)."""
    return ResNet((1, 1), num_classes=num_classes, dtype=dtype,
                  device=device, generator=generator)
