"""MNIST CNN (BASELINE.json config 1: "MNIST Keras CNN,
HorovodRunner(np=-1) local mode").

Counterpart of ``sparkdl_tpu/models/mnist_cnn.py``. It takes flax's
NHWC images, (B, 28, 28, 1), and keeps flax's auto names (``Conv_0``,
``Conv_1``, ``Dense_0``, ``Dense_1``), so a JAX tree loads one to one
(:func:`~sparkdl_tpu_torch.models.from_jax.load_jax_variables`). The
convolutions pad ``"SAME"`` (flax's default), and the pooled features
are flattened in (H, W, C) order, the order ``Dense_0``'s rows follow.
"""

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import Conv, Dense
from sparkdl_tpu_torch.ops._dispatch import resolve_device


class MnistCNN(nn.Module):
    """Two 3x3 convolutions (32, 64), a 2x2 max-pool, Dense 128 and the
    fp32 head. Weights on ``device`` (CUDA unless the caller names
    another), drawn from ``generator`` with flax's initialisers."""

    def __init__(self, num_classes=10, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.dtype = dtype
        kw = dict(device=device, bias=True, generator=generator)
        self.Conv_0 = Conv(1, 32, (3, 3), dtype, **kw)
        self.Conv_1 = Conv(32, 64, (3, 3), dtype, **kw)
        self.Dense_0 = Dense(14 * 14 * 64, 128, dtype, **kw)
        self.Dense_1 = Dense(128, num_classes, torch.float32, **kw)

    def forward(self, x):
        """``x`` (B, 28, 28, 1) → fp32 logits (B, num_classes)."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)
