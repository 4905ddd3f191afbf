"""Shared kernel-dispatch helpers: device resolution, tile sizing,
padding.

Counterpart of ``sparkdl_tpu/ops/_dispatch.py``. The JAX package probes
its backend (``use_pallas``) and quietly takes the XLA lowering off the
TPU; the port never chooses a device on its own. Entry points run on
the card unless the caller names the CPU, and each kernel wrapper picks
its path from the device of the tensors it is handed: the plain PyTorch
version for CPU tensors, the CUDA kernel (or an error) for CUDA ones.
"""

import torch
import torch.nn.functional as F


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless ``device`` names
    another. Raises RuntimeError when CUDA is asked for (explicitly or
    by default) and none is present — never a silent move to the CPU.
    ``"meta"`` is accepted for shape-only construction."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device}")
    return device


def block_for(size, tile=128, floor=8):
    """Tile size for a dimension: the full tile when it fits, else a
    small multiple that at least satisfies the floor."""
    return tile if size >= tile else max(floor, size)


def pad_to(x, multiple, axis):
    """Zero-pad ``axis`` up to a multiple; returns (padded, pad)."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x, 0
    axis = axis % x.ndim
    # F.pad lists (left, right) pairs from the LAST dimension backwards
    widths = [0, 0] * (x.ndim - axis)
    widths[-1] = pad
    return F.pad(x, widths), pad
