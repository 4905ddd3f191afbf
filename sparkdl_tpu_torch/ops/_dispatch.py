"""Shared kernel-dispatch helpers: device resolution, tile sizing,
padding, and the host side of a kernel launch (SM count, stream).

Counterpart of ``sparkdl_tpu/ops/_dispatch.py``. The JAX package probes
its backend (``use_pallas``) and quietly takes the XLA lowering off the
TPU; the port never chooses a device on its own. Entry points run on
the card unless the caller names the CPU, and each kernel wrapper picks
its path from the device of the tensors it is handed: the plain PyTorch
version for CPU tensors, the CUDA kernel (or an error) for CUDA ones,
and for ``meta`` tensors (a traced step,
:mod:`sparkdl_tpu_torch.analysis.trace`) the kernel's empty outputs and
one kernel event (:func:`traced_launch`).
"""

import threading

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


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


_SM_COUNTS = {}  # CUDA device index -> streaming multiprocessors


def sm_count(device):
    """The SM count of a CUDA device, read from its properties once per
    device: a kernel wrapper's split plan needs it on every call."""
    n = _SM_COUNTS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNTS[device.index] = n
    return n


def launch_on(device, fn, *args):
    """Call a kernel's C entry point ``fn(*args, stream)`` on ``device``'s
    current stream. The current device is switched (and restored) only
    when ``device`` is not already current, which a decode step's
    hundreds of calls a step never need."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper):
    """Add one to ``wrapper.launches`` (a kernel launched), under a lock:
    the engine threads of a serving fleet launch kernels at once."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def traced_launch(wrapper, kernel, inputs, outputs, flops):
    """The launch a kernel wrapper would make, on ``meta`` tensors: one
    kernel event (``kernel``: the kernel's id in ``PERF.md``'s table,
    ``"B1"``; its FLOPs; its bytes, each input read and each output
    written once) handed to the trace recording on this thread, if one
    is, and ``outputs`` (the CUDA path's, empty) returned. Nothing is
    launched and no count moves."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    for mode in _get_current_dispatch_mode_stack():
        note = getattr(mode, "kernel_event", None)
        if note is not None:
            note(wrapper.__name__, kernel, inputs, outputs, flops, nbytes)
    return outputs
