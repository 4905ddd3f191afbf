"""LoRA: low-rank adapters on frozen projections, for parameter-efficient
fine-tuning (the Llama-3-8B LoRA fine-tune).

Counterpart of ``sparkdl_tpu/models/lora.py`` (``LoRADense``,
``lora_mask``, ``merge_lora_with``; the multi-adapter serving module
waits for the multi-LoRA serving slice). Only ``lora_a`` and ``lora_b``
train: :func:`lora_mask` marks them, and the ``param_mask`` option of
:func:`sparkdl_tpu_torch.parallel.train.make_train_step` freezes the
rest.
"""

from collections.abc import Mapping

import torch
from torch import nn


class LoRADense(nn.Module):
    """Bias-free projection with a low-rank residual adapter,
    ``y = x @ W + (alpha / rank) * (x @ A) @ B``, computed in ``dtype``.

    ``kernel`` (in, out) is frozen and stored in ``dtype``; ``lora_a``
    (in, rank) and ``lora_b`` (rank, out) are trainable fp32 masters,
    cast to ``dtype`` in the forward as the JAX module casts its params.
    All three are allocated uninitialised; the JAX init is ``lora_a``
    normal(0.02) and ``lora_b`` zeros
    (:func:`sparkdl_tpu_torch.models.llama.init_weights`)."""

    def __init__(self, d_in, features, rank, alpha, dtype, device):
        super().__init__()
        self.dtype, self.rank, self.alpha = dtype, rank, alpha
        self.kernel = nn.Parameter(
            torch.empty((d_in, features), dtype=dtype, device=device),
            requires_grad=False)
        self.lora_a = nn.Parameter(
            torch.empty((d_in, rank), dtype=torch.float32, device=device))
        self.lora_b = nn.Parameter(
            torch.empty((rank, features), dtype=torch.float32,
                        device=device))

    def forward(self, x):
        x = x.to(self.dtype)
        delta = (x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype)
        return x @ self.kernel + (self.alpha / self.rank) * delta


def _jax_keys(name):
    """The JAX tree path of a port parameter name, as a list of keys
    (``layers.3.attn.q_proj.lora_a`` -> layer_3, attn, q_proj, lora_a)."""
    keys, parts = [], name.split(".")
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts):
            keys.append(f"layer_{parts[i + 1]}")
            i += 2
        else:
            keys.append(parts[i])
            i += 1
    return keys


def lora_mask(model, extra_trainable=()):
    """{parameter name: bool} over ``model``'s parameters: True only for
    ``lora_a`` / ``lora_b``, plus any parameter whose JAX path has a key
    containing one of ``extra_trainable`` (``"final_norm"``,
    ``"layer_1"``), as the JAX function matches."""
    mask = {}
    for name, _ in model.named_parameters():
        keys = _jax_keys(name)
        mask[name] = (any(k in ("lora_a", "lora_b") for k in keys)
                      or any(t in k for t in extra_trainable for k in keys))
    return mask


def merge_lora_with(params, alpha, rank):
    """Fold adapters into their base kernels for deployment:
    ``kernel += (alpha / rank) * A @ B`` (in fp32, stored back in the
    kernel's dtype), adapters zeroed. ``params`` is a state dict or a
    module; returns a new state dict and leaves ``params`` as it was.
    The (alpha, rank) used in training must be passed explicitly."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if not isinstance(params, Mapping):
        raise TypeError("merge_lora_with takes a state dict or a module")
    out = dict(params)
    for name, a in params.items():
        if not name.endswith(".lora_a"):
            continue
        prefix = name[:-len("lora_a")]
        kernel, b = params[prefix + "kernel"], params[prefix + "lora_b"]
        merged = kernel.float() + (alpha / rank) * (a.float() @ b.float())
        out[prefix + "kernel"] = merged.to(kernel.dtype)
        out[name] = torch.zeros_like(a)
        out[prefix + "lora_b"] = torch.zeros_like(b)
    return out
