"""LoRA: low-rank adapters on frozen projections, for parameter-efficient
fine-tuning (the Llama-3-8B LoRA fine-tune).

Counterpart of ``sparkdl_tpu/models/lora.py`` (``LoRADense``,
``MultiLoRADense``, ``stack_lora_adapters``, ``lora_mask``,
``merge_lora_with``). Only ``lora_a`` and ``lora_b`` train:
:func:`lora_mask` marks them, and the ``param_mask`` option of
:func:`sparkdl_tpu_torch.parallel.train.make_train_step` freezes the
rest. Serving many fine-tunes of one base: :func:`stack_lora_adapters`
stacks their adapters into one state dict for a model with
``LlamaConfig.multi_lora`` set, whose :class:`MultiLoRADense`
projections select each batch row's adapter.
"""

from collections.abc import Mapping

import torch
from torch import nn

from sparkdl_tpu_torch.parallel.mesh import replicated


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
        # (mesh, leaf name): the adapter leaf this rank holds whole while
        # the projection is split over ``model`` (set by a tensor-parallel
        # model); it enters through f, so its gradient sums every rank's
        self.tp_whole = None

    def forward(self, x):
        x = x.to(self.dtype)
        a, b = self.lora_a, self.lora_b
        if self.tp_whole is not None:
            mesh, leaf = self.tp_whole
            if leaf == "lora_a":
                a = replicated(a, mesh, "model")
            else:
                b = replicated(b, mesh, "model")
        delta = (x @ a.to(self.dtype)) @ b.to(self.dtype)
        return x @ self.kernel + (self.alpha / self.rank) * delta


class MultiLoRADense(nn.Module):
    """Serving-side projection with ``n_adapters`` low-rank adapters
    stacked on one frozen ``kernel`` (in, out), selected per batch row:
    ``y[b] = x[b] @ W + (alpha / rank) * (x[b] @ A[ids[b]]) @ B[ids[b]]``,
    computed in ``dtype``. ``lora_a`` (N, in, rank) and ``lora_b``
    (N, rank, out) are fp32 and frozen, cast to ``dtype`` after the
    gather; the two skinny products are batched matmuls, as the JAX
    module leaves them to XLA."""

    def __init__(self, d_in, features, rank, alpha, n_adapters, dtype,
                 device):
        super().__init__()
        self.dtype, self.rank, self.alpha = dtype, rank, alpha
        self.kernel = nn.Parameter(
            torch.empty((d_in, features), dtype=dtype, device=device),
            requires_grad=False)
        self.lora_a = nn.Parameter(
            torch.empty((n_adapters, d_in, rank), dtype=torch.float32,
                        device=device), requires_grad=False)
        self.lora_b = nn.Parameter(
            torch.empty((n_adapters, rank, features), dtype=torch.float32,
                        device=device), requires_grad=False)

    def forward(self, x, ids):
        """x (b, s, in), ids (b,) adapter indices."""
        x = x.to(self.dtype)
        a_sel = self.lora_a[ids].to(self.dtype)         # (b, in, r)
        b_sel = self.lora_b[ids].to(self.dtype)         # (b, r, out)
        delta = torch.bmm(torch.bmm(x, a_sel), b_sel)
        return x @ self.kernel + (self.alpha / self.rank) * delta


def stack_lora_adapters(state_dicts):
    """ONE multi-adapter state dict from N single-adapter ones that share
    a base (the port's state dicts, as ``model.state_dict()`` gives
    them, trained ones included): every ``lora_a`` / ``lora_b`` entry
    becomes a stacked (N, ...) fp32 tensor, adapter i from dict i;
    every other entry must be identical across the dicts (one frozen
    model) and is taken from the first, not copied. Load the result
    into a model whose config has ``multi_lora=N``."""
    state_dicts = [sd.state_dict() if isinstance(sd, nn.Module) else sd
                   for sd in state_dicts]
    if not state_dicts:
        raise ValueError("stack_lora_adapters needs at least one state dict")
    first = state_dicts[0]
    for other in state_dicts[1:]:
        if set(other) != set(first):
            raise ValueError(
                "adapter state dicts differ in their keys: "
                f"{sorted(set(first) ^ set(other))}")
    out = {}
    for name, leaf in first.items():
        if name.rpartition(".")[2] in ("lora_a", "lora_b"):
            out[name] = torch.stack([sd[name].detach().float()
                                     for sd in state_dicts])
            continue
        for other in state_dicts[1:]:
            t = other[name]
            if t is not leaf and not (t.shape == leaf.shape
                                      and t.dtype == leaf.dtype
                                      and torch.equal(t, leaf)):
                raise ValueError(
                    f"base param {name} differs across adapter trees — "
                    "multi-LoRA serves ONE frozen base")
        out[name] = leaf
    return out


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
