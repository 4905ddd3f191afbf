"""Load the JAX package's Llama param tree into the port's model.

The tree is given as nested dicts of arrays (numpy, or anything
``np.asarray`` takes), dense (``kernel``), with LoRA adapters
(``kernel`` + ``lora_a`` + ``lora_b``), with stacked multi-LoRA
adapters (``lora_a`` (N, in, rank) and ``lora_b`` (N, rank, out), as
the JAX ``stack_lora_adapters`` makes them, loaded into a model built
with ``multi_lora=N``, so both packages serve the same weights), int8
(``kernel_q`` +
``kernel_scale``) or int4 (``kernel_q4`` + ``kernel_scale4``, loaded
into a model built with the same ``quant_group``), with Mixtral-style
expert layers (``moe_mlp``: the router's ``kernel`` and ``bias``, kept
fp32, and the stacked ``w_gate`` / ``w_up`` / ``w_down``, cast to the
model dtype; a tensor-parallel model takes its own experts), exactly as
``Llama(cfg).init(...)["params"]`` and ``quantize_llama_params`` make
it. int8 and fp32 leaves arrive untouched. The port keeps the JAX names and
layouts, so the only renaming is ``layer_<i>`` → ``layers.<i>``. Each
value is cast to its weight's dtype: the JAX init's fp32 base kernels
become ``cfg.dtype`` (the value the JAX forward computes with, since it
casts them per call), while adapters, norms and the head stay fp32.

:func:`load_jax_variables` loads the model zoo's families (``MnistCNN``,
``ResNet``, the BERT models, on a mesh too) from their flax variables:
``params`` and, for a ResNet, ``batch_stats`` onto the batch norms'
``mean`` and ``var`` buffers, each convolution kernel transposed from
flax's (kh, kw, in, out) to torch's (out, in, kh, kw).
"""

import re
from collections.abc import Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")


def flatten_jax_tree(tree, prefix=""):
    """Nested dicts → {dotted port name: numpy array}."""
    flat = {}
    for key, value in tree.items():
        m = _LAYER.match(key)
        name = f"layers.{m.group(1)}" if m else key
        name = f"{prefix}.{name}" if prefix else name
        if isinstance(value, Mapping):
            flat.update(flatten_jax_tree(value, name))
        else:
            arr = np.asarray(value)
            if arr.dtype not in (np.float32, np.int8):
                # bfloat16 leaves (not a numpy dtype torch takes): widen;
                # the copy into the model casts to the weight's dtype
                arr = arr.astype(np.float32)
            flat[name] = arr
    return flat


def _copy_into(state, flat, what):
    """Copy ``flat`` ({name: numpy array}) into the tensors of ``state``
    in place, each cast to its tensor's dtype; raises on a missing,
    unexpected or mis-shaped entry."""
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise ValueError(
            f"{what} does not match the model: missing {missing}, "
            f"unexpected {unexpected}")
    with torch.no_grad():
        for name, weight in state.items():
            src = torch.from_numpy(np.array(flat[name]))
            if tuple(src.shape) != tuple(weight.shape):
                raise ValueError(
                    f"{name}: JAX shape {tuple(src.shape)}, model "
                    f"expects {tuple(weight.shape)}")
            weight.copy_(src)


def load_jax_params(model, tree):
    """Copy a JAX Llama param tree into ``model``'s weights in place
    (cast to each weight's dtype, on its device); returns ``model``.
    A tensor-parallel model (built with a mesh) takes this rank's slice
    of each whole leaf (:meth:`~sparkdl_tpu_torch.models.llama.Llama.
    local_params`, after flattening), so a TP rank serves the same
    weights as the JAX TP engine. Raises on a missing, unexpected or
    mis-shaped entry."""
    flat = flatten_jax_tree(tree)
    if getattr(model, "tp", None) is not None:
        flat = model.local_params(flat)
    _copy_into(model.state_dict(), flat, "JAX tree")
    return model


def load_jax_variables(model, variables):
    """Copy the flax variables of a model-zoo family (``{"params": ...,
    "batch_stats": ...}``, nested dicts of arrays, as ``model.init``
    returns them) into ``model``'s parameters and buffers in place;
    returns ``model``. A 4-D ``kernel`` (a convolution's) is transposed
    (kh, kw, in, out) → (out, in, kh, kw); ``batch_stats``' ``mean`` and
    ``var`` land on the buffers of the same names. Raises on a missing,
    unexpected or mis-shaped entry (a BERT tree initialised without
    ``token_type_ids`` lacks ``type_embed``). A BERT model laid out on a
    tensor-parallel or ZeRO-3 mesh takes this rank's slice of each whole
    leaf (its ``local_params``)."""
    flat = flatten_jax_tree(variables.get("params", {}))
    for name, arr in flat.items():
        if name.endswith("kernel") and arr.ndim == 4:
            flat[name] = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    flat.update(flatten_jax_tree(variables.get("batch_stats", {})))
    if getattr(model, "mesh", None) is not None:
        flat = model.local_params(flat)
    _copy_into(model.state_dict(), flat, "flax variables")
    return model
