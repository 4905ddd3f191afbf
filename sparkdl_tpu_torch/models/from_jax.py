"""Load the JAX package's Llama param tree into the port's model.

The tree is given as nested dicts of arrays (numpy, or anything
``np.asarray`` takes), dense (``kernel``), with LoRA adapters
(``kernel`` + ``lora_a`` + ``lora_b``) or int8 (``kernel_q`` +
``kernel_scale``), exactly as ``Llama(cfg).init(...)["params"]`` and
``quantize_llama_params`` make it. The port keeps the JAX names and
layouts, so the only renaming is ``layer_<i>`` → ``layers.<i>``. Each
value is cast to its weight's dtype: the JAX init's fp32 base kernels
become ``cfg.dtype`` (the value the JAX forward computes with, since it
casts them per call), while adapters, norms and the head stay fp32.
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


def load_jax_params(model, tree):
    """Copy a JAX Llama param tree into ``model``'s weights in place
    (cast to each weight's dtype, on its device); returns ``model``.
    Raises on a missing, unexpected or mis-shaped entry."""
    flat = flatten_jax_tree(tree)
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise ValueError(
            f"JAX tree does not match the model: missing {missing}, "
            f"unexpected {unexpected}")
    with torch.no_grad():
        for name, weight in state.items():
            src = torch.from_numpy(np.array(flat[name]))
            if tuple(src.shape) != tuple(weight.shape):
                raise ValueError(
                    f"{name}: JAX shape {tuple(src.shape)}, model "
                    f"expects {tuple(weight.shape)}")
            weight.copy_(src)
    return model
