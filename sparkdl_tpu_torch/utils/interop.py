"""Framework tensor interop: numpy <-> torch / tensorflow.

Counterpart of ``sparkdl_tpu/utils/interop.py``. The port's Horovod API
(:mod:`sparkdl_tpu_torch.hvd`) takes tensors from any framework a user
``main`` may use (tf.keras, PyTorch) and hands each result back in its
caller's type. A framework is touched only when the user already
imported it (a ``sys.modules`` check), so importing the port never
brings in tensorflow.

A ``jax.Array`` goes in through ``np.asarray`` like any array-like and
comes back as numpy: the port imports no jax, so it cannot build one.
"""

import sys

import numpy as np


def _torch():
    return sys.modules.get("torch")


def _tf():
    return sys.modules.get("tensorflow")


def is_torch_tensor(x):
    t = _torch()
    return t is not None and isinstance(x, t.Tensor)


def is_tf_tensor(x):
    tf = _tf()
    return tf is not None and isinstance(x, (tf.Tensor, tf.Variable))


def to_numpy(x):
    """Convert a framework tensor (or scalar) to a numpy array; a torch
    tensor on a card is copied to the host."""
    if isinstance(x, np.ndarray):
        return x
    if is_torch_tensor(x):
        return x.detach().cpu().numpy()
    if is_tf_tensor(x):
        return x.numpy()
    return np.asarray(x)


def from_numpy_like(result, template):
    """Convert numpy ``result`` back to the framework and type of
    ``template``: a torch template gives its device and dtype, a tf one
    its dtype, a Python or numpy scalar a Python scalar for a 0-d
    result; anything else gets the numpy array."""
    if isinstance(template, np.ndarray):
        return result
    if is_torch_tensor(template):
        out = _torch().from_numpy(np.ascontiguousarray(result))
        return out.to(device=template.device, dtype=template.dtype)
    if is_tf_tensor(template):
        return _tf().convert_to_tensor(result, dtype=template.dtype)
    if np.isscalar(template) or isinstance(template, (int, float)):
        return result.item() if np.ndim(result) == 0 else result
    return result
