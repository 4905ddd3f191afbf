"""The port's framework interop (``utils/interop.py``) against the JAX
package's, and the port's ``hvd`` handing a TF tensor back as a TF
tensor, as the JAX ``hvd`` does."""

import numpy as np
import pytest
import tensorflow as tf
import torch

import sparkdl_tpu.hvd as jax_hvd
from sparkdl_tpu.hvd import _state as jax_state
from sparkdl_tpu.utils import interop as jax_interop
from sparkdl_tpu_torch import hvd as pt_hvd
from sparkdl_tpu_torch.hvd import _state as pt_state
from sparkdl_tpu_torch.utils import interop as pt_interop

torch.set_num_threads(2)

_RNG = np.random.default_rng(0)
_F32 = _RNG.standard_normal((3, 4)).astype(np.float32)
_I32 = _RNG.integers(-9, 9, (5,)).astype(np.int32)


def _inputs():
    return {
        "numpy_f32": _F32,
        "numpy_i32": _I32,
        "torch_f32": torch.from_numpy(_F32.copy()),
        "torch_i64": torch.arange(6).reshape(2, 3),
        "torch_bf16": torch.from_numpy(_F32.copy()).to(torch.bfloat16),
        "tf_f32": tf.constant(_F32),
        "tf_i32": tf.constant(_I32),
        "tf_variable": tf.Variable(_F32),
        "py_float": 2.5,
        "py_int": 7,
        "np_scalar": np.float32(1.25),
        "list": [1.0, 2.0, 3.0],
    }


def _same(a, b):
    """The same type, dtype and values."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, (tf.Tensor, tf.Variable)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_predicates_and_to_numpy_match_jax(name):
    x = _inputs()[name]
    assert pt_interop.is_torch_tensor(x) == jax_interop.is_torch_tensor(x)
    assert pt_interop.is_tf_tensor(x) == jax_interop.is_tf_tensor(x)
    if name == "torch_bf16":
        # numpy has no bfloat16: both packages refuse alike
        for mod in (pt_interop, jax_interop):
            with pytest.raises(TypeError):
                mod.to_numpy(x)
        return
    _same(pt_interop.to_numpy(x), jax_interop.to_numpy(x))


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_from_numpy_like_matches_jax(name):
    """A float64 result goes back to each template's framework and dtype
    as the JAX package sends it back; a 0-d one to a scalar's type."""
    template = _inputs()[name]
    shape = np.shape(_F32 if name == "torch_bf16"
                     else jax_interop.to_numpy(template))
    for result in (np.full(shape, 2.5), np.asarray(3.0)):
        _same(pt_interop.from_numpy_like(result, template),
              jax_interop.from_numpy_like(result, template))


def test_torch_template_keeps_device_and_dtype():
    """A bf16 template gives bf16 on the template's device (a card's:
    chip_smoke.py's phase 30b); an array-like such as a jax.Array comes
    back as numpy, the port having no jax to build one with."""
    out = pt_interop.from_numpy_like(_F32, torch.zeros(1, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    torch.testing.assert_close(out, torch.from_numpy(_F32).bfloat16())

    class _ArrayLike:  # anything with __array__, as a jax.Array has
        def __array__(self, dtype=None, copy=None):
            return _F32

    got = pt_interop.to_numpy(_ArrayLike())
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert pt_interop.from_numpy_like(_F32, _ArrayLike()) is _F32


@pytest.fixture(params=["jax", "torch"])
def hvd_local(request):
    hvd, state = ((jax_hvd, jax_state) if request.param == "jax"
                  else (pt_hvd, pt_state))
    with state.local_mode():
        hvd.init()
        yield hvd


def test_collectives_hand_a_tf_tensor_back(hvd_local):
    """In local mode every collective of either package's hvd returns a
    tf.Tensor for a tf.Tensor, with its dtype and values."""
    hvd = hvd_local
    t = tf.constant([[1.0, 2.0], [3.0, 4.0]])
    i = tf.constant([5, 6], dtype=tf.int32)
    outs = [hvd.allreduce(t), hvd.allreduce(i, op=hvd.Sum),
            hvd.broadcast(t, 0), hvd.allgather(t),
            *hvd.grouped_allreduce([t, i])]
    for out, want in zip(outs, [t, i, t, t, t, i]):
        assert isinstance(out, tf.Tensor), (hvd.__name__, type(out))
        assert out.dtype == want.dtype
        np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_port_hands_back_the_jax_types(hvd_local):
    """Each input type comes back as the JAX hvd gives it back."""
    got = {}
    for name, x in _inputs().items():
        if name == "torch_bf16" and hvd_local is jax_hvd:
            continue
        got[name] = hvd_local.allreduce(x)
    want = {"numpy_f32": np.ndarray, "tf_f32": tf.Tensor,
            "tf_variable": tf.Tensor, "torch_f32": torch.Tensor,
            "py_float": float, "py_int": int, "np_scalar": float,
            "list": np.ndarray}
    for name, kind in want.items():
        assert isinstance(got[name], kind), (name, type(got[name]))
