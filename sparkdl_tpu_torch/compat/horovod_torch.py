"""``horovod.torch`` inside a gang of the port: an unmodified PyTorch
Horovod main (``import horovod.torch as hvd``) runs on
:mod:`sparkdl_tpu_torch.hvd`.

Counterpart of ``horovod/torch/__init__.py`` and of the package above it,
``horovod/__init__.py``: this module carries ``horovod.torch``'s names
(its ``__all__``), and :func:`install` binds it as
``sys.modules["horovod.torch"]`` under a ``horovod`` package that carries
the package's names. The port's worker installs it before it unpickles
and runs the payload; ``HorovodRunner(np=-1)`` binds the names only for
the length of ``run`` (:func:`bound`) and then restores what
``sys.modules`` held. ``horovod.tensorflow`` and ``horovod.keras`` are
not bound: importing them while the names are bound raises an
ImportError that says so.
"""

import contextlib
import importlib.abc
import sys
import types

from sparkdl_tpu_torch.hvd import (  # noqa: F401  (re-exported names)
    Average,
    Compression,
    DistributedOptimizer,
    Max,
    Min,
    Sum,
    allgather,
    allgather_object,
    allreduce,
    allreduce_,
    alltoall,
    barrier,
    broadcast,
    broadcast_,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    cross_rank,
    cross_size,
    cuda_built,
    gloo_built,
    grouped_allreduce,
    init,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    reducescatter,
    rocm_built,
    shutdown,
    size,
)

# the framework version the JAX shim's package reports
from sparkdl_tpu_torch.version import __version__  # noqa: E402

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "allreduce", "allreduce_",
    "allgather", "allgather_object", "broadcast", "broadcast_",
    "broadcast_object",
    "broadcast_parameters", "broadcast_optimizer_state", "barrier",
    "alltoall", "DistributedOptimizer", "Average", "Sum", "Min", "Max",
    "Compression",
]

# the names of the ``horovod`` package itself
PACKAGE_NAMES = (
    "Average", "Compression", "Max", "Min", "Sum", "allgather", "allreduce",
    "alltoall", "barrier", "broadcast", "allgather_object",
    "broadcast_object", "cross_rank", "cross_size", "cuda_built",
    "gloo_built", "grouped_allreduce", "init", "is_initialized",
    "local_rank", "local_size", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "nccl_built", "rank", "reducescatter",
    "rocm_built", "shutdown", "size", "__version__",
)

# frameworks whose horovod modules a gang of the port does not bind
REFUSED = ("horovod.tensorflow", "horovod.keras")


class _RefuseFrameworks(importlib.abc.MetaPathFinder):
    """Turns an import of an unbound framework module into an
    ImportError that names the reason."""

    def find_spec(self, name, path=None, target=None):
        for refused in REFUSED:
            if name == refused or name.startswith(refused + "."):
                raise ImportError(
                    f"{name} is not available in a sparkdl_tpu_torch gang: "
                    "only horovod.torch is bound (PyTorch mains); "
                    "TensorFlow and Keras mains are not ported",
                    name=name)
        return None


_FINDER = _RefuseFrameworks()


def _package():
    pkg = types.ModuleType(
        "horovod", "horovod, bound to sparkdl_tpu_torch.hvd "
                   "(sparkdl_tpu_torch.compat.horovod_torch)")
    this = sys.modules[__name__]
    for name in PACKAGE_NAMES:
        setattr(pkg, name, getattr(this, name))
    pkg.__path__ = []  # a package: its submodules come from sys.modules
    pkg.torch = this
    return pkg


def _horovod_keys():
    return [k for k in sys.modules
            if k == "horovod" or k.startswith("horovod.")]


def install():
    """Bind ``horovod`` and ``horovod.torch`` to the port for the rest of
    the process (a gang worker): whatever ``horovod`` modules were
    imported before are dropped from ``sys.modules``."""
    for key in _horovod_keys():
        del sys.modules[key]
    sys.modules["horovod"] = _package()
    sys.modules["horovod.torch"] = sys.modules[__name__]
    if _FINDER not in sys.meta_path:
        sys.meta_path.insert(0, _FINDER)


@contextlib.contextmanager
def bound():
    """:func:`install` for the length of the block; afterwards
    ``sys.modules`` holds exactly the ``horovod`` modules it held
    before."""
    saved = {k: sys.modules.pop(k) for k in _horovod_keys()}
    try:
        install()
        yield sys.modules[__name__]
    finally:
        for key in _horovod_keys():
            del sys.modules[key]
        sys.modules.update(saved)
        if _FINDER in sys.meta_path:
            sys.meta_path.remove(_FINDER)
