"""``horovod.torch`` inside a gang of the port: an unmodified PyTorch
Horovod main (``import horovod.torch as hvd``) runs on
:mod:`sparkdl_tpu_torch.hvd`; and the binding of every Horovod name a
main may import.

Counterpart of ``horovod/torch/__init__.py`` and of the package above it,
``horovod/__init__.py``: this module carries ``horovod.torch``'s names
(its ``__all__``), and :func:`install` binds it as
``sys.modules["horovod.torch"]`` under a ``horovod`` package that carries
the package's names. The port's worker installs it before it unpickles
and runs the payload; ``HorovodRunner(np=-1)`` binds the names only for
the length of ``run`` (:func:`bound`) and then restores what
``sys.modules`` held.

The framework shims are bound at their first import (:data:`LAZY`):
``horovod.tensorflow``, ``horovod.tensorflow.keras`` (with
``.callbacks``), ``horovod.keras`` and ``horovod.keras.callbacks``, to
the port's modules under :mod:`sparkdl_tpu_torch.compat`; and
``sparkdl.horovod.tensorflow.keras`` (``LogCallback``) to
:mod:`sparkdl_tpu_torch.horovod.tensorflow.keras`. A shim whose
framework is not installed raises an ImportError that names the package
it needs. ``sparkdl`` and ``sparkdl.horovod`` (``log_to_driver``) are
stand-ins of the port for as long as ``horovod`` is bound, so that the
reference README's tf.keras main runs unmodified; any other ``sparkdl``
name raises an ImportError that names the port's module. A torch main
imports neither tensorflow nor keras.
"""

import contextlib
import importlib
import importlib.abc
import importlib.util
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

# the names bound at their first import: the port's module, and the
# package it needs
LAZY = {
    "horovod.tensorflow": ("sparkdl_tpu_torch.compat.horovod_tensorflow",
                           "tensorflow"),
    "horovod.tensorflow.keras": (
        "sparkdl_tpu_torch.compat.horovod_tensorflow_keras", "tensorflow"),
    "horovod.tensorflow.keras.callbacks": (
        "sparkdl_tpu_torch.compat.horovod_tensorflow_keras_callbacks",
        "tensorflow"),
    "horovod.keras": ("sparkdl_tpu_torch.compat.horovod_keras", "keras"),
    "horovod.keras.callbacks": (
        "sparkdl_tpu_torch.compat.horovod_keras_callbacks", "keras"),
    "sparkdl.horovod.tensorflow.keras": (
        "sparkdl_tpu_torch.horovod.tensorflow.keras", "tensorflow"),
}
# the import-name roots whose modules the binding owns while it holds
ROOTS = ("horovod", "sparkdl")


def _needs(package, name):
    """Raise the ImportError of shim ``name`` when ``package`` cannot be
    imported here."""
    try:
        found = (package in sys.modules
                 or importlib.util.find_spec(package) is not None)
    except (ImportError, ValueError):
        found = False
    if not found:
        raise ImportError(
            f"{name} needs the {package} package, which is not installed "
            f"here: install {package} to run this main in a "
            "sparkdl_tpu_torch gang, or write it against horovod.torch",
            name=name)


def _port_name(name):
    """The port's module for a ``sparkdl`` name without a stand-in."""
    return "sparkdl_tpu_torch" + name[len("sparkdl"):]


def _not_bound(name):
    return ImportError(
        f"{name} is not bound in a sparkdl_tpu_torch gang: use "
        f"{_port_name(name)}", name=name)


class _Binder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Binds a :data:`LAZY` name to the port's module at its first
    import (a package, so that its submodules resolve here too), and
    turns any other ``sparkdl.*`` name into an ImportError that names
    the port's module."""

    def __init__(self):
        self._specs = {}  # a bound module's own __spec__, while it loads

    def find_spec(self, name, path=None, target=None):
        if name in LAZY:
            return importlib.util.spec_from_loader(name, self,
                                                   is_package=True)
        if name.startswith("sparkdl."):
            raise _not_bound(name)
        return None

    def create_module(self, spec):
        module_name, package = LAZY[spec.name]
        _needs(package, spec.name)
        module = importlib.import_module(module_name)
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set __spec__ (and __path__ = [] where there
        # was none): the module keeps its own spec
        module.__spec__ = self._specs.pop(module.__spec__.name)


_FINDER = _Binder()


def _stand_in(name, doc, names=(), port=None):
    """A package for ``sys.modules[name]`` that carries ``names`` (from
    the module ``port``). A package: ``from <name> import <other>``
    looks for the submodule ``<name>.<other>``, which the finder refuses
    with the port's module named."""
    mod = types.ModuleType(name, doc)
    for attr in names:
        setattr(mod, attr, getattr(port, attr))
    mod.__path__ = []  # its bound submodules come from sys.modules
    return mod


def _sparkdl():
    """``sparkdl``, ``sparkdl.horovod`` and ``sparkdl.horovod.tensorflow``
    as stand-ins of the port, each its parent's attribute."""
    from sparkdl_tpu_torch import horovod as port_horovod
    from sparkdl_tpu_torch import version

    root = _stand_in("sparkdl", "sparkdl, bound to sparkdl_tpu_torch "
                     "(sparkdl_tpu_torch.compat.horovod_torch)",
                     ("__version__",), version)
    hv = _stand_in("sparkdl.horovod", "sparkdl.horovod: log_to_driver of "
                   "sparkdl_tpu_torch.horovod",
                   ("log_to_driver", "MAX_LOG_MESSAGE_LENGTH"), port_horovod)
    tf = _stand_in("sparkdl.horovod.tensorflow", "sparkdl.horovod."
                   "tensorflow: its keras submodule is "
                   "sparkdl_tpu_torch.horovod.tensorflow.keras")
    root.horovod, hv.tensorflow = hv, tf
    return {"sparkdl": root, "sparkdl.horovod": hv,
            "sparkdl.horovod.tensorflow": tf}


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


def _bound_keys():
    return [k for k in sys.modules
            if k in ROOTS or k.startswith(tuple(r + "." for r in ROOTS))]


def install():
    """Bind ``horovod`` and ``horovod.torch`` to the port, the framework
    shims at their first import, and the ``sparkdl`` stand-ins, for the
    rest of the process (a gang worker): whatever ``horovod`` and
    ``sparkdl`` modules were imported before are dropped from
    ``sys.modules``."""
    for key in _bound_keys():
        del sys.modules[key]
    sys.modules["horovod"] = _package()
    sys.modules["horovod.torch"] = sys.modules[__name__]
    sys.modules.update(_sparkdl())
    if _FINDER not in sys.meta_path:
        sys.meta_path.insert(0, _FINDER)


@contextlib.contextmanager
def bound():
    """:func:`install` for the length of the block; afterwards
    ``sys.modules`` holds exactly the ``horovod`` and ``sparkdl``
    modules it held before."""
    saved = {k: sys.modules.pop(k) for k in _bound_keys()}
    try:
        install()
        yield sys.modules[__name__]
    finally:
        for key in _bound_keys():
            del sys.modules[key]
        sys.modules.update(saved)
        if _FINDER in sys.meta_path:
            sys.meta_path.remove(_FINDER)
