"""Build the CUDA sources under ``csrc/`` into shared libraries at first
use, and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers and the
stream as ``void*``, sizes as ``int``, a ``cudaError_t`` returned as
``int``), so it compiles with ``nvcc`` alone in seconds — no PyTorch
headers, no extension build. The library lands in ``ops/_build/`` as
``<name>-<hash>.so``, where the hash covers the source and the flags:
an edited source builds anew, an unchanged one loads the existing file.
The build writes to a temporary name and renames it into place, so two
processes building at once cannot load half a file.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded = {}  # name -> ctypes.CDLL, one load per process


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises RuntimeError when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use")


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to, keyed by its content."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name):
    """Start nvcc on one source; returns (process, tmp, final) or None
    when the library is already built."""
    final = library_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish_build(name, started):
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{out}")
    os.replace(tmp, final)


def build(names):
    """Build every named source that is not built yet, all nvcc
    processes started together; raises on the first failure after
    every process has ended."""
    started = [(n, _start_build(n)) for n in names]
    errors = []
    for name, st in started:
        if st is None:
            continue
        try:
            _finish_build(name, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def sources():
    """Names of every CUDA source of the package."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load(name, signatures):
    """The loaded library for ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each entry point to its ctypes argument types
    (pointers and the stream as ``c_void_p``: a bare Python int would
    be passed as a 32-bit int and cut); every entry point returns a
    ``cudaError_t`` as int."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for symbol, argtypes in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib, err, what):
    """Raise if a C entry point returned a nonzero ``cudaError_t``: a
    refused launch never runs, and no later synchronize reports it."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.error_string(err).decode()}) at launch")
