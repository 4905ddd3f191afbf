"""The port's public surface against the JAX package's, read from the
sources with ``ast`` (neither package is imported by the surface check).

Every public top-level function or class of a JAX module, and every
public method of such a class, has its counterpart of the same name in
the port's module of the same path (``sparkdl_tpu/a/b.py`` ->
``sparkdl_tpu_torch/a/b.py``, or the path :data:`MODULES` names): defined
there, imported there, or, for a method, defined on the class or on a
base class the port defines. A name without one stands in
:data:`EXCUSED` with its reason, and a module without one in
:data:`NO_MODULE`; the reasons are ROADMAP's (C3 and queue A's "Not in
this queue"). The ``sparkdl/`` import-name package is the JAX package's
own alias and has no port module (ROADMAP, "Not in this queue").

The last tests hold the small names ported with this check against the
JAX package's (``tree_cast``, ``registered_names``)."""

import ast
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "sparkdl_tpu", "sparkdl_tpu_torch"

# JAX modules whose counterpart lives at another path of the port
MODULES = {
    "sparkdl_tpu/ops/pallas/flash_attention.py":
        "sparkdl_tpu_torch/ops/flash_attention.py",
    "sparkdl_tpu/ops/pallas/paged_attention.py":
        "sparkdl_tpu_torch/ops/paged_attention.py",
    "sparkdl_tpu/ops/pallas/quantized_matmul.py":
        "sparkdl_tpu_torch/ops/quantized_matmul.py",
    "horovod/torch/__init__.py": "sparkdl_tpu_torch/compat/horovod_torch.py",
    "horovod/tensorflow/__init__.py":
        "sparkdl_tpu_torch/compat/horovod_tensorflow.py",
    "horovod/tensorflow/keras/__init__.py":
        "sparkdl_tpu_torch/compat/horovod_tensorflow_keras.py",
    "horovod/tensorflow/keras/callbacks.py":
        "sparkdl_tpu_torch/compat/horovod_tensorflow_keras_callbacks.py",
    "horovod/keras/__init__.py": "sparkdl_tpu_torch/compat/horovod_keras.py",
    "horovod/keras/callbacks.py":
        "sparkdl_tpu_torch/compat/horovod_keras_callbacks.py",
}

_TRACE = ("reads a jaxpr or compiled HLO text; the port's counterpart is "
          "its trace of a step, analysis/trace.py (C3, the graph lints)")

# JAX modules with no port module, each with its reason
NO_MODULE = {
    "sparkdl_tpu/analysis/hlo.py": _TRACE,
    "sparkdl_tpu/analysis/jaxpr_walk.py": _TRACE,
    "sparkdl_tpu/native/__init__.py": "the C++ control-plane ring; the "
    "port's Python LogRing stands for it (C3, Not in this queue)",
    "sparkdl_tpu/ops/pallas/__init__.py": "the Pallas package marker; "
    "the kernels are CUDA C++ under ops/csrc, their wrappers in ops/ "
    "(MODULES)",
    "sparkdl_tpu/parallel/compile.py": "the XLA executable cache: an eager "
    "PyTorch step has no executable to cache (ROADMAP, Not in this queue)",
    "sparkdl_tpu/utils/jax_compat.py": "shims over jax versions, of which "
    "the port imports none (ROADMAP, Not in this queue)",
}

_HLO_TEXT = ("parses XLA's HLO or StableHLO text; the port's passes read "
             "its trace (C3, the graph lints)")
_ENV = ("reads the environment; the port's settings are module settings "
        "read at call time (C3)")
_TRAIN_RUNNER = ("the cpu-proxy trial is the port's TrainRunner, phase "
                 "5's LoRA step (C3, tuning)")
_ATTENTION_RUNNER = ("the attention autotune runner searches the Pallas "
                     "flash tiles, TPU settings (ROADMAP, Not in this "
                     "queue)")

# public names of a JAX module with no counterpart, each with its reason
EXCUSED = {
    "sparkdl_tpu/analysis/__init__.py": {
        "lint_compiled": "lints an XLA executable; an eager PyTorch step "
        "has no compiled executable (C3, the graph lints)",
    },
    "sparkdl_tpu/analysis/passes_collectives.py": {
        "hlo_role_divergence": "the device roles of one partitioned HLO "
        "module; the port traces a gang's ranks one by one and compares "
        "them (check_gang_consistency; C3, the graph lints)",
    },
    "sparkdl_tpu/analysis/passes_comms.py": {
        "implicit_reshard": "an eager PyTorch step fed a mislaid tensor "
        "fails with a shape error and never reshards in silence (C3, the "
        "graph lints)",
        "entry_arg_shardings": _HLO_TEXT,
        "parse_hlo_sharding": _HLO_TEXT,
    },
    "sparkdl_tpu/analysis/passes_donation.py": {
        "main_args": _HLO_TEXT,
        "main_results": _HLO_TEXT,
    },
    "sparkdl_tpu/analysis/preflight.py": {
        "enabled": _ENV,
    },
    "sparkdl_tpu/horovod/control_plane.py": {
        "ControlPlaneServer.wait_ready": "the port's launcher waits on "
        "ready_count() in its own loop, which also watches the ranks' "
        "processes and ends at a dead one (C3, gang)",
        "ControlPlaneServer.done_count": "the port's launcher takes each "
        "rank's end from its process; the BYEs it keeps serve "
        "wait_drained (C3, gang)",
    },
    "sparkdl_tpu/horovod/launcher.py": {
        "SlotProbeError": "the port counts its slots with no subprocess "
        "probe (C3, GBDT)",
    },
    "sparkdl_tpu/horovod/supervisor.py": {
        "RetryPolicy.from_env": "supervisor.policy is read at call time; "
        "there is no RetryPolicy.from_env (C3, gang)",
    },
    "sparkdl_tpu/horovod/topology.py": {
        "Placement.from_env": "the hosts spec is the module setting "
        "launcher.HOSTS (C3, HorovodRunner on Spark)",
        "Placement.env_for_rank": "the TPU pod-slice variables have no "
        "counterpart; a rank binds its card by local rank (C3)",
    },
    "sparkdl_tpu/hvd/_collectives.py": {
        "engine": "the JAX collective engine caches jitted collectives "
        "over a device mesh; the port calls torch.distributed on its "
        "process group, with no engine object (C3, gang)",
    },
    "sparkdl_tpu/hvd/_state.py": {
        "ensure_jax_platform": "jax's platform selection (ROADMAP, Not in "
        "this queue)",
    },
    "sparkdl_tpu/observe/capture.py": {
        "trace_dir_name": "a capture is a torch.profiler Chrome trace, "
        "named by capture.trace_name, not an xprof directory (C3, the "
        "live tier)",
    },
    "sparkdl_tpu/observe/flightrec.py": {
        "default_events": "the ring's length is the module setting "
        "flightrec.EVENTS (C3, telemetry)",
    },
    "sparkdl_tpu/observe/trend.py": {
        "default_baseline_paths": "trend renders only the baselines the "
        "caller names; the JAX default is the repo's TPU figures (C3, the "
        "live tier)",
    },
    "sparkdl_tpu/ops/_dispatch.py": {
        "use_pallas": "the Pallas switch (ROADMAP, Not in this queue); "
        "the port's path follows the tensors' device",
    },
    "sparkdl_tpu/ops/pallas/flash_attention.py": {
        "flash_attention_bhsd": "the Pallas forward; the port's CUDA "
        "kernel is ops.flash_attention.flash_fwd (B1)",
        "flash_attention_bwd_bhsd": "the Pallas backward; the port's CUDA "
        "kernels are flash_bwd_dq and flash_bwd_dkv (B2, B3)",
    },
    "sparkdl_tpu/ops/pallas/quantized_matmul.py": {
        "quantized_matmul_pallas": "the Pallas entry; quantized_matmul "
        "launches the CUDA kernel for CUDA tensors (B5, C3)",
        "quantized_matmul_int4_pallas": "the Pallas entry; "
        "quantized_matmul_int4 launches the CUDA kernel (B6, C3)",
    },
    "sparkdl_tpu/perf/autotune.py": {
        "AttentionRunner": _ATTENTION_RUNNER,
        "AttentionRunner.attribution": _ATTENTION_RUNNER,
        "AttentionRunner.command": _ATTENTION_RUNNER,
        "AttentionRunner.pick_primary": _ATTENTION_RUNNER,
        "CpuProxyRunner": _TRAIN_RUNNER,
        "CpuProxyRunner.attribution": _TRAIN_RUNNER,
        "CpuProxyRunner.command": _TRAIN_RUNNER,
        "SubprocessTrialRunner.pick_primary": "every port runner declares "
        "its primary_metric; JAX's only shape-aware choice is "
        "AttentionRunner's",
    },
    "sparkdl_tpu/perf/profile.py": {
        "default_profile_dir": "no default profile directory: "
        "profile.PROFILE None is off (C3, tuning)",
        "preflight_env": "a profile's values reach the ranks as settings "
        "(preflight_settings, _worker.rank_settings), not the environment "
        "(C3, tuning)",
        "profile_env_delta": "a profile's values are JSON values of each "
        "setting's type, not environment strings (C3, tuning)",
    },
    "sparkdl_tpu/utils/checkpoint.py": {
        "ReshardRestoreError": "raised for orbax metadata and JAX's "
        "grouped accounting; the port raises ReshardPreflightError (C3, "
        "checkpoints)",
    },
    "sparkdl_tpu/utils/knobs.py": {
        "read_bool": "parses an environment string; the port's read "
        "returns the setting's typed value (C3, tuning)",
        "read_int": "parses an environment string; the port's read "
        "returns the setting's typed value (C3, tuning)",
    },
}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _top_level(tree):
    """The module's top-level statements, those under a top-level ``if``
    or ``try`` included."""
    todo, out = list(tree.body), []
    while todo:
        node = todo.pop(0)
        out.append(node)
        if isinstance(node, (ast.If, ast.Try)):
            todo.extend(node.body + node.orelse)
            if isinstance(node, ast.Try):
                todo.extend(node.finalbody)
                for handler in node.handlers:
                    todo.extend(handler.body)
    return out


@functools.lru_cache(maxsize=None)
def _parse_at(root, rel):
    return _top_level(ast.parse((root / rel).read_text(), filename=rel))


def _parse(rel):
    return _parse_at(ROOT, rel)


def _public(rel):
    """A JAX module's public functions and classes, and its classes'
    public methods as ``Class.method``."""
    names = set()
    for node in _parse(rel):
        if isinstance(node, _DEFS) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, _DEFS[:2])
                    and not m.name.startswith("_"))
    return names


def _module_path(module, rel, level):
    """The repo path of the port module an import names (absolute, or
    relative to ``rel``); None outside the port."""
    if level:
        base = pathlib.PurePosixPath(rel).parent
        for _ in range(level - 1):
            base = base.parent
        dotted = str(base).replace("/", ".") + (f".{module}" if module
                                                else "")
    else:
        dotted = module or ""
    if not dotted.startswith(PORT_PKG):
        return None
    path = dotted.replace(".", "/")
    for cand in (f"{path}.py", f"{path}/__init__.py"):
        if (ROOT / cand).exists():
            return cand
    return None


def _bound(rel):
    return _bound_at(ROOT, rel)


@functools.lru_cache(maxsize=None)
def _bound_at(root, rel):
    """``{name: node}`` of what a port module binds at top level: its
    definitions and assignments, and each import as ``("import", path,
    original name)`` (path None outside the port)."""
    bound = {}
    for node in _parse(rel):
        if isinstance(node, _DEFS):
            bound[node.name] = node
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    bound[target.id] = node
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                bound[node.target.id] = node
        elif isinstance(node, ast.ImportFrom):
            path = _module_path(node.module, rel, node.level)
            for alias in node.names:
                bound[alias.asname or alias.name] = ("import", path,
                                                     alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                bound[name] = ("import", None, alias.name)
    return bound


def _port_class(rel, name, depth=0):
    """(module path, ClassDef) of the port class ``name`` as module
    ``rel`` binds it, following imports from port modules; None."""
    node = _bound(rel).get(name)
    if isinstance(node, ast.ClassDef):
        return rel, node
    if isinstance(node, tuple) and node[1] is not None and depth < 8:
        return _port_class(node[1], node[2], depth + 1)
    return None


def _has_method(rel, cls, method, depth=0):
    """Whether the port class, or a port base class of it, defines or
    assigns ``method``."""
    for stmt in cls.body:
        if isinstance(stmt, _DEFS[:2]) and stmt.name == method:
            return True
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == method
                for t in stmt.targets):
            return True
    for base in cls.bases:
        if isinstance(base, ast.Name) and depth < 8:
            found = _port_class(rel, base.id)
            if found and _has_method(*found, method, depth + 1):
                return True
    return False


def _present(port_rel, name):
    bound = _bound(port_rel)
    if "." not in name:
        return name in bound
    cls_name, method = name.split(".", 1)
    found = _port_class(port_rel, cls_name)
    return found is not None and _has_method(*found, method)


def _jax_modules():
    mods = sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / JAX_PKG).rglob("*.py"))
    return mods + sorted(k for k in MODULES if not k.startswith(JAX_PKG))


def _counterpart(rel):
    return MODULES.get(rel, PORT_PKG + rel[len(JAX_PKG):])


def _missing(rel):
    port_rel = _counterpart(rel)
    return sorted(n for n in _public(rel) if not _present(port_rel, n))


@pytest.mark.parametrize("rel", [m for m in _jax_modules()
                                 if m not in NO_MODULE])
def test_every_public_name_has_its_counterpart(rel):
    port_rel = _counterpart(rel)
    assert (ROOT / port_rel).exists(), (
        f"{rel} has no port module {port_rel}; port it or give NO_MODULE "
        "its reason")
    unexplained = [n for n in _missing(rel)
                   if n not in EXCUSED.get(rel, {})]
    assert not unexplained, (
        f"{rel}: public names without their counterpart in {port_rel}: "
        f"{unexplained}; port each or give EXCUSED its reason")


def test_every_excused_name_is_still_missing():
    """An excused name the port now has, or that the JAX module no longer
    defines, leaves the dict, and so does a module the port now has."""
    stale = [f"{rel}: {n}" for rel, names in EXCUSED.items()
             for n in names if n not in _missing(rel)]
    assert not stale, f"excused but not missing: {stale}"
    ported = [rel for rel in NO_MODULE if (ROOT / _counterpart(rel)).exists()]
    assert not ported, f"NO_MODULE lists modules the port has: {ported}"


def test_every_exception_has_its_reason():
    reasons = list(NO_MODULE.values()) + [
        r for names in EXCUSED.values() for r in names.values()]
    assert reasons and all(isinstance(r, str) and len(r) > 10
                           for r in reasons)
    assert set(NO_MODULE) <= set(_jax_modules())
    assert set(EXCUSED) <= set(_jax_modules())


def test_the_check_sees_a_missing_name(tmp_path, monkeypatch):
    """The diff itself: a JAX module with a name the port module lacks,
    and a method the port class inherits from a port base."""
    jax_dir, port_dir = tmp_path / JAX_PKG, tmp_path / PORT_PKG
    jax_dir.mkdir()
    port_dir.mkdir()
    (jax_dir / "m.py").write_text(
        "class A:\n    def run(self): pass\n    def stop(self): pass\n"
        "def f(): pass\ndef g(): pass\ndef _private(): pass\n")
    (port_dir / "base.py").write_text("class Base:\n    def run(self): pass\n")
    (port_dir / "m.py").write_text(
        "from sparkdl_tpu_torch.base import Base\n"
        "class A(Base):\n    pass\ndef f(): pass\n")
    monkeypatch.setattr(sys.modules[__name__], "ROOT", tmp_path)
    assert _missing("sparkdl_tpu/m.py") == ["A.stop", "g"]


# -- the names ported with this check, against the JAX package's -----------


def test_tree_cast_is_the_jax_packages():
    import jax.numpy as jnp

    from sparkdl_tpu.parallel.train import tree_cast as jax_tree_cast
    from sparkdl_tpu_torch.parallel.train import tree_cast

    rng = np.random.default_rng(0)
    w, n = rng.standard_normal((3, 4)).astype(np.float32), np.arange(5)
    got = tree_cast({"w": torch.as_tensor(w), "n": torch.as_tensor(n),
                     "l": [torch.as_tensor(w[0])]}, torch.bfloat16)
    ref = jax_tree_cast({"w": jnp.asarray(w), "n": jnp.asarray(n),
                         "l": [jnp.asarray(w[0])]}, jnp.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and got["n"].dtype == torch.int64
    assert isinstance(got["l"], list) and got["l"][0].dtype == torch.bfloat16
    for key in ("w", "n"):
        np.testing.assert_array_equal(
            got[key].float().numpy(), np.asarray(ref[key], np.float32))
    np.testing.assert_array_equal(got["l"][0].float().numpy(),
                                  np.asarray(ref["l"][0], np.float32))
    assert tree_cast(3, torch.float16) == 3


def test_registered_names_are_the_registry():
    from sparkdl_tpu.utils import knobs as jax_knobs
    from sparkdl_tpu_torch.utils import knobs

    names = knobs.registered_names()
    assert isinstance(names, frozenset)
    assert names == frozenset(kb.name for kb in knobs.all_knobs())
    assert "registered_names" in knobs.__all__
    # the same contract as the JAX registry's: every name registered
    assert all(jax_knobs.is_registered(n)
               for n in jax_knobs.registered_names())
    assert all(knobs.is_registered(n) for n in names)
