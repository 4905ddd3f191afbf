"""AST lint for the pickling contract (CLI file mode and ``--self``).

Counterpart of ``sparkdl_tpu/analysis/selflint.py``.
``HorovodRunner.run(main)`` cloudpickles ``main`` and ships it to every
rank (reference runner_base.py:82-83). Two capture patterns break that
silently at source level:

- a module-level ``SparkContext``/``SparkSession`` referenced from
  ``main`` — not picklable, every worker dies at deserialization;
- a module-level tensor on a CUDA device referenced from ``main`` —
  its buffers ride the pickle to every rank and pin the driver's card
  (where the JAX rule looks for ``jnp`` / ``jax.device_put``
  constructors, this one looks for ``device=`` a CUDA device,
  ``.cuda()`` or ``.to(<cuda>)``).

The rule resolves ``HorovodRunner(...).run(f)`` call sites (direct or
through a variable), finds ``f``'s module-level FunctionDef, computes
its free names (loads not bound by params/locals, nested functions
included), and intersects them with the module's tainted bindings.

This is a *source* lint — its runtime twin in
:mod:`sparkdl_tpu_torch.analysis.preflight` checks the live function
object the launcher is about to pickle.
"""

import ast
from pathlib import Path

from sparkdl_tpu_torch.analysis.core import (
    Finding,
    Severity,
    register_rule_info,
)

RULE_ID = "pickle-closure-capture"

# Intentional captures (docs snippets, single-process examples) are
# suppressed with this comment on the module-level assignment OR on
# the capturing load line — the in-source twin of a lint allowlist.
ALLOW_COMMENT = "# sparkdl: allow-capture"

register_rule_info(
    RULE_ID, ("ERROR",),
    "Pickling contract for HorovodRunner.run mains: no captured Spark "
    "handles or module-level CUDA tensors (suppress intentional ones "
    f"with `{ALLOW_COMMENT}`).",
)

_SPARK_NAMES = {"SparkContext", "SparkSession"}
def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _mentions_spark(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _SPARK_NAMES:
            return sub.id
        if isinstance(sub, ast.Attribute) and sub.attr in _SPARK_NAMES:
            return sub.attr
    return None


def _is_cuda_device(node, cuda_names):
    """A CUDA device expression: ``"cuda"`` / ``"cuda:N"``,
    ``torch.device("cuda"...)`` (or ``type="cuda"``), or a module-level
    name bound to one."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Name):
        return node.id in cuda_names
    if isinstance(node, ast.Call) and _dotted(node.func) in (
            "torch.device", "device"):
        args = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg == "type"]
        return bool(args) and _is_cuda_device(args[0], cuda_names)
    return False


def _cuda_tensor_source(node, cuda_names):
    """The call that puts a tensor on a CUDA device (``device=`` a CUDA
    device, ``.cuda()``, ``.to(<cuda>)``), or None."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        d = _dotted(sub.func)
        if any(kw.arg == "device" and _is_cuda_device(kw.value, cuda_names)
               for kw in sub.keywords):
            return d or "<call>(device=cuda)"
        if isinstance(sub.func, ast.Attribute) and sub.func.attr == "cuda":
            return d or "<expr>.cuda"
        if (isinstance(sub.func, ast.Attribute) and sub.func.attr == "to"
                and any(_is_cuda_device(a, cuda_names) for a in sub.args)):
            return d or "<expr>.to"
    return None


def _tainted_module_bindings(tree):
    """name -> (kind, detail, lineno) for module-level assignments of
    Spark handles or CUDA tensors."""
    tainted = {}
    cuda_names = set()
    for node in tree.body:
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if _is_cuda_device(value, cuda_names):
            cuda_names.update(names)
            continue
        spark = _mentions_spark(value)
        ctor = None if spark else _cuda_tensor_source(value, cuda_names)
        if not spark and not ctor:
            continue
        for name in names:
            if spark:
                tainted[name] = ("spark", spark, node.lineno)
            else:
                tainted[name] = ("cuda-tensor", ctor, node.lineno)
    return tainted


class _Bindings(ast.NodeVisitor):
    """Names bound anywhere inside a function (params, assignments,
    imports, loop/with/except targets, nested defs)."""

    def __init__(self):
        self.bound = set()

    def visit_arguments(self, args):
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            self.bound.add(a.arg)
        if args.vararg:
            self.bound.add(args.vararg.arg)
        if args.kwarg:
            self.bound.add(args.kwarg.arg)

    def visit_FunctionDef(self, node):
        self.bound.add(node.name)
        self.visit_arguments(node.args)
        for child in node.body:
            self.visit(child)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self.visit_arguments(node.args)
        self.visit(node.body)

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.bound.add(node.id)

    def visit_Import(self, node):
        for alias in node.names:
            self.bound.add((alias.asname or alias.name).split(".")[0])

    visit_ImportFrom = visit_Import

    def visit_ExceptHandler(self, node):
        if node.name:
            self.bound.add(node.name)
        self.generic_visit(node)


def _free_loads(func):
    b = _Bindings()
    b.visit_arguments(func.args)
    for child in func.body:
        b.visit(child)
    loads = {}
    for sub in ast.walk(func):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                and sub.id not in b.bound:
            loads.setdefault(sub.id, sub.lineno)
    return loads


def _run_mains(tree):
    """Function names passed to ``<HorovodRunner(...)|runner>.run(f)``."""
    runner_vars = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = _dotted(node.value.func)
            if callee.endswith("HorovodRunner"):
                runner_vars.update(
                    t.id for t in node.targets if isinstance(t, ast.Name)
                )
    mains = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "run" and node.args):
            continue
        recv = node.func.value
        is_runner = (
            (isinstance(recv, ast.Call)
             and _dotted(recv.func).endswith("HorovodRunner"))
            or (isinstance(recv, ast.Name) and recv.id in runner_vars)
        )
        if is_runner and isinstance(node.args[0], ast.Name):
            mains.append((node.args[0].id, node.lineno))
    return mains


def lint_source(text, filename="<source>"):
    """Findings for one module's source text."""
    try:
        tree = ast.parse(text, filename=filename)
    except SyntaxError as e:
        return [Finding(
            rule_id=RULE_ID,
            severity=Severity.INFO,
            op="parse",
            location=f"{filename}:{e.lineno or 0}",
            message=f"not analyzable: {e.msg}",
        )]
    tainted = _tainted_module_bindings(tree)
    if not tainted:
        return []
    mains = _run_mains(tree)
    if not mains:
        return []
    funcs = {
        n.name: n for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    src_lines = text.splitlines()

    def _suppressed(*linenos):
        return any(
            0 < ln <= len(src_lines)
            and ALLOW_COMMENT in src_lines[ln - 1]
            for ln in linenos
        )

    findings = []
    for main_name, _ in mains:
        func = funcs.get(main_name)
        if func is None:
            continue
        for name, line in sorted(_free_loads(func).items()):
            hit = tainted.get(name)
            if hit is None:
                continue
            kind, detail, def_line = hit
            if _suppressed(def_line, line):
                continue
            what = (
                f"the module-level Spark handle {name!r} ({detail}, "
                f"line {def_line}): SparkContext/SparkSession are not "
                "picklable, so every worker dies deserializing the "
                "payload"
                if kind == "spark" else
                f"the module-level CUDA tensor {name!r} ({detail}, line "
                f"{def_line}): its device buffers ride the cloudpickle "
                "to every rank"
            )
            findings.append(Finding(
                rule_id=RULE_ID,
                severity=Severity.ERROR,
                op=name,
                location=f"{filename}:{line}",
                message=(
                    f"HorovodRunner.run main {main_name!r} captures "
                    f"{what}. Create it inside main() instead."
                ),
            ))
    return findings


def lint_paths(paths):
    """Lint every ``.py`` under the given files/directories (each file
    once, however many target paths overlap — ``examples/ --self``
    must not double-report)."""
    findings = []
    seen = set()
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            key = f.resolve()
            if key in seen:
                continue
            seen.add(key)
            try:
                text = f.read_text(errors="replace")
            except OSError as e:
                findings.append(Finding(
                    rule_id=RULE_ID, severity=Severity.INFO, op="read",
                    location=str(f), message=str(e),
                ))
                continue
            findings.extend(lint_source(text, filename=str(f)))
    return findings


def self_targets():
    """The port's own lintable surface: its package, plus the chip
    script when running from a checkout."""
    pkg = Path(__file__).resolve().parent.parent
    targets = [pkg]
    script = pkg.parent / "chip_smoke.py"
    if script.exists():
        targets.append(script)
    return targets
