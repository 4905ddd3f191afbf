"""Concurrency lint for the runtime (CLI ``--concur``).

Counterpart of ``sparkdl_tpu/analysis/concur.py``. The port's runtime
runs many threads: the control plane and its log ring, the heartbeats,
``/statusz``, the alert engine, the forensics manager, the elastic
controller, the fleet's engine threads and its gang replicas. Five
whole-program AST rules over its Python:

- ``lock-order-cycle`` — a cross-module lock-acquisition-order graph
  built from lexical ``with <lock>`` nesting plus resolved calls; a
  cycle means two threads can take the same locks in opposite orders.
- ``blocking-call-under-lock`` — socket recv/accept/sendall,
  ``Thread.join``, blocking ``queue.get``, subprocess waits, Event /
  collective / Future ``.wait()``/``.result()`` while a Lock, RLock
  or Condition is held, directly or through a resolved callee.
- ``unguarded-shared-state`` — an instance attribute written both
  from a thread entrypoint (``Thread(target=self.m)`` closure) and
  from other methods, with at least one write under no lock.
- ``thread-lifecycle`` — non-daemon threads that are never joined;
  ``Condition.wait`` outside a ``while``-predicate loop; waiting on a
  Condition while also holding an unrelated lock.
- ``collective-enqueue-off-thread`` — a callable handed to
  ``pool.submit``/``Thread(target=...)`` whose body *enqueues* a
  collective: a ``torch.distributed`` call, a collective method of the
  port's :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` (on a receiver
  named ``mesh``), or an ``hvd`` ``*_start`` dispatch half (where the
  JAX lint matches ``jax.lax``'s collectives). Collectives must be
  enqueued on the calling thread so the program order is identical
  across ranks; only the blocking *finish* half may ride a helper
  thread (see ``hvd/_collectives.py``).

The lint is heuristic on purpose: resolution is name-based (same
class, same module, then globally-unique method names), ``with
lock.acquire()``-style manual pairing is out of scope, and intra-line
suppression uses ``# sparkdl: concur-ok``. Everything it still gets
wrong lives in the committed waiver baseline
(``concur_baseline.json``) with a reason per entry, so a gate fails on
NEW findings only. The runtime twin — the observed lock-order graph —
is :mod:`sparkdl_tpu_torch.utils.locksan`.
"""

import ast
import json
import re
from pathlib import Path

from sparkdl_tpu_torch.analysis.core import (
    Finding,
    Severity,
    register_rule_info,
)

RULE_LOCK_ORDER = "lock-order-cycle"
RULE_BLOCKING = "blocking-call-under-lock"
RULE_SHARED_STATE = "unguarded-shared-state"
RULE_LIFECYCLE = "thread-lifecycle"
RULE_COLLECTIVE = "collective-enqueue-off-thread"

# Intentional sites are suppressed in-source with this comment on the
# flagged line (same idiom as selflint's allow-capture); everything
# else goes through the waiver baseline, which carries a reason.
ALLOW_COMMENT = "# sparkdl: concur-ok"

BASELINE_SCHEMA = "sparkdl_tpu.analysis.concur_baseline/1"
REPORT_SCHEMA = "sparkdl_tpu.analysis.concur_report/1"
DEFAULT_BASELINE = Path(__file__).parent / "concur_baseline.json"

register_rule_info(
    RULE_LOCK_ORDER, ("ERROR", "INFO"),
    "Cross-module lock-acquisition-order graph: a cycle means two "
    "threads can take the same locks in opposite orders and deadlock.",
)
register_rule_info(
    RULE_BLOCKING, ("ERROR",),
    "Blocking call (socket, Thread.join, queue.get, subprocess, "
    "Event/collective/Future wait) while a Lock/RLock/Condition is "
    "held — directly or via a resolved callee.",
)
register_rule_info(
    RULE_SHARED_STATE, ("WARNING",),
    "Instance attribute written from a thread entrypoint AND from "
    "other methods with at least one write under no lock.",
)
register_rule_info(
    RULE_LIFECYCLE, ("WARNING",),
    "Thread-lifecycle hygiene: non-daemon threads never joined, "
    "Condition.wait outside a while-predicate loop, waiting while "
    "holding an unrelated lock.",
)
register_rule_info(
    RULE_COLLECTIVE, ("ERROR",),
    "Device-collective ENQUEUE from a helper thread (pool submit / "
    "Thread target): program order must be identical across ranks, "
    "so only the blocking finish half may ride a pool.",
)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
_COND_CTORS = {"threading.Condition", "Condition"}
_EVENT_CTORS = {"threading.Event", "Event"}
_QUEUE_CTORS = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "Queue", "SimpleQueue",
}
_SOCK_CTORS = {"socket.socket", "socket.create_connection"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
_EXEC_CTORS = {
    "ThreadPoolExecutor", "futures.ThreadPoolExecutor",
    "concurrent.futures.ThreadPoolExecutor",
}

# Method names too common to resolve by global uniqueness — calling
# through these would let one repo class's `close()` taint every
# `x.close()` call site in the tree.
_ATTR_NO_RESOLVE = {
    "append", "extend", "add", "remove", "pop", "clear", "update",
    "get", "put", "items", "keys", "values", "write", "read", "flush",
    "close", "open", "encode", "decode", "split", "strip", "format",
    "copy", "sort", "join", "start", "stop", "run", "wait", "result",
    "submit", "send", "recv", "sendall", "acquire", "release",
    "info", "warning", "error", "debug", "exception", "log",
}

# torch.distributed's collectives and point-to-point calls
_COLLECTIVE_CALL = re.compile(
    r"^(torch\.distributed|dist)\.(all_reduce|all_gather|"
    r"all_gather_into_tensor|all_gather_object|all_to_all|"
    r"all_to_all_single|reduce_scatter|reduce_scatter_tensor|reduce|"
    r"broadcast|broadcast_object_list|barrier|gather|scatter|send|recv|"
    r"isend|irecv|batch_isend_irecv)$"
)
# the port's Mesh methods that issue collectives, on a receiver whose
# last name holds "mesh" (``mesh.all_reduce``, ``self.tp.mesh.ppermute``)
_MESH_COLLECTIVES = {"all_reduce", "all_gather", "reduce_scatter",
                     "broadcast", "all_to_all", "ppermute",
                     "ppermute_start"}
# The repo's dispatch-half convention (hvd reduce_start /
# _reduce_start): a bare `start()` or any `*_start(...)` call is
# the enqueue half. `<thread>.start()` (attr exactly "start", no
# underscore) is NOT a dispatch half.
_START_SUFFIX = re.compile(r"_start$")


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _lockish(name):
    n = name.lower()
    return ("lock" in n or "mutex" in n or n.endswith("_mu")
            or n.endswith("cond") or n.endswith("_cv"))


def _self_attr(expr):
    """'X' for a ``self.X`` expression, else None."""
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _recv_tail(expr):
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


def _module_name(path):
    parts = list(Path(path).parts)
    if "sparkdl_tpu_torch" in parts:
        parts = parts[parts.index("sparkdl_tpu_torch"):]
    else:
        parts = parts[-1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<module>"


class _ClassIndex:
    def __init__(self, name):
        self.name = name
        self.lock_attrs = {}     # attr -> lineno
        self.cond_attrs = {}     # attr -> aliased lock id or None
        self.event_attrs = set()
        self.queue_attrs = set()
        self.sock_attrs = set()
        self.thread_attrs = set()
        self.exec_attrs = set()
        self.methods = {}        # name -> _FuncInfo
        self.thread_targets = set()

    def managed(self, attr):
        return (attr in self.lock_attrs or attr in self.cond_attrs
                or attr in self.event_attrs or attr in self.queue_attrs
                or attr in self.sock_attrs or attr in self.thread_attrs
                or attr in self.exec_attrs)


class _FuncInfo:
    def __init__(self, node, module, cls, name):
        self.node = node
        self.module = module
        self.cls = cls
        self.name = name
        self.qualname = ".".join(
            p for p in (module, cls, name) if p)
        self.acquires = []        # (lock_id, lineno)
        self.acq_edges = []       # (held_id, lock_id, lineno)
        self.blocking_events = [] # (op, why, lineno, held_tuple)
        self.call_events = []     # (kind, target, lineno, held, desc)
        self.writes = []          # (attr, lineno, guarded)
        self.thread_ctors = []    # dict events
        self.submits = []         # (callable_node, lineno, desc, local_defs)
        self.cond_waits = []      # (attr, lineno, held, in_loop, wait_for)
        # Resolved closures (filled by _Program):
        self.trans_acquires = set()
        self.block = None         # (op, why, chain_tuple)

    def direct_block(self):
        if self.blocking_events:
            op, why, lineno, _held = self.blocking_events[0]
            return (op, why, ())
        return None


class _ModuleIndex:
    """Everything the whole-program phase needs to know about one
    parsed file."""

    def __init__(self, path, text, tree):
        self.path = str(path)
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        self.module = _module_name(path)
        self.mod_locks = {}      # name -> lineno
        self.mod_conds = {}      # name -> aliased id or None
        self.classes = {}        # class name -> _ClassIndex
        self.functions = {}      # qualname -> _FuncInfo
        self._index()

    # -- pass 1: tables -------------------------------------------------

    def _index(self):
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                ctor = _dotted(node.value.func)
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if ctor in _LOCK_CTORS:
                        self.mod_locks[t.id] = node.lineno
                    elif ctor in _COND_CTORS:
                        self.mod_conds[t.id] = self._cond_alias(
                            node.value, cls=None)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                fi = _FuncInfo(node, self.module, None, node.name)
                self.functions[fi.qualname] = fi
            elif isinstance(node, ast.ClassDef):
                ci = _ClassIndex(node.name)
                self.classes[node.name] = ci
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fi = _FuncInfo(sub, self.module, node.name,
                                       sub.name)
                        ci.methods[sub.name] = fi
                        self.functions[fi.qualname] = fi
                self._classify_attrs(node, ci)

    def _cond_alias(self, call, cls):
        """Condition(X): the id of the lock the condition wraps, so
        ``with cond:`` and ``with lock:`` are the same graph node."""
        if not call.args:
            return None
        arg = call.args[0]
        attr = _self_attr(arg)
        if attr is not None and cls is not None:
            return f"{self.module}.{cls}.{attr}"
        if isinstance(arg, ast.Name):
            return f"{self.module}.{arg.id}"
        return None

    def _classify_attrs(self, cnode, ci):
        for node in ast.walk(cnode):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            ctor = _dotted(node.value.func)
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if ctor in _LOCK_CTORS:
                    ci.lock_attrs[attr] = node.lineno
                elif ctor in _COND_CTORS:
                    ci.cond_attrs[attr] = self._cond_alias(
                        node.value, cls=ci.name)
                elif ctor in _EVENT_CTORS:
                    ci.event_attrs.add(attr)
                elif ctor in _QUEUE_CTORS:
                    ci.queue_attrs.add(attr)
                elif ctor in _SOCK_CTORS:
                    ci.sock_attrs.add(attr)
                elif ctor in _THREAD_CTORS:
                    ci.thread_attrs.add(attr)
                elif ctor in _EXEC_CTORS:
                    ci.exec_attrs.add(attr)

    def suppressed(self, lineno):
        return (0 < lineno <= len(self.lines)
                and ALLOW_COMMENT in self.lines[lineno - 1])

    # -- pass 2: per-function scan --------------------------------------

    def scan(self):
        for fi in self.functions.values():
            _scan_func(self, fi)

    def lock_id(self, expr, fi, local_locks):
        """Canonical graph-node id for a with-item, or None when the
        expression is not recognizably a lock."""
        attr = _self_attr(expr)
        if attr is not None and fi.cls is not None:
            ci = self.classes[fi.cls]
            if attr in ci.cond_attrs:
                return (ci.cond_attrs[attr]
                        or f"{self.module}.{fi.cls}.{attr}")
            if attr in ci.lock_attrs or _lockish(attr):
                return f"{self.module}.{fi.cls}.{attr}"
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.mod_conds:
                return (self.mod_conds[expr.id]
                        or f"{self.module}.{expr.id}")
            if expr.id in self.mod_locks:
                return f"{self.module}.{expr.id}"
            if expr.id in local_locks or _lockish(expr.id):
                return f"{self.module}.{fi.name}.{expr.id}"
            return None
        d = _dotted(expr)
        if d and _lockish(d.split(".")[-1]):
            return d
        return None


def _has_nonblocking_kw(call):
    for kw in call.keywords:
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _is_str_join(call):
    """``", ".join(parts)`` vs ``thread.join(timeout)``."""
    f = call.func
    recv = f.value
    if isinstance(recv, ast.Constant):
        return True
    d = _dotted(recv)
    if d in ("os.path", "posixpath", "ntpath", "path"):
        return True
    if len(call.args) == 1 and not call.keywords:
        a = call.args[0]
        if isinstance(a, (ast.ListComp, ast.GeneratorExp, ast.List,
                          ast.Tuple, ast.JoinedStr)):
            return True
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return True
        if isinstance(a, ast.Call) and _dotted(a.func) in (
                "sorted", "map", "str", "repr", "reversed"):
            return True
    return False


_SOCK_TOKENS = ("sock", "conn", "srv", "sck")


def _classify_blocking(mi, fi, call):
    """(op, why) when this call can block the calling thread."""
    f = call.func
    d = _dotted(f)
    if d == "time.sleep":
        return (d, "sleeps")
    if d == "socket.create_connection":
        return (d, "dials a TCP connection (30s-class timeout)")
    if d == "select.select":
        return (d, "blocks in select()")
    parts = d.split(".")
    if len(parts) == 2 and parts[0] == "subprocess" and parts[1] in (
            "run", "call", "check_call", "check_output"):
        return (d, "waits for a subprocess")
    if not isinstance(f, ast.Attribute):
        return None
    attr = f.attr
    sx = _self_attr(f.value)
    ci = mi.classes.get(fi.cls) if fi.cls else None
    low = (sx or _recv_tail(f.value)).lower()

    def known(group):
        return ci is not None and sx is not None and sx in group

    if attr in ("recv", "recv_into", "accept", "connect", "makefile",
                "sendall"):
        if known(ci.sock_attrs if ci else ()) or any(
                tok in low for tok in _SOCK_TOKENS):
            return (d or f"<expr>.{attr}",
                    f"blocks on the socket ({attr})")
        return None
    if attr == "join":
        if _is_str_join(call):
            return None
        return (d or f"<expr>.{attr}", "joins a thread/process")
    if attr == "shutdown" and (known(ci.exec_attrs if ci else ())
                               or "pool" in low or "exec" in low):
        return (d, "waits for executor shutdown")
    if attr == "get":
        if (known(ci.queue_attrs if ci else ()) or "queue" in low
                or low in ("q", "_q")) and not _has_nonblocking_kw(call):
            return (d or f"<expr>.{attr}", "blocks on queue.get")
        return None
    if attr == "communicate":
        return (d or f"<expr>.{attr}", "waits for a subprocess")
    if attr == "result":
        return (d or f"<expr>.{attr}", "blocks on a Future result")
    if attr == "wait":
        if known(ci.cond_attrs if ci else ()):
            return None  # handled with held-lock context in the walker
        if (known(ci.event_attrs if ci else ()) or "event" in low
                or "stop" in low or "closed" in low or "done" in low):
            return (d or f"<expr>.{attr}", "waits on an Event")
        return (d or f"<expr>.{attr}",
                "blocks in .wait() (collective/process/future)")
    return None


def _call_key(call):
    """How to resolve this call later: ('self', m) / ('name', n) /
    ('attr', a), plus a printable description."""
    f = call.func
    d = _dotted(f)
    if isinstance(f, ast.Name):
        return ("name", f.id, d or f.id)
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id == "self":
            return ("self", f.attr, d)
        return ("attr", f.attr, d or f"<expr>.{f.attr}")
    return (None, None, d)


def _is_exec_submit(mi, fi, call):
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "submit"
            and call.args):
        return False
    sx = _self_attr(f.value)
    ci = mi.classes.get(fi.cls) if fi.cls else None
    low = (sx or _recv_tail(f.value)).lower()
    return ((ci is not None and sx in ci.exec_attrs)
            or "pool" in low or "exec" in low)


def _scan_func(mi, fi):
    local_locks = set()
    local_defs = {}

    for sub in ast.walk(fi.node):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and sub is not fi.node:
            local_defs[sub.name] = sub

    def on_thread_ctor(call, assigned, lineno):
        daemon = None
        name_kw = None
        target = None
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
            elif kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name_kw = str(kw.value.value)
            elif kw.arg == "target":
                target = kw.value
        fi.thread_ctors.append({
            "assigned": assigned, "daemon": daemon, "name": name_kw,
            "target": target, "lineno": lineno,
        })
        tattr = _self_attr(target) if target is not None else None
        if tattr is not None and fi.cls is not None:
            mi.classes[fi.cls].thread_targets.add(tattr)
        if target is not None:
            fi.submits.append((target, lineno,
                               f"Thread(target={_dotted(target) or '<callable>'})",
                               local_defs))

    def on_call(call, held, loops):
        lineno = call.lineno
        d = _dotted(call.func)
        # thread construction (bare, not via Assign — e.g. chained
        # `.start()`); assigned form is handled in on_assign.
        if d in _THREAD_CTORS and not getattr(call, "_concur_seen", False):
            on_thread_ctor(call, None, lineno)
        if _is_exec_submit(mi, fi, call):
            fi.submits.append((call.args[0], lineno,
                               f"{d or 'pool.submit'}({_dotted(call.args[0]) or '<callable>'})",
                               local_defs))
            sx = _self_attr(call.args[0])
            if sx is not None and fi.cls is not None:
                mi.classes[fi.cls].thread_targets.add(sx)
        # condition waits (need held context)
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in ("wait",
                                                       "wait_for"):
            sx = _self_attr(f.value)
            ci = mi.classes.get(fi.cls) if fi.cls else None
            if ci is not None and sx in ci.cond_attrs:
                fi.cond_waits.append((sx, lineno, tuple(held),
                                      loops > 0, f.attr == "wait_for"))
        reason = _classify_blocking(mi, fi, call)
        if reason is not None:
            fi.blocking_events.append(
                (reason[0], reason[1], lineno, tuple(held)))
        kind, target, desc = _call_key(call)
        if kind is not None:
            fi.call_events.append((kind, target, lineno, tuple(held),
                                   desc))

    def on_assign(node, held):
        value = getattr(node, "value", None)
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        if isinstance(value, ast.Call):
            ctor = _dotted(value.func)
            if ctor in _LOCK_CTORS or ctor in _COND_CTORS:
                for t in targets:
                    if isinstance(t, ast.Name):
                        local_locks.add(t.id)
            if ctor in _THREAD_CTORS:
                assigned = None
                for t in targets:
                    assigned = _dotted(t) or assigned
                value._concur_seen = True
                on_thread_ctor(value, assigned, node.lineno)
        for t in targets:
            attr = _self_attr(t)
            if attr is None and isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
            if attr is not None:
                fi.writes.append((attr, node.lineno, bool(held)))

    def walk(node, held, loops):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = []
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        on_call(sub, held, loops)
                lid = mi.lock_id(item.context_expr, fi, local_locks)
                if lid is not None:
                    fi.acquires.append((lid, node.lineno))
                    for h in held:
                        if h != lid:
                            fi.acq_edges.append((h, lid, node.lineno))
                    new.append(lid)
            inner = held + [x for x in new if x not in held]
            for stmt in node.body:
                walk(stmt, inner, loops)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def's body runs later, on whatever thread calls
            # it — the lexical lock stack does not apply.
            for stmt in node.body:
                walk(stmt, [], loops)
            return
        if isinstance(node, ast.Lambda):
            walk(node.body, [], loops)
            return
        if isinstance(node, ast.While):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call):
                    on_call(sub, held, loops + 1)
            for stmt in node.body + node.orelse:
                walk(stmt, held, loops + 1)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            on_assign(node, held)
            value = getattr(node, "value", None)
            if value is not None:
                walk(value, held, loops)
            return
        if isinstance(node, ast.Call):
            on_call(node, held, loops)
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                walk(a, held, loops)
            walk(node.func, held, loops)
            return
        # mutator calls on self attrs count as writes
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Call):
            call = node.value
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in (
                    "append", "extend", "add", "remove", "pop",
                    "clear", "update", "insert", "setdefault"):
                attr = _self_attr(f.value)
                if attr is not None:
                    fi.writes.append((attr, node.lineno, bool(held)))
            walk(call, held, loops)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held, loops)

    for stmt in fi.node.body:
        walk(stmt, [], 0)


# -- whole-program phase ------------------------------------------------------


class _Program:
    def __init__(self, indexes):
        self.indexes = indexes
        self.funcs = {}
        self.methods_by_name = {}
        self.funcs_by_name = {}
        self.classes_by_name = {}
        for mi in indexes:
            for fi in mi.functions.values():
                self.funcs[fi.qualname] = fi
                if fi.cls is None:
                    self.funcs_by_name.setdefault(fi.name, []).append(fi)
                else:
                    self.methods_by_name.setdefault(fi.name,
                                                    []).append(fi)
            for cname, ci in mi.classes.items():
                self.classes_by_name.setdefault(cname,
                                                []).append((mi, ci))
        self._close()

    def resolve(self, mi, fi, kind, target):
        if kind == "self" and fi.cls is not None:
            return mi.classes[fi.cls].methods.get(target)
        if kind == "name":
            hit = mi.functions.get(f"{mi.module}.{target}")
            if hit is not None:
                return hit
            if target in mi.classes:
                return mi.classes[target].methods.get("__init__")
            cands = self.funcs_by_name.get(target, [])
            if len(cands) == 1:
                return cands[0]
            ccands = self.classes_by_name.get(target, [])
            if len(ccands) == 1:
                return ccands[0][1].methods.get("__init__")
            return None
        if kind == "attr":
            if target in _ATTR_NO_RESOLVE:
                return None
            cands = self.methods_by_name.get(target, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def _close(self):
        """Fixpoint: transitive lock acquisitions + a does-it-block
        verdict per function, propagated through resolved calls."""
        by_mod = {mi.module: mi for mi in self.indexes}
        for fi in self.funcs.values():
            fi.trans_acquires = {lid for lid, _ in fi.acquires}
            fi.block = fi.direct_block()
        for _ in range(6):
            changed = False
            for fi in self.funcs.values():
                mi = by_mod[fi.module]
                for kind, target, lineno, _held, desc in fi.call_events:
                    cal = self.resolve(mi, fi, kind, target)
                    if cal is None or cal is fi:
                        continue
                    if not cal.trans_acquires <= fi.trans_acquires:
                        fi.trans_acquires |= cal.trans_acquires
                        changed = True
                    if fi.block is None and cal.block is not None:
                        op, why, chain = cal.block
                        if len(chain) < 4:
                            fi.block = (op, why,
                                        (cal.qualname,) + chain)
                            changed = True
            if not changed:
                break


def _render_chain(chain):
    return " -> ".join(chain)


def _lint_program(indexes):
    prog = _Program(indexes)
    by_mod = {mi.module: mi for mi in indexes}
    findings = []
    # lock-order edges: (a, b) -> (location, via)
    edges = {}
    seen = set()

    def emit(rule, sev, op, mi, lineno, message):
        if mi.suppressed(lineno):
            return
        key = (rule, mi.path, lineno, op)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            rule_id=rule, severity=sev, op=op,
            location=f"{mi.path}:{lineno}", message=message,
        ))

    for mi in indexes:
        for fi in mi.functions.values():
            for a, b, lineno in fi.acq_edges:
                edges.setdefault((a, b),
                                 (f"{mi.path}:{lineno}", fi.qualname))
            for op, why, lineno, held in fi.blocking_events:
                if not held:
                    continue
                emit(RULE_BLOCKING, Severity.ERROR, op, mi, lineno,
                     f"{op} {why} while holding {held[-1]} — every "
                     "thread contending for that lock stalls behind "
                     "it; move the blocking call outside the lock")
            for kind, target, lineno, held, desc in fi.call_events:
                cal = prog.resolve(mi, fi, kind, target)
                if cal is None or cal is fi:
                    continue
                if held:
                    for lid in sorted(cal.trans_acquires):
                        if lid not in held:
                            edges.setdefault(
                                (held[-1], lid),
                                (f"{mi.path}:{lineno}",
                                 f"{fi.qualname} -> {cal.qualname}"))
                    if cal.block is not None and not cal.blocking_events:
                        # direct blocking inside cal is reported at
                        # cal itself only when cal ALSO holds a lock;
                        # the caller-side report is the held one.
                        pass
                    if cal.block is not None:
                        op, why, chain = cal.block
                        via = _render_chain(
                            (cal.qualname,) + chain) if chain else \
                            cal.qualname
                        emit(RULE_BLOCKING, Severity.ERROR, desc, mi,
                             lineno,
                             f"calls {via}, which {why} ({op}), while "
                             f"holding {held[-1]} — the lock is held "
                             "across a blocking operation; release it "
                             "before the call")
            for sx, lineno, held, in_loop, is_wait_for in fi.cond_waits:
                ci = mi.classes[fi.cls]
                cid = (ci.cond_attrs.get(sx)
                       or f"{mi.module}.{fi.cls}.{sx}")
                others = [h for h in held if h != cid]
                if others:
                    emit(RULE_BLOCKING, Severity.ERROR,
                         f"self.{sx}.wait", mi, lineno,
                         f"Condition.wait on self.{sx} releases only "
                         f"its own lock; {others[-1]} stays held for "
                         "the whole wait")
                if not in_loop and not is_wait_for:
                    emit(RULE_LIFECYCLE, Severity.WARNING,
                         f"{fi.cls}.{sx}.wait", mi, lineno,
                         f"Condition.wait on self.{sx} outside a "
                         "while-predicate loop: spurious wakeups and "
                         "missed notifies are legal — re-check the "
                         "predicate in a while loop (or use wait_for)")
            for tc in fi.thread_ctors:
                if tc["daemon"]:
                    continue
                assigned = tc["assigned"]
                joined = assigned is not None and (
                    f"{assigned}.join" in mi.text)
                daemon_later = assigned is not None and (
                    f"{assigned}.daemon" in mi.text)
                if joined or daemon_later:
                    continue
                op = tc["name"] or assigned or "Thread"
                emit(RULE_LIFECYCLE, Severity.WARNING, op, mi,
                     tc["lineno"],
                     "non-daemon thread is never joined: interpreter "
                     "shutdown blocks on it after a crash; pass "
                     "daemon=True or join it on the shutdown path")
            for cnode, lineno, desc, local_defs in fi.submits:
                hit = _collective_in_callable(prog, mi, fi, cnode,
                                              local_defs)
                if hit is not None:
                    emit(RULE_COLLECTIVE, Severity.ERROR, desc, mi,
                         lineno,
                         f"{desc} hands a collective ENQUEUE "
                         f"({hit}) to a helper thread: backend "
                         "submission order then depends on a per-rank "
                         "race with the step thread and the gang can "
                         "deadlock (the JAX package's hvd.allreduce_async "
                         "bug). "
                         "Enqueue on the calling thread; only the "
                         "blocking finish half may ride the pool")

    # unguarded shared state, per class
    for mi in indexes:
        for cname, ci in mi.classes.items():
            if not ci.thread_targets:
                continue
            entry = _entry_closure(ci)
            writes = {}
            for mname, meth in ci.methods.items():
                for attr, lineno, guarded in meth.writes:
                    writes.setdefault(attr, []).append(
                        (mname, lineno, guarded))
            for attr, ws in sorted(writes.items()):
                if ci.managed(attr):
                    continue
                e_ws = [w for w in ws
                        if w[0] in entry and w[0] != "__init__"]
                o_ws = [w for w in ws
                        if w[0] not in entry and w[0] != "__init__"]
                if not e_ws or not o_ws:
                    continue
                unguarded = [w for w in e_ws + o_ws if not w[2]]
                if not unguarded:
                    continue
                m, lineno, _g = unguarded[0]
                others = sorted({w[0] for w in e_ws + o_ws} - {m})
                emit(RULE_SHARED_STATE, Severity.WARNING,
                     f"{cname}.{attr}", mi, lineno,
                     f"self.{attr} is written from thread entrypoint "
                     f"method(s) and from {', '.join(others)} with at "
                     f"least one write (here, in {m}) under no lock — "
                     "guard every write with the owning lock or make "
                     "the field single-writer")

    findings.extend(_cycle_findings(edges, by_mod))
    findings.sort(key=lambda f: (-int(f.severity), f.location))
    return findings


def _entry_closure(ci):
    """Thread-target methods plus everything they reach via self
    calls — the set of methods that run on the spawned thread."""
    entry = set(ci.thread_targets)
    frontier = list(entry)
    while frontier:
        m = frontier.pop()
        fi = ci.methods.get(m)
        if fi is None:
            continue
        for kind, target, _ln, _held, _d in fi.call_events:
            if kind == "self" and target in ci.methods \
                    and target not in entry:
                entry.add(target)
                frontier.append(target)
    return entry


def _collective_in_callable(prog, mi, fi, cnode, local_defs):
    """The offending call's printable name when the submitted
    callable transitively ENQUEUES a collective, else None."""
    body = None
    if isinstance(cnode, ast.Lambda):
        body = cnode
    elif isinstance(cnode, ast.Name):
        body = local_defs.get(cnode.id)
        if body is None:
            hit = mi.functions.get(f"{mi.module}.{cnode.id}")
            body = hit.node if hit is not None else None
    else:
        sx = _self_attr(cnode)
        if sx is not None and fi.cls is not None:
            hit = mi.classes[fi.cls].methods.get(sx)
            body = hit.node if hit is not None else None
    if body is None:
        return None
    for sub in ast.walk(body):
        if not isinstance(sub, ast.Call):
            continue
        d = _dotted(sub.func)
        if d and _COLLECTIVE_CALL.match(d):
            return d
        tail = d.split(".")[-1] if d else ""
        recv = d.split(".")[-2] if d.count(".") else ""
        if tail in _MESH_COLLECTIVES and "mesh" in recv.lower():
            return d
        if isinstance(sub.func, ast.Name) and (
                sub.func.id == "start" or _START_SUFFIX.search(
                    sub.func.id)):
            return sub.func.id
        if isinstance(sub.func, ast.Attribute) and _START_SUFFIX.search(
                tail):
            return d
    return None


def _cycle_findings(edges, by_mod):
    """One ERROR per strongly connected component of the observed
    lock-order graph (self-edges skipped: distinct instances of the
    same per-object lock attribute legitimately nest)."""
    adj = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
    sccs = _tarjan(adj)
    out = []
    for comp in sccs:
        if len(comp) < 2:
            continue
        comp = sorted(comp)
        parts = []
        loc = ""
        for i, a in enumerate(comp):
            b = comp[(i + 1) % len(comp)]
            # find a concrete witness edge inside the component
            for (x, y), (where, via) in sorted(edges.items()):
                if x == a and y in comp and y != a:
                    parts.append(f"{x} -> {y} (at {where}, via {via})")
                    loc = loc or where
                    break
        out.append(Finding(
            rule_id=RULE_LOCK_ORDER, severity=Severity.ERROR,
            op=" <-> ".join(comp), location=loc,
            message=("lock-order cycle: " + "; ".join(parts)
                     + " — two threads taking these locks in opposite "
                       "orders deadlock; pick one global order"),
        ))
    return out


def _tarjan(adj):
    index = {}
    low = {}
    onstack = set()
    stack = []
    sccs = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        onstack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in onstack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in list(adj):
        if v not in index:
            strongconnect(v)
    return sccs


# -- entry points -------------------------------------------------------------


def lint_source(text, filename="<source>"):
    """Findings for one module's source text (unit-test entry)."""
    try:
        tree = ast.parse(text, filename=filename)
    except SyntaxError as e:
        return [Finding(
            rule_id=RULE_LOCK_ORDER, severity=Severity.INFO,
            op="parse", location=f"{filename}:{e.lineno or 0}",
            message=f"not analyzable: {e.msg}",
        )]
    mi = _ModuleIndex(filename, text, tree)
    mi.scan()
    return _lint_program([mi])


def lint_paths(paths):
    """Whole-program lint over every ``.py`` under the given
    files/directories (deduplicated)."""
    indexes = []
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
                    rule_id=RULE_LOCK_ORDER, severity=Severity.INFO,
                    op="read", location=str(f), message=str(e),
                ))
                continue
            try:
                tree = ast.parse(text, filename=str(f))
            except SyntaxError as e:
                findings.append(Finding(
                    rule_id=RULE_LOCK_ORDER, severity=Severity.INFO,
                    op="parse", location=f"{f}:{e.lineno or 0}",
                    message=f"not analyzable: {e.msg}",
                ))
                continue
            mi = _ModuleIndex(f, text, tree)
            mi.scan()
            indexes.append(mi)
    findings.extend(_lint_program(indexes))
    return findings


def self_runtime_targets():
    """What ``--concur`` lints by default: the port's package."""
    return [Path(__file__).resolve().parent.parent]


# -- waiver baseline ----------------------------------------------------------


def load_baseline(path=None):
    """The committed waiver list: ``[{rule, path, op, reason}, ...]``.
    Matching is by rule id + path suffix + op — never line numbers,
    so unrelated edits don't invalidate waivers."""
    p = Path(path) if path else DEFAULT_BASELINE
    if not p.exists():
        return []
    doc = json.loads(p.read_text())
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"unrecognized baseline schema {doc.get('schema')!r} in "
            f"{p} (expected {BASELINE_SCHEMA})")
    waivers = list(doc.get("waivers", []))
    for w in waivers:
        if not w.get("reason"):
            raise ValueError(
                f"baseline waiver for {w.get('rule')}:{w.get('op')} "
                "has no reason — every waiver documents WHY the "
                "finding is accepted")
    return waivers


def _waiver_matches(w, finding):
    if w.get("rule") != finding.rule_id:
        return False
    if w.get("op") not in (None, "", finding.op):
        return False
    path = w.get("path", "")
    floc = finding.location.rsplit(":", 1)[0]
    return floc.endswith(path)


def apply_baseline(findings, waivers):
    """Split findings into (kept, waived, stale_waivers). INFO
    findings never consume a waiver; a waiver that matches nothing is
    stale and reported so the baseline shrinks as fixes land."""
    kept, waived = [], []
    used = set()
    for f in findings:
        if f.severity != Severity.INFO:
            idx = next((i for i, w in enumerate(waivers)
                        if _waiver_matches(w, f)), None)
            if idx is not None:
                used.add(idx)
                waived.append(f)
                continue
        kept.append(f)
    stale = [w for i, w in enumerate(waivers) if i not in used]
    return kept, waived, stale


def render_suggestions(findings):
    """Mechanical-fix suggestions for the finding classes the fix
    engine catalogs (``daemonize-unjoined-thread``): one actionable
    line per finding, for humans to apply in-source."""
    out = []
    for f in findings:
        if f.rule_id != RULE_LIFECYCLE:
            continue
        if "never joined" in f.message:
            out.append(f"fix[daemonize-unjoined-thread] {f.location}: "
                       f"add daemon=True to the {f.op!r} Thread(...) "
                       "constructor (or join it on shutdown)")
    return out
