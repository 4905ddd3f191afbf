"""Train-state checkpoints: save the state of a step, restore it when a
gang is relaunched.

Counterpart of ``sparkdl_tpu/utils/checkpoint.py``. There orbax writes
the state; here one ``torch.save`` file a step does, under the same
commit protocol:

- a step is written to ``<dir>/<step>.tmp-<pid>/state.pt``; the file
  and its directory are fsynced, then ``os.replace`` renames the
  directory to ``<dir>/<step>``. A numeric directory is a committed
  step; a worker killed mid-save leaves only a temp directory, which
  :func:`latest_complete_step` ignores;
- in a HorovodRunner gang, rank 0 writes (:func:`should_save`) and any
  rank restores, ordered by the caller (``hvd.barrier()`` between a
  save and a dependent restore);
- steps beyond ``max_to_keep`` are pruned after each commit;
- a committed step that fails to load is quarantined as
  ``<step>.corrupt-<pid>`` and the restore falls back to the previous
  committed step.

The state is any nest of dicts, lists and tuples whose leaves are
tensors or plain Python values: a module's (adapter) ``state_dict``
and ``optimizer.state_dict()`` for instance. It is read back with
``torch.load(weights_only=True)``.

Tensor-parallel state (elastic resume): ``save(step, state, mesh=mesh,
specs=specs)`` on a gang laid out on a mesh (``specs`` maps a leaf's
path, the nest's keys joined by ``.``, to its spec:
``model.tp_specs`` for ``model.state_dict()``) is called by every rank.
Each split leaf is gathered whole
(:func:`~sparkdl_tpu_torch.parallel.sharding.full_host_value`, a
collective), rank 0 writes the whole tree, and before the step's commit
rename it writes the step's **sharding-tree sidecar**
(``sharding_tree-<step>.json`` beside the step: the JAX package's
schema and JSON layout, the port's paths), pruned with its step.
``restore(step, target_mesh=mesh)`` re-lays the saved tree onto another
mesh: the reshard plan is computed again from the sidecar
(:func:`~sparkdl_tpu_torch.analysis.comms.reshard_plan`), an infeasible
target raises :class:`~sparkdl_tpu_torch.analysis.comms.ReshardPreflightError`
(never a fallback, never a quarantine), and each leaf is placed, one at
a time from the host copy, as this rank's slice of its recorded layout
on the target mesh; :attr:`TrainCheckpointer.last_reshard` holds the
accounting. A step without a sidecar restores whole, with a warning.

Not ported, and why: the orbax regime latch (no cross-process barrier
here to deadlock in, so there is one regime); orbax's direct restore
into sharded targets (every restore takes the host path of the JAX
gang ranks) and the group-size knob ``SPARKDL_TPU_RESHARD_GROUPED``
(placement is always leaf by leaf).

With telemetry on, as in the JAX package: a synchronous save is one
``checkpoint.save`` span (``cat="checkpoint"``, snapshot and durable
write); an asynchronous one a ``checkpoint.snapshot`` host span (the
copy to host memory; the write runs on its thread), each with
``checkpoint_saves_total`` and ``checkpoint_save_seconds``; each restore
attempt a ``checkpoint.restore`` span and ``checkpoint_restores_total``,
a torn step ``checkpoint_corrupt_steps_total`` and a
``checkpoint.corrupt_step`` instant; a resharded restore a
``gang.reshard`` span and ``gang_reshards_total{direction}``.
"""

import contextlib
import json
import logging
import os
import shutil
import threading
import time

logger = logging.getLogger("HorovodRunner")

STATE_FILE = "state.pt"

# the sidecar's schema: the JAX package's, so either package reads it
SHARDING_TREE_SCHEMA = "sparkdl_tpu.checkpoint.sharding_tree/1"


def should_save():
    """In a gang, only rank 0 writes (every rank holds the same state);
    off a gang, this process does."""
    from sparkdl_tpu_torch.hvd import _state

    st = _state.state()
    return (not st.initialized) or st.rank == 0


def _committed_steps(directory):
    """Every committed step under a checkpoint root, oldest first: the
    numeric directories (a temp or quarantined directory's name is not
    a number)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        int(n) for n in names
        if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def latest_complete_step(directory):
    """The newest committed step under a :class:`TrainCheckpointer` root,
    or None, by a directory scan alone (no torch import): the gang
    supervisor calls it on the driver between attempts."""
    return max(_committed_steps(directory), default=None)


def sharding_sidecar_path(directory, step):
    """Path of one step's sharding-tree sidecar under a checkpoint root:
    beside the step's directory, written before its commit rename, so a
    committed step saved on a mesh always has its sidecar."""
    return os.path.join(directory, f"sharding_tree-{int(step)}.json")


def load_sharding_tree(directory, step):
    """One step's sharding-tree sidecar, or None (absent, torn, or of
    another schema: the step restores without resharding). No torch
    import."""
    try:
        with open(sharding_sidecar_path(directory, step)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != SHARDING_TREE_SCHEMA:
        return None
    return doc


def sidecar_mesh_axes(doc):
    """The sidecar's recorded mesh axis sizes as ``{name: size}``."""
    return {str(k): int(v)
            for k, v in ((doc or {}).get("mesh_axes") or {}).items()}


def _leaves(state, prefix=""):
    """``(path, tensor)`` of every tensor leaf of a nest, in order; a path
    is the keys and indices from the root joined by ``.`` (a flat
    ``state_dict``'s names as they are)."""
    import torch

    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    items = (state.items() if isinstance(state, dict)
             else enumerate(state) if isinstance(state, (list, tuple))
             else ())
    out = []
    for k, v in items:
        out += _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _replace_leaves(state, new, prefix=""):
    """``state`` with each tensor leaf whose path is in ``new`` replaced
    by ``new[path]``."""
    import torch

    if isinstance(state, torch.Tensor):
        return new.get(prefix, state)
    if isinstance(state, dict):
        return {k: _replace_leaves(v, new, f"{prefix}.{k}" if prefix
                                   else str(k)) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_replace_leaves(v, new, f"{prefix}.{i}" if prefix
                                           else str(i))
                           for i, v in enumerate(state))
    return state


def _sharding_tree_doc(step, leaves, specs, mesh):
    """The sidecar of one save: every tensor leaf's whole shape, dtype
    and per-dim axis names (``[]``: whole), and the mesh's axis sizes."""
    from sparkdl_tpu_torch.parallel.sharding import sharding_tree_info

    infos = sharding_tree_info(dict(leaves), specs, mesh)
    return {
        "schema": SHARDING_TREE_SCHEMA,
        "step": int(step),
        "mesh_axes": {str(a): int(n) for a, n in dict(mesh.shape).items()},
        "params": [{"path": i.path, "shape": list(i.shape),
                    "dtype": i.dtype, "spec": [list(d) for d in i.spec]}
                   for i in infos],
    }


def _span(on, name, **args):
    """A telemetry span around a checkpoint phase when ``on``; else
    nothing of the facade is touched."""
    if not on:
        return contextlib.nullcontext()
    from sparkdl_tpu_torch import observe

    return observe.span(name, **args)


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _snapshot(state):
    """A host copy of every tensor of the nest, so that updates in place
    after the call do not reach the file. A host tensor is cloned. A CUDA
    tensor is copied without blocking into pinned memory from torch's
    caching host allocator, which hands the same blocks to the next
    snapshot once this one is written: fresh pageable memory would
    fault in every page again at each save. One synchronize ends it."""
    import torch

    on_card = []

    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type != "cuda":
                return x.clone() if x.device.type == "cpu" else x.cpu()
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            on_card.append(x.device)
            return host.copy_(x, non_blocking=True)
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    out = copy(state)
    for device in set(on_card):
        torch.cuda.synchronize(device)
    return out


def _place(value, target, path):
    """``value`` (a restored nest) laid out as ``target``: each tensor leaf
    on its target's device and in its dtype; a target leaf that is no
    tensor takes the saved value as it is."""
    import torch

    if isinstance(target, torch.Tensor):
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"{path}: saved {type(value).__name__}, the "
                            "target is a tensor")
        if value.shape != target.shape:
            raise ValueError(f"{path}: saved shape {tuple(value.shape)}, "
                             f"target shape {tuple(target.shape)}")
        return value.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(value, dict) or set(value) != set(target):
            saved = (sorted(map(str, value)) if isinstance(value, dict)
                     else repr(value))
            raise ValueError(f"{path}: saved keys {saved}, target keys "
                             f"{sorted(map(str, target))}")
        return {k: _place(value[k], t, f"{path}[{k!r}]")
                for k, t in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(target):
            raise ValueError(f"{path}: saved {value!r}, target of "
                             f"{len(target)} items")
        return type(target)(_place(v, t, f"{path}[{i}]")
                            for i, (v, t) in enumerate(zip(value, target)))
    return value


class TrainCheckpointer:
    """Step-indexed train-state checkpoints, keep-last-N, atomic commits."""

    def __init__(self, directory, max_to_keep=3, async_save=False):
        """``async_save=True``: :meth:`save` returns once the state is
        copied to host memory, and the write runs on a thread.
        :meth:`restore`, the next :meth:`save`, :meth:`latest_step` and
        :meth:`close` join it first; a failed write raises there.
        ``max_to_keep=None`` keeps every step."""
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._async = bool(async_save)
        os.makedirs(self._dir, exist_ok=True)
        self._writer = None  # the async write in flight
        self._write_error = None
        # the step the last restore() loaded: on a fallback, earlier than
        # the one asked for, and the step a resumed run continues after
        self.last_restored_step = None
        # the last save: {"step", "bytes", "snapshot_s", "write_s",
        # "gather_s", "sidecar_bytes"} (write_s once the write has
        # finished; the last two for a save on a mesh)
        self.last_save = None
        # the accounting of the last resharded restore (None when the
        # last restore re-laid nothing): the JAX package's keys
        self.last_reshard = None

    def save(self, step, state, force=False, *, mesh=None, specs=None):
        """Write ``state`` as step ``step``; True when written. False on a
        gang rank other than 0, and (unless ``force``) when a committed
        step at or after ``step`` exists, as orbax's manager decides;
        with ``force``, raises ValueError when ``step`` itself is
        committed. Blocks until the step is committed unless
        ``async_save`` was set.

        ``mesh`` (the gang's :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh`)
        and ``specs`` (``{leaf path: spec}``; a leaf without one is
        whole): ``state`` holds this rank's blocks. Every rank must call
        it, in the same order as its other collectives: the split
        leaves are gathered whole first, then rank 0 writes them with
        the step's sharding-tree sidecar."""
        sidecar = gather_s = None
        if mesh is not None:
            from sparkdl_tpu_torch.parallel.sharding import full_host_value

            specs = dict(specs or {})
            t = time.perf_counter()
            leaves = _leaves(state)
            sidecar = _sharding_tree_doc(step, leaves, specs, mesh)
            state = _replace_leaves(state, {
                path: full_host_value(x, specs.get(path, ()), mesh)
                for path, x in leaves if specs.get(path)})
            gather_s = time.perf_counter() - t
        if not should_save():
            return False
        self.wait_until_finished()
        step = int(step)
        latest = latest_complete_step(self._dir)
        if latest is not None and latest >= step:
            if not force:
                return False
            if step in _committed_steps(self._dir):
                raise ValueError(f"checkpoint for step {step} already "
                                 f"exists under {self._dir}")
        from sparkdl_tpu_torch import observe

        on = observe.enabled()
        t = time.perf_counter()
        if not self._async:
            with _span(on, "checkpoint.save", cat="checkpoint", step=step,
                       sync=True):
                snapshot = _snapshot(state)
                record = self._new_record(step, t, sidecar, gather_s)
                self._write(step, snapshot, sidecar, record)
        else:
            with _span(on, "checkpoint.snapshot", cat="host", step=step):
                snapshot = _snapshot(state)
            record = self._new_record(step, t, sidecar, gather_s)
            # the write fills in its own save's record, never a later one
            self._writer = threading.Thread(
                target=self._write_async,
                args=(step, snapshot, sidecar, record),
                name=f"checkpoint-write-{step}", daemon=True)
            self._writer.start()
        if on:
            observe.inc("checkpoint_saves_total")
            observe.observe_value("checkpoint_save_seconds",
                                  time.perf_counter() - t)
        return True

    def _new_record(self, step, t, sidecar, gather_s):
        """The save's :attr:`last_save`, set now; the write fills in
        ``bytes``, ``write_s`` and ``sidecar_bytes``."""
        record = {"step": step, "bytes": None,
                  "snapshot_s": time.perf_counter() - t, "write_s": None}
        if sidecar is not None:
            record.update(gather_s=gather_s, sidecar_bytes=None)
        self.last_save = record
        return record

    def _write_async(self, step, snapshot, sidecar, record):
        try:
            self._write(step, snapshot, sidecar, record)
        except BaseException as e:  # noqa: BLE001 - raised again at the join
            self._write_error = e

    def _write_sidecar(self, step, doc, record):
        """Atomic (temp file, fsync, rename) before the step's commit
        rename: a committed step saved on a mesh has its sidecar."""
        path = sharding_sidecar_path(self._dir, step)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        record["sidecar_bytes"] = os.path.getsize(path)

    def _write(self, step, snapshot, sidecar, record):
        import torch

        t = time.perf_counter()
        if sidecar is not None:
            self._write_sidecar(step, sidecar, record)
        final = os.path.join(self._dir, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            torch.save(snapshot, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, final)
        _fsync_dir(self._dir)
        record["bytes"] = os.path.getsize(os.path.join(final, STATE_FILE))
        record["write_s"] = time.perf_counter() - t
        self._prune()

    def _prune(self):
        """Remove the steps beyond ``max_to_keep``, then every sidecar
        whose step is not committed (pruned, or quarantined)."""
        steps = _committed_steps(self._dir)
        if self._max_to_keep is not None:
            for s in steps[:max(len(steps) - self._max_to_keep, 0)]:
                shutil.rmtree(os.path.join(self._dir, str(s)))
        live = set(_committed_steps(self._dir))
        for name in os.listdir(self._dir):
            stem = name[len("sharding_tree-"):-len(".json")]
            if (name.startswith("sharding_tree-") and name.endswith(".json")
                    and stem.isdigit() and int(stem) not in live):
                os.unlink(os.path.join(self._dir, name))

    def wait_until_finished(self):
        """Join the async write in flight (none: no-op); raise its error."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    def latest_step(self):
        self.wait_until_finished()
        return latest_complete_step(self._dir)

    def restore(self, step=None, target=None, *, target_mesh=None,
                fallback=True):
        """The state of ``step`` (default the latest committed one).

        Without ``target`` every tensor comes back on the CPU. With
        ``target`` (a nest of the saved structure, e.g. the live model's
        adapters) each tensor takes its target leaf's device and dtype,
        and a shape, key or length mismatch raises: that is the caller's
        error, not a torn step, so it neither falls back nor quarantines.

        ``fallback=True``: a committed step that fails to load is
        quarantined (``<step>.corrupt-<pid>``) and the previous
        committed step is tried, down to the oldest; the step actually
        loaded is :attr:`last_restored_step`. ``fallback=False`` raises
        for exactly ``step``. Raises FileNotFoundError when no step is
        committed.

        ``target_mesh`` (a :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh`,
        this rank's view of the mesh to restore onto): every tensor leaf
        the step's sidecar records comes back as this rank's slice of
        its recorded layout re-laid onto ``target_mesh`` (axes the
        target lacks go whole), placed one leaf at a time from the host
        copy; with ``target``, each target leaf is the local slice's
        shape. The reshard plan is recomputed from the sidecar
        (``state_multiplier=1.0``, the tree is the state) first: an
        infeasible target raises ReshardPreflightError, which neither
        falls back nor quarantines.
        :attr:`last_reshard` holds the accounting (None when the
        target's axes are the recorded ones). A step without a sidecar
        restores whole, with a warning.
        """
        from sparkdl_tpu_torch.parallel.mesh import Mesh

        if target_mesh is not None and not isinstance(target_mesh, Mesh):
            raise TypeError(
                "target_mesh must be a sparkdl_tpu_torch.parallel.mesh.Mesh"
                f", got {type(target_mesh).__name__}")
        import torch

        from sparkdl_tpu_torch.analysis.comms import ReshardPreflightError

        self.wait_until_finished()
        if step is None:
            step = latest_complete_step(self._dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints found under {self._dir}")
        candidates = [int(step)]
        if fallback:
            candidates += [s for s in reversed(_committed_steps(self._dir))
                           if s < int(step)]
        from sparkdl_tpu_torch import observe

        on = observe.enabled()
        first_error = None
        self.last_reshard = None
        for i, cand in enumerate(candidates):
            path = os.path.join(self._dir, str(cand), STATE_FILE)
            try:
                with _span(on, "checkpoint.restore", cat="checkpoint",
                           step=int(cand)):
                    if on:
                        observe.inc("checkpoint_restores_total")
                    plan = (None if target_mesh is None
                            else self._reshard_plan(cand, target_mesh))
                    state = torch.load(path, map_location="cpu",
                                       weights_only=True)
            except ReshardPreflightError:
                # a deterministic refusal, not a torn step: every earlier
                # step would fail alike, and none may be quarantined
                raise
            except Exception as e:  # noqa: BLE001 - every way a torn
                # step fails to load (truncated zip, missing file, a
                # foreign pickle) must reach the fallback
                first_error = first_error or e
                if i + 1 >= len(candidates):
                    break
                if on:
                    observe.inc("checkpoint_corrupt_steps_total")
                    observe.instant(
                        "checkpoint.corrupt_step", cat="checkpoint",
                        step=int(cand), error=f"{type(e).__name__}: {e}",
                        fallback_step=int(candidates[i + 1]))
                logger.error(
                    "checkpoint step %d under %s failed to restore (%s: "
                    "%s); falling back to committed step %d", cand,
                    self._dir, type(e).__name__, e, candidates[i + 1])
                self._quarantine_step(cand)
                continue
            if plan is not None:
                state = self._resharded(cand, state, target_mesh, *plan)
            self.last_restored_step = cand
            if target is None:
                return state
            return _place(state, target, "state")
        raise first_error

    def _reshard_plan(self, step, target_mesh):
        """``(doc, plan)`` for re-laying ``step`` onto ``target_mesh``, or
        None without a sidecar (a warning: the step restores whole).
        Raises ReshardPreflightError when the plan is infeasible."""
        from sparkdl_tpu_torch.analysis.comms import (
            ReshardPreflightError,
            param_info_from_sidecar,
            reshard_plan,
        )

        doc = load_sharding_tree(self._dir, step)
        if doc is None:
            logger.warning(
                "no sharding sidecar for step %d under %s; restoring "
                "without resharding", step, self._dir)
            return None
        target_axes = {str(a): int(n)
                       for a, n in dict(target_mesh.shape).items()}
        plan = reshard_plan(param_info_from_sidecar(doc),
                            sidecar_mesh_axes(doc) or target_axes,
                            target_axes, state_multiplier=1.0)
        if not plan.feasible:
            raise ReshardPreflightError(plan.problems, plan=plan)
        return doc, plan

    def _resharded(self, step, state, target_mesh, doc, plan):
        """``state`` (the whole tree on the host) with every leaf the
        sidecar records replaced by this rank's slice of it on
        ``target_mesh``, one leaf at a time; the accounting of the JAX
        package's host-mediated placement with groups of one leaf: the
        new slices accumulate and one leaf's old shard is in flight, the
        high water within the plan's whole-tree bound."""
        from sparkdl_tpu_torch import observe
        from sparkdl_tpu_torch.parallel.sharding import (
            named_sharding_for,
            shard_params,
        )

        t_wall, t0 = time.time(), time.perf_counter()
        source_axes = sidecar_mesh_axes(doc) or dict(plan.target_axes)
        target_axes = dict(plan.target_axes)
        spec_by_path = {p["path"]: p.get("spec") or []
                        for p in doc["params"]}

        def factor(spec_dims, axes):
            f = 1
            for dims in spec_dims or ():
                for name in dims or ():
                    f *= int(axes.get(name, 1))
            return f

        placed = {}
        resident_new = high_water = bytes_moved = 0
        for path, host in _leaves(state):
            if path not in spec_by_path:
                continue
            spec = spec_by_path[path]
            nbytes = host.numel() * host.element_size()
            # at most all the new shards and the largest old one: never
            # above the plan's bound (all new and all old)
            high_water = max(high_water,
                             resident_new + nbytes // factor(spec,
                                                             source_axes))
            placed[path] = shard_params(
                {path: host},
                {path: named_sharding_for(target_mesh, spec)},
                target_mesh)[path]
            new = nbytes // factor(spec, target_axes)
            resident_new += new
            bytes_moved += new
        state = _replace_leaves(state, placed)
        if source_axes == target_axes:
            return state  # the recorded layout: a resume, not a reshard

        def world(axes):
            n = 1
            for v in axes.values():
                n *= int(v)
            return n

        src, tgt = world(source_axes), world(target_axes)
        self.last_reshard = {
            "mode": "grouped", "params": len(placed), "groups": len(placed),
            "bytes_moved": int(bytes_moved),
            "high_water_accounted_bytes": int(high_water),
            "step": int(step),
            "direction": ("grow" if tgt > src else "shrink" if tgt < src
                          else "relayout"),
            "source_axes": source_axes, "target_axes": target_axes,
            "restore_high_water_bytes": plan.restore_high_water_bytes,
            "hbm_bytes": plan.hbm_bytes,
        }
        if observe.enabled():
            observe.complete("gang.reshard", t_wall,
                             time.perf_counter() - t0, cat="checkpoint",
                             **self.last_reshard)
            observe.inc("gang_reshards_total",
                        direction=self.last_reshard["direction"])
        logger.info(
            "resharded restore of step %d: %s %s -> %s (%d leaves, "
            "%.1f MiB placed)", step, self.last_reshard["direction"],
            source_axes, target_axes, len(placed), bytes_moved / 2**20)
        return state

    def _quarantine_step(self, step):
        """Move a torn step out of the numeric namespace, so that
        :func:`latest_complete_step` (the supervisor's resume point)
        stops pointing at it."""
        path = os.path.join(self._dir, str(int(step)))
        try:
            os.replace(path, f"{path}.corrupt-{os.getpid()}")
            logger.error("quarantined torn checkpoint step dir %s", path)
        except OSError:
            pass  # another rank moved it first, or it never existed

    def close(self):
        """Join the async write in flight: the run's last step is the one
        a resume needs."""
        self.wait_until_finished()
