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

Not ported, and why: the orbax regime latch (a data-parallel gang has
no cross-process barrier here to deadlock in, so there is one regime);
the cross-process gather before a save (data-parallel state is
replicated, so rank 0 holds all of it); the sharding-tree sidecar and
the resharded restore of ``target_mesh`` (a gang has no mesh until
tensor parallelism is ported); the observe spans and counters.
"""

import logging
import os
import shutil
import threading
import time

logger = logging.getLogger("HorovodRunner")

STATE_FILE = "state.pt"


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
        # the last save: {"step", "bytes", "snapshot_s", "write_s"}
        # (write_s once the write has finished)
        self.last_save = None

    def save(self, step, state, force=False):
        """Write ``state`` as step ``step``; True when written. False on a
        gang rank other than 0, and (unless ``force``) when a committed
        step at or after ``step`` exists, as orbax's manager decides;
        with ``force``, raises ValueError when ``step`` itself is
        committed. Blocks until the step is committed unless
        ``async_save`` was set."""
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
        t = time.perf_counter()
        snapshot = _snapshot(state)
        self.last_save = {"step": step, "bytes": None,
                          "snapshot_s": time.perf_counter() - t,
                          "write_s": None}
        if not self._async:
            self._write(step, snapshot)
            return True
        self._writer = threading.Thread(
            target=self._write_async, args=(step, snapshot),
            name=f"checkpoint-write-{step}", daemon=True)
        self._writer.start()
        return True

    def _write_async(self, step, snapshot):
        try:
            self._write(step, snapshot)
        except BaseException as e:  # noqa: BLE001 - raised again at the join
            self._write_error = e

    def _write(self, step, snapshot):
        import torch

        t = time.perf_counter()
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
        self.last_save["bytes"] = os.path.getsize(
            os.path.join(final, STATE_FILE))
        self.last_save["write_s"] = time.perf_counter() - t
        self._prune()

    def _prune(self):
        if self._max_to_keep is None:
            return
        steps = _committed_steps(self._dir)
        for s in steps[:max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self._dir, str(s)))

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

        ``target_mesh`` (a resharded restore onto another mesh) is not
        ported and raises NotImplementedError.
        """
        if target_mesh is not None:
            raise NotImplementedError(
                "TrainCheckpointer.restore(target_mesh=...) (a resharded "
                "restore) is not ported: a data-parallel gang has no mesh")
        import torch

        self.wait_until_finished()
        if step is None:
            step = latest_complete_step(self._dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints found under {self._dir}")
        candidates = [int(step)]
        if fallback:
            candidates += [s for s in reversed(_committed_steps(self._dir))
                           if s < int(step)]
        first_error = None
        for i, cand in enumerate(candidates):
            path = os.path.join(self._dir, str(cand), STATE_FILE)
            try:
                state = torch.load(path, map_location="cpu",
                                   weights_only=True)
            except Exception as e:  # noqa: BLE001 - every way a torn
                # step fails to load (truncated zip, missing file, a
                # foreign pickle) must reach the fallback
                first_error = first_error or e
                if i + 1 >= len(candidates):
                    break
                logger.error(
                    "checkpoint step %d under %s failed to restore (%s: "
                    "%s); falling back to committed step %d", cand,
                    self._dir, type(e).__name__, e, candidates[i + 1])
                self._quarantine_step(cand)
                continue
            self.last_restored_step = cand
            if target is None:
                return state
            return _place(state, target, "state")
        raise first_error

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
