"""Input helpers of a gang main: the device prefetch pipeline, this
rank's contiguous shard of the data, and a minimal batch iterator.

Counterpart of ``sparkdl_tpu/utils/data.py``'s ``prefetch_to_device``,
``shard_for_rank`` and ``batched``. The JAX functions walk a pytree with
``jax.tree``; these walk nested dicts, lists and tuples whose leaves are
numpy arrays or tensors (anything sliceable on its leading axis), and
keep the containers' types.
"""

import collections

# the bound of prefetch_to_device's host queue (None: its ``size``),
# read at call time; the JAX package's SPARKDL_TPU_PREFETCH_DEPTH
PREFETCH_DEPTH = None

_PREFETCH_THREAD_NAME = "sparkdl-tpu-prefetch"

# producer -> consumer queue message kinds
_ITEM, _END, _ERR = "item", "end", "err"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))  # a namedtuple
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_for_rank(arrays, rank=None, size=None, *, drop_last=True):
    """Slice each leaf's leading axis to this gang member's contiguous
    shard (the data-parallel input split: each HorovodRunner worker
    reads only its 1/size of the epoch). ``drop_last``: every rank gets
    ``n // size`` rows (the remainder is dropped); else the shards
    differ by at most one row.

    rank/size default to the initialized gang
    (:mod:`sparkdl_tpu_torch.hvd`); pass them explicitly outside one."""
    if rank is None or size is None:
        from sparkdl_tpu_torch import hvd

        rank = hvd.rank() if rank is None else rank
        size = hvd.size() if size is None else size
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside [0, {size})")
    n = _leaves(arrays)[0].shape[0]
    if n < size:
        raise ValueError(
            f"cannot shard {n} rows across {size} ranks — every rank "
            f"would train on an empty shard (pass size<=n or feed "
            f"more data)")
    if drop_last:
        per = n // size
        lo, hi = rank * per, (rank + 1) * per
    else:
        lo, hi = rank * n // size, (rank + 1) * n // size
    return _map(lambda x: x[lo:hi], arrays)


def batched(arrays, batch_size, *, shuffle=False, seed=0, drop_last=True):
    """Minimal epoch iterator over a tree of equally long arrays: batches
    of ``batch_size`` rows, in order or (``shuffle``) in the order of
    ``np.random.RandomState(seed)``'s permutation, the last partial
    batch dropped unless ``drop_last`` is False."""
    import numpy as np

    n = _leaves(arrays)[0].shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        sel = idx[start:start + batch_size]
        yield _map(lambda x, s=sel: x[s], arrays)


def _prefetch_device(device):
    import torch

    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.ops._dispatch import resolve_device

    if device is None and _state.state().device is not None:
        return torch.device(_state.state().device)
    return resolve_device(device)


def _host_leaf(x, pin):
    """A batch leaf as a host tensor, in pinned memory when it is bound
    for a card (so that its copy can run asynchronously: a copy from
    pageable memory is synchronous)."""
    import numpy as np
    import torch

    if isinstance(x, (np.ndarray, np.generic)):
        x = np.asarray(x)  # a 0-d array stays 0-d
        x = torch.from_numpy(np.ascontiguousarray(x) if x.ndim else x)
    if (pin and isinstance(x, torch.Tensor) and x.device.type == "cpu"
            and not x.is_pinned()):
        x = x.pin_memory()
    return x


def prefetch_to_device(iterator, size=2, sharding=None, *, device=None):
    """Wrap a host-batch iterator so that both the production of host
    batches and their copy to the device overlap the steps.

    :param iterator: yields trees (dicts, lists, tuples) of numpy arrays
        or tensors.
    :param size: the device-side buffer depth (2: double buffering);
        also the host queue's bound unless :data:`PREFETCH_DEPTH` sets
        it (deeper read-ahead for a spiky producer).
    :param sharding: refused (NotImplementedError): one process holds
        one card; split a global batch with :func:`shard_for_rank` or
        ``parallel.train.shard_batch``.
    :param device: where the batches go: None is the gang rank's bound
        device, else ``cuda`` (a RuntimeError without a card); tests
        pass ``"cpu"``.

    ``next(iterator)`` runs on a daemon producer thread (named
    ``sparkdl-tpu-prefetch``) into a bounded queue, and on the way
    turns each numpy leaf into a tensor, pinned when the device is a
    card. The consuming thread dequeues a batch and issues its copies
    ``non_blocking`` on a side stream of its own; before it
    hands the batch out, the consumer's current stream waits on the
    copy's event, and each tensor's ``record_stream`` tells the caching
    allocator of that use, so that no buffer is reused under a copy in
    flight. Yields trees of tensors on ``device``, in order.

    A producer exception is re-raised where the batch that failed would
    have been consumed, after the batches produced before it. Closing
    the generator (``break`` and collection, or ``.close()``) stops and
    joins the producer thread and closes the underlying iterator.

    With the telemetry on, each refill wait (the dequeue and the copy's
    issue) is a ``data.wait`` span on the consuming thread, between the
    instrumented steps (``inter_step_data_wait_s`` in the
    :mod:`~sparkdl_tpu_torch.observe.perf` report), and the bytes in
    the host queue are the ``host_prefetch`` memory category.
    """
    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=): one process of the port holds "
            "one card; give each rank its rows with shard_for_rank or "
            "parallel.train.shard_batch and prefetch them to its device")
    import queue as queue_mod
    import threading

    import torch

    from sparkdl_tpu_torch import observe

    device = _prefetch_device(device)
    cuda = device.type == "cuda"
    depth = PREFETCH_DEPTH or size
    hostq = queue_mod.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    # the host bytes in the producer queue: the producer adds a batch's
    # bytes, the consumer takes them off in the queue's own order
    mem_sizes = collections.deque()
    mem_acct = {"in": 0, "out": 0}
    if observe.enabled():
        from sparkdl_tpu_torch.observe import mem as _mem

        _mem.register_tree(
            "host_prefetch",
            lambda: max(0, mem_acct["in"] - mem_acct["out"]))
        _batch_nbytes = _mem.tree_nbytes
    else:
        _batch_nbytes = None

    def produce():
        def put(msg):
            # bounded and blocking, but it sees close(): a consumer gone
            # away must not wedge this thread
            while not stop.is_set():
                try:
                    hostq.put(msg, timeout=0.05)
                    return True
                except queue_mod.Full:
                    continue
            return False

        try:
            for batch in iterator:
                batch = _map(lambda x: _host_leaf(x, cuda), batch)
                if _batch_nbytes is not None:
                    nb = _batch_nbytes(batch)
                    mem_sizes.append(nb)
                    mem_acct["in"] += nb
                if not put((_ITEM, batch)):
                    return
            put((_END, None))
        except BaseException as e:  # noqa: BLE001  (re-raised by the consumer)
            put((_ERR, e))

    thread = threading.Thread(target=produce, name=_PREFETCH_THREAD_NAME,
                              daemon=True)
    side = torch.cuda.Stream(device) if cuda else None
    devq = collections.deque()
    state = {"live": True, "err": None}

    def to_device(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return x

    def refill():
        """Move one produced batch into the device buffer (its copies
        issued); flips ``live`` at the end or an error."""
        kind, val = hostq.get()
        if kind == _END:
            state["live"] = False
        elif kind == _ERR:
            state["live"] = False
            state["err"] = val
        else:
            if _batch_nbytes is not None and mem_sizes:
                mem_acct["out"] += mem_sizes.popleft()
            if not cuda:
                devq.append((_map(to_device, val), None))
                return
            with torch.cuda.stream(side):
                out = _map(to_device, val)
                done = torch.cuda.Event()
                done.record(side)
            devq.append((out, done))

    def handed_out(out, done):
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in _leaves(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(consumer)
        return out

    def close():
        stop.set()
        thread.join(timeout=5.0)
        it_close = getattr(iterator, "close", None)
        if callable(it_close):
            try:
                it_close()
            except ValueError:
                # a generator still executing inside a wedged producer
                # refuses close(); the daemon thread drops it
                pass

    thread.start()
    try:
        with observe.span("data.wait", cat="data", phase="prime"):
            for _ in range(size):
                if not state["live"]:
                    break
                refill()
        while devq:
            out, done = devq.popleft()
            if state["live"]:
                with observe.span("data.wait", cat="data"):
                    refill()
            yield handed_out(out, done)
        if state["err"] is not None:
            raise state["err"]
    finally:
        close()
