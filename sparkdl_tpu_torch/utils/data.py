"""Input helpers of a gang main: this rank's contiguous shard of the
data, and a minimal batch iterator.

Counterpart of ``sparkdl_tpu/utils/data.py``'s ``shard_for_rank`` and
``batched``. The JAX functions walk a pytree with ``jax.tree``; these
walk nested dicts, lists and tuples whose leaves are numpy arrays or
tensors (anything sliceable on its leading axis), and keep the
containers' types.
"""


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
