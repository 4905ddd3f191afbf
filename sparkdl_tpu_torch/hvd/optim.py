"""Data-parallel training with a torch optimizer: ``DistributedOptimizer``,
``broadcast_parameters``, ``broadcast_optimizer_state`` and the in-place
collectives ``allreduce_`` and ``broadcast_``; re-exported by
:mod:`sparkdl_tpu_torch.hvd`.

Counterpart of the JAX package's ``horovod/torch/__init__.py``, which
carries torch gradients into JAX (through numpy or dlpack) and reduces
them with ``jax.lax.psum``. Here the gradients never leave the device:
``step()`` flattens every gradient of one (dtype, device) into one
buffer, reduces it in place over the gang's process group (over NCCL, on
the card, when every rank has its own card) and copies it back. The
wrapped optimizer keeps its class (the class-swap design), so learning
rate schedulers and checkpoint code see the user's optimizer.
"""

import torch

from sparkdl_tpu_torch.hvd import _collectives as _engine
from sparkdl_tpu_torch.hvd import _state


def allreduce_(tensor, average=None, name=None, op=None):
    """In-place allreduce (horovod.torch.allreduce_)."""
    del name
    _state.require_initialized()
    return _engine.reduce_(tensor, _engine.resolve_op(average, op))


def broadcast_(tensor, root_rank, name=None):
    """In-place broadcast (horovod.torch.broadcast_)."""
    del name
    _state.require_initialized()
    return _engine.broadcast_(tensor, root_rank)


def broadcast_parameters(params, root_rank=0):
    """Broadcast a state dict or a ``named_parameters()`` iterable from
    ``root_rank``, in place, tensor by tensor in name order (on the card
    over NCCL, when every rank has its own card)."""
    _state.require_initialized()
    items = sorted((params if isinstance(params, dict)
                    else dict(params)).items())
    for _, t in items:
        if isinstance(t, torch.Tensor):
            _engine.broadcast_(t, root_rank)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcast the optimizer's state (moments, step counts,
    hyperparameters) from ``root_rank``; ``load_state_dict`` puts each
    state tensor back on its parameter's device."""
    from sparkdl_tpu_torch.hvd import broadcast_object, size

    _state.require_initialized()
    if size() == 1:
        return
    synced = broadcast_object(_to_cpu(optimizer.state_dict()),
                              root_rank=root_rank)
    optimizer.load_state_dict(synced)


def _fused_allreduce_grads(params, op, compression=None):
    """One collective per (dtype, device) of the gradients: flatten into
    a fresh buffer, reduce it in place, copy back (Horovod's tensor
    fusion). With fp16 compression the wire buffer is half width."""
    groups = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.dtype, p.grad.device), []).append(p)
    for ps in groups.values():
        flat = torch.cat([p.grad.detach().reshape(-1) for p in ps])
        ctx = None
        if compression is not None:
            flat, ctx = compression.compress(flat)
        _engine.reduce_(flat, op)
        if compression is not None:
            flat = compression.decompress(flat, ctx)
        offset = 0
        with torch.no_grad():
            for p in ps:
                n = p.grad.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                offset += n


class _SkipSync:
    def __init__(self, opt):
        self._opt = opt

    def __enter__(self):
        self._opt._hvd_skip_sync = True
        return self

    def __exit__(self, *exc):
        self._opt._hvd_skip_sync = False
        return False


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=None, backward_passes_per_step=1,
                         op=None, average=None, **kwargs):
    """Wrap a ``torch.optim.Optimizer``: ``step()`` first averages every
    gradient across the gang (one fused collective per dtype and
    device), then applies the update. Returns ``optimizer`` itself, now
    an instance of a subclass of its own class.

    In a gang the gradients are reduced at every world size, one
    included; in local mode (``np=-1``, no process group) ``step()`` is
    the optimizer's own. ``synchronize()`` reduces now; inside
    ``with opt.skip_synchronize():`` a ``step()`` does not reduce (for a
    caller that called ``synchronize()`` itself, e.g. to clip the
    averaged gradients).

    :param named_parameters: ``(name, parameter)`` pairs; when given,
        every parameter of the optimizer must be among them.
    :param backward_passes_per_step: only 1; local gradient accumulation
        between reductions is not ported (raises NotImplementedError).
    """
    from sparkdl_tpu_torch.hvd import Compression

    if kwargs:
        raise NotImplementedError(
            f"DistributedOptimizer does not take {sorted(kwargs)} in this "
            "port")
    if backward_passes_per_step != 1:
        raise NotImplementedError(
            "backward_passes_per_step other than 1 is not ported: "
            "accumulate with make_train_step(grad_accum=...) instead")
    if named_parameters is not None:
        named = {id(p) for _, p in named_parameters}
        unnamed = sum(id(p) not in named for g in optimizer.param_groups
                      for p in g["params"])
        if unnamed:
            raise ValueError(
                f"named_parameters was given, but {unnamed} parameter(s) "
                "of the optimizer are not among them")
    kind = _engine.resolve_op(average, op)
    cls = optimizer.__class__

    class _DistributedOptimizer(cls):
        def synchronize(self):
            params = [p for g in self.param_groups for p in g["params"]]
            _fused_allreduce_grads(params, self._hvd_op,
                                   self._hvd_compression)

        def _hvd_sync(self):
            if (_state.state().group is not None
                    and not self._hvd_skip_sync):
                self.synchronize()

        def step(self, closure=None):
            _state.require_initialized()
            if closure is None:
                self._hvd_sync()
                return super().step()

            # every evaluation of the closure (LBFGS calls it repeatedly)
            # computes local gradients and then reduces them; reducing
            # before super().step(closure) would let the closure's
            # backward overwrite the reduced gradients
            def synced_closure():
                with torch.enable_grad():
                    loss = closure()
                self._hvd_sync()
                return loss

            return super().step(synced_closure)

        def skip_synchronize(self):
            return _SkipSync(self)

    _DistributedOptimizer.__name__ = "Distributed" + cls.__name__
    _DistributedOptimizer.__qualname__ = _DistributedOptimizer.__name__
    optimizer.__class__ = _DistributedOptimizer
    optimizer._hvd_op = kind
    optimizer._hvd_compression = (None if compression is Compression.none
                                  else compression)
    optimizer._hvd_skip_sync = False
    return optimizer
