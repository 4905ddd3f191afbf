"""Pipeline parallelism: GPipe microbatch streaming over a ``stage``
mesh axis.

Counterpart of ``sparkdl_tpu/parallel/pipeline.py``. Each rank of the
axis holds one stage's parameters (:func:`stage_slice` takes a rank's
stage out of the JAX package's stacked (P, ...) tree); microbatches
enter at stage 0, hop neighbour to neighbour through the stages
(:meth:`~sparkdl_tpu_torch.parallel.mesh.Mesh.ppermute_start`), and the
last stage's outputs are summed over the axis, so every rank returns
them.

Two hop schedules, as the JAX package's:

- ``overlap=True`` (the default): each tick issues the hop of the last
  tick's output before its own ``stage_fn`` runs on the activation that
  already arrived, so the transfer can run under the stage's compute.
  An activation spends one compute tick and one transit tick a stage:
  ``M + 2(P-1)`` ticks, a bubble of ``2(P-1)`` of them.
- ``overlap=False``: ``stage_fn``, then the hop, in one tick:
  ``M + P - 1`` ticks.

Every stage runs ``stage_fn`` on every tick, bubble ticks included (on
zeros, or on what arrived from the ring's last stage, which nothing
reads). Both schedules compose the same stages on the same
microbatches, so outputs and gradients are bit-identical.

Differentiable end to end: each hop is an autograd node whose backward
takes the reverse hop. Every rank builds the same graph (a stage keeps
or drops a value by ``torch.where``, never by a branch), so every rank's
backward issues its hops in the same order. Every rank computes the
loss from the returned outputs and calls ``backward``; the sum that
replicated the last stage's outputs hands that stage the cotangent once
(every rank holds the same one), not summed over the ranks, and the
other stages get theirs through the reverse hops.

Differences from the JAX package: ``pipeline_apply`` takes this rank's
stage parameters (any object ``stage_fn`` takes) and the mesh, not a
(1, ...) shard under ``shard_map``; ``overlap=None`` is
:data:`sparkdl_tpu_torch.parallel.ring_attention.OVERLAP` and no
environment variable is read.
"""

import torch

from sparkdl_tpu_torch.parallel.ring_attention import resolve_overlap


def stage_slice(stacked, stage):
    """Stage ``stage``'s parameters out of a stacked tree (dicts, lists
    and tuples of (P, ...) tensors or arrays, the JAX package's
    ``stacked_params``): every leaf indexed at ``stage``."""
    if isinstance(stacked, dict):
        return {k: stage_slice(v, stage) for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(stage_slice(v, stage) for v in stacked)
    return stacked[stage]


class _LastStage(torch.autograd.Function):
    """The last stage's outputs on every rank: the axis' sum of each
    rank's collected outputs, which only the last stage filled. Every
    rank's loss is the same function of them, so the gradient is handed
    back once, to the last stage."""

    @staticmethod
    def forward(ctx, outputs, mesh, axis_name, last):
        # last: 1.0 on the last stage, 0.0 elsewhere
        ctx.last = last
        return mesh.all_reduce(outputs * last, axis_name)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.last, None, None, None


def pipeline_apply(stage_fn, stage_params, microbatches, *, mesh,
                   axis_name="stage", overlap=None):
    """Stream ``microbatches`` through the stages of ``mesh``'s
    ``axis_name``; every rank of the axis calls it.

    :param stage_fn: ``f(stage_params, x) -> y`` with ``y.shape ==
        x.shape`` (e.g. a group of transformer blocks).
    :param stage_params: this rank's stage (:func:`stage_slice`).
    :param microbatches: (M, mb, ...), the same on every rank; only
        stage 0 reads them.
    :param overlap: the hop schedule (module docstring); None is
        ``ring_attention.OVERLAP``.
    :return: the last stage's (M, mb, ...) outputs, on every rank.
    """
    overlap = resolve_overlap(overlap)
    n = mesh.axis_size(axis_name)
    stage = mesh.axis_index(axis_name)
    m = microbatches.shape[0]
    device = microbatches.device
    # ticks an activation needs to clear the pipe: one compute tick a
    # stage, plus (overlap) one transit tick a hop
    lag = (2 if overlap else 1) * (n - 1)
    flags = {b: torch.tensor(b, device=device) for b in (False, True)}
    cur = torch.zeros_like(microbatches[0])
    sent = cur
    outputs = [cur] * m
    for t in range(m + lag):
        if overlap:
            # ship the last tick's output first: the hop depends only on
            # a value already computed
            pending = mesh.ppermute_start((sent,), axis_name)
        # stage 0 takes microbatch t in
        cur = torch.where(flags[stage == 0 and t < m],
                          microbatches[min(t, m - 1)], cur)
        y = stage_fn(stage_params, cur)
        # the last stage keeps finished microbatch t - lag
        j = max(t - lag, 0)
        outputs[j] = torch.where(flags[stage == n - 1 and t >= lag], y,
                                 outputs[j])
        if overlap:
            (cur,), sent = pending.wait(), y
        else:
            cur = mesh.ppermute(y, axis_name)
    return _LastStage.apply(torch.stack(outputs), mesh, axis_name,
                            float(stage == n - 1))


def make_pipeline(mesh, stage_fn, *, axis_name="stage", overlap=True):
    """Bind a pipeline to ``mesh``: returns ``f(stage_params,
    microbatches) -> outputs`` (:func:`pipeline_apply` on this rank's
    stage), with ``f.n_stages`` the size of ``axis_name``."""

    def call(stage_params, microbatches):
        return pipeline_apply(stage_fn, stage_params, microbatches,
                              mesh=mesh, axis_name=axis_name,
                              overlap=overlap)

    call.n_stages = mesh.axis_size(axis_name)
    return call
