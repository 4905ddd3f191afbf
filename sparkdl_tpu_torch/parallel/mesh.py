"""The device mesh of a gang: named axes over its ranks, one process a
rank, and the collectives of one axis.

Counterpart of ``sparkdl_tpu/parallel/mesh.py``. Axes (any may be 1 and
is then effectively absent):

- ``data``  — pure data parallelism;
- ``fsdp``  — data parallelism with parameter sharding (ZeRO-3 style);
- ``seq``   — sequence/context parallelism;
- ``model`` — tensor parallelism (Megatron-style column/row splits).

There the mesh is an array of devices that GSPMD partitions one program
over. Here it is a port-owned :class:`Mesh` over the ranks of the
initialized default process group (a port gang, ``HorovodRunner``):
each rank knows its coordinate on every axis and holds one process
group per axis slice it belongs to, and a layer that needs a collective
calls it by name on its axis (:meth:`Mesh.all_reduce`,
:meth:`Mesh.all_gather`, :meth:`Mesh.broadcast`, the neighbour
exchange of ring attention and the pipeline, :meth:`Mesh.ppermute`, the
counterpart of ``lax.ppermute(x, axis, [(i, (i + 1) % n)])``, the
expert dispatch's :meth:`Mesh.all_to_all`, and ZeRO-3's
:meth:`Mesh.reduce_scatter`). Ranks are
laid out in row-major order of :meth:`MeshSpec.axis_sizes`, so the
``model`` axis varies fastest: the ranks of one tensor-parallel group
are consecutive. :func:`make_named_mesh` lays out one axis of any name (a
pipeline's ``stage``), as the JAX tests build ``jax.sharding.Mesh(devices,
("stage",))``.

The collectives above cut the autograd graph (the serving path runs
under ``no_grad``). Training through a mesh takes the differentiable
forms, Megatron's f and g, done explicitly as there is no GSPMD here:
:func:`axis_sum` (g: the sum of partial outputs, its cotangent handed
back once), :func:`replicated` (f: a replicated input used for a
per-rank share, the identity with its gradient summed over the axis)
and :func:`gathered` (a split output made whole, its gradient this
rank's block). Each takes the plain collective when no gradient is
being recorded. ZeRO-3 (``fsdp``) takes :func:`gather_shards` /
:func:`sharded_param`: parameter shards made whole for a use that
differs by rank (each rank's own rows of the batch), so the gradient of
a shard is the sum of every rank's gradient of the whole, reduce-
scattered.

The collectives follow the gang's wire rule
(:mod:`sparkdl_tpu_torch.hvd._state`): CUDA tensors go over NCCL when
every rank has a card of its own, and are staged through host memory
over gloo when ranks share a card (or there is none); dtypes a backend
lacks travel widened. A mesh of one rank needs no process group, and
its collectives return their input.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from sparkdl_tpu_torch.hvd import _collectives, _state

AXES = ("data", "fsdp", "seq", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    fsdp: int = 1
    seq: int = 1
    model: int = 1

    @property
    def size(self):
        return self.data * self.fsdp * self.seq * self.model

    def axis_sizes(self):
        return (self.data, self.fsdp, self.seq, self.model)


class Mesh:
    """This rank's view of a mesh: ``shape`` ({axis: size}),
    ``coords`` ({axis: this rank's coordinate}), and for every axis of
    size > 1 the global ranks of this rank's slice along it and their
    process group. ``device`` is the card the gang bound for this rank
    (None outside a gang: the caller names one)."""

    def __init__(self, axis_names, axis_sizes, rank=0, groups=None,
                 device=None):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in axis_sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names, "
                             f"{len(sizes)} sizes")
        self.shape = dict(zip(self.axis_names, sizes))
        self.rank = int(rank)
        coords = np.unravel_index(self.rank, sizes)
        self.coords = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self.groups = dict(groups or {})  # axis -> (ranks, process group)
        self.device = device

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_index(self, axis):
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords.get(axis, 0)

    def _group(self, axis):
        entry = self.groups.get(axis)
        return None if entry is None else entry[1]

    def all_reduce(self, x, axis):
        """The sum of ``x`` over the ranks of this rank's ``axis``
        slice (a row-parallel projection's partial products)."""
        group = self._group(axis)
        if group is None:
            return x
        w = _collectives._on_wire(x)
        dist.all_reduce(w, group=group)
        return _collectives._off_wire(w, x)

    def all_gather(self, x, axis, dim=-1):
        """The ``axis`` slice's ``x`` concatenated along ``dim`` (the
        last by default), in coordinate order (a column-parallel output
        made whole)."""
        group = self._group(axis)
        if group is None:
            return x
        n = self.axis_size(axis)
        w = _collectives._on_wire(x.movedim(dim, -1))
        # gathered along dim 0 (gloo takes no other output shape)
        out = w.new_empty((n * w.shape[0],) + tuple(w.shape[1:]))
        dist.all_gather_into_tensor(out, w, group=group)
        out = out.view((n,) + tuple(w.shape)).movedim(0, -2).reshape(
            *w.shape[:-1], n * w.shape[-1])
        return _collectives._off_wire(out, x).movedim(-1, dim)

    def reduce_scatter(self, x, axis, dim=0):
        """The sum of ``x`` over the ranks of this rank's ``axis`` slice,
        cut along ``dim`` into one block a coordinate, in coordinate
        order: this rank's block of the sum
        (``lax.psum_scatter(x, axis, scatter_dimension=dim,
        tiled=True)``)."""
        group = self._group(axis)
        if group is None:
            return x
        n = self.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axis}={n}")
        w = _collectives._on_wire(x.movedim(dim, 0))
        out = w.new_empty((w.shape[0] // n,) + tuple(w.shape[1:]))
        dist.reduce_scatter_tensor(out, w, group=group)
        return _collectives._off_wire(out, x).movedim(0, dim)

    def broadcast(self, x, axis):
        """The ``axis`` slice's first rank's ``x`` on every rank of the
        slice; returns a new tensor."""
        entry = self.groups.get(axis)
        if entry is None:
            return x
        ranks, group = entry
        w = _collectives._on_wire(x)
        dist.broadcast(w, src=ranks[0], group=group)
        return _collectives._off_wire(w, x)

    def all_to_all(self, x, axis):
        """The tiled all-to-all of ``x`` over ``axis``, split and
        concatenated on dim 0 (``lax.all_to_all(x, axis, split_axis=0,
        concat_axis=0, tiled=True)``): ``x``'s dim 0 is cut into one
        block a coordinate, block j goes to coordinate j, and what
        arrives is concatenated in coordinate order (a dispatch buffer
        to the ranks that hold its experts). Differentiable: the
        gradient takes the same all-to-all of the cotangents."""
        group = self._group(axis)
        if group is None:
            return x
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"over {axis}={n}")
        return _AllToAll.apply(self, axis, x)

    def _all_to_all(self, x, axis):
        w = _collectives._on_wire(x)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self._group(axis))
        return _collectives._off_wire(out, x)

    def ppermute_start(self, tensors, axis):
        """Issue the neighbour exchange of ``tensors`` on ``axis`` now:
        each goes to the next coordinate and the previous coordinate's
        arrive, all in one batch of sends and receives, all posted
        before any is waited for (at n = 2 the next rank is also the
        previous one). Returns a :class:`PendingPermute`; a ring
        computes on the block it holds before it waits. Every rank of
        the axis must issue the same exchanges in the same order."""
        return self._exchange(tuple(tensors), axis, 1)

    def ppermute(self, x, axis):
        """``x`` of the previous coordinate on ``axis``: one hop of the
        ring, differentiable (the gradient takes the reverse hop)."""
        return self.ppermute_start((x,), axis).wait()[0]

    def _exchange(self, tensors, axis, step):
        entry = self.groups.get(axis)
        if entry is None:
            return PendingPermute(self, axis, step, tensors, tensors, ())
        ranks, group = entry
        n, c = len(ranks), self.coords[axis]
        dst, src = ranks[(c + step) % n], ranks[(c - step) % n]
        sent = [_collectives._on_wire(x) for x in tensors]
        received = [torch.empty_like(w) for w in sent]
        ops = []
        for tag, (w, r) in enumerate(zip(sent, received)):
            ops.append(dist.P2POp(dist.isend, w, dst, group, tag=tag))
            ops.append(dist.P2POp(dist.irecv, r, src, group, tag=tag))
        works = dist.batch_isend_irecv(ops)
        # the send buffers live until the exchange is waited for
        return PendingPermute(self, axis, step, tensors, received,
                              (works, sent))


class PendingPermute:
    """A neighbour exchange in flight (:meth:`Mesh.ppermute_start`).
    :meth:`wait` returns what arrived, one tensor for each sent, in the
    senders' dtypes and on their devices. When a sent tensor requires a
    gradient, what arrived carries one back: its gradient takes the
    reverse hop to the sender."""

    def __init__(self, mesh, axis, step, tensors, received, inflight):
        self._mesh, self._axis, self._step = mesh, axis, step
        self._tensors, self._received = tensors, received
        self._inflight = inflight

    def wait(self):
        if not self._inflight:
            return tuple(self._received)  # a mesh of one: the input
        works, _ = self._inflight
        for work in works:
            work.wait()
        out = [_collectives._off_wire(r, x)
               for r, x in zip(self._received, self._tensors)]
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in self._tensors):
            out = _Arrived.apply(self._mesh, self._axis, self._step, out,
                                 *self._tensors)
        return tuple(out)


class _Arrived(torch.autograd.Function):
    """The autograd node of a hop: its outputs are what arrived (from
    the previous coordinate), its inputs what this rank sent; the
    gradient of an output is sent back to the previous coordinate, and
    the gradient of an input arrives from the next one. Every rank runs
    the same graph, so every rank's backward issues these reverse hops
    in the same order."""

    @staticmethod
    def forward(ctx, mesh, axis, step, arrived, *sent):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return tuple(arrived)

    @staticmethod
    def backward(ctx, *grads):
        grads = tuple(g.contiguous() for g in grads)
        back = ctx.mesh._exchange(grads, ctx.axis, -ctx.step).wait()
        return (None, None, None, None, *back)


class _AllToAll(torch.autograd.Function):
    """The autograd node of :meth:`Mesh.all_to_all`: block j of this
    rank's input became block r of rank j's output, so the cotangent of
    block r of rank j's output comes back by the same exchange."""

    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._all_to_all(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return None, None, ctx.mesh._all_to_all(grad.contiguous(), ctx.axis)


class _AxisSum(torch.autograd.Function):
    """The sum over an axis of partial outputs that every rank then
    uses alike: every rank's loss is the same function of the sum, so
    each rank's cotangent is handed back once (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Replicated(torch.autograd.Function):
    """A replicated input that every rank uses for its own share: the
    identity forward, its gradient summed over the axis (Megatron's f),
    so each rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous(), ctx.axis), None, None


class _Gathered(torch.autograd.Function):
    """The all-gather of split blocks along ``dim`` into a whole that
    every rank uses alike: the cotangent of the whole is the same on
    every rank, and this rank's block of it is its block's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.width = x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.axis_index(ctx.axis) * ctx.width
        return grad.narrow(ctx.dim, lo, ctx.width), None, None, None


def _whole_of(flat, shards, dims, n):
    """The whole tensors of an all-gathered flat buffer ``flat`` (n
    coordinates' concatenated shards, coordinate-major): each shard's n
    blocks concatenated along its ``dim``, a fresh tensor each."""
    rows = flat.view(n, -1)
    out, offset = [], 0
    for s, dim in zip(shards, dims):
        blocks = rows[:, offset:offset + s.numel()].view(n, *s.shape)
        offset += s.numel()
        shape = list(s.shape)
        shape[dim] *= n
        out.append(blocks.movedim(0, dim).reshape(shape))
    return out


def _gather_flat(shards, dims, mesh, axis):
    n = mesh.axis_size(axis)
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    return _whole_of(mesh.all_gather(flat, axis, dim=0), shards, dims, n)


class _GatheredShards(torch.autograd.Function):
    """ZeRO-3's gather of trained parameter shards: the forward one
    all-gather of their flat concatenation, the backward one summed
    reduce-scatter of the wholes' cotangents laid out the same way, so
    each rank's shard receives the sum of every rank's gradient of its
    block (each rank used the whole on its own rows of the batch)."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, *shards):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, dims
        ctx.shapes = [s.shape for s in shards]
        return tuple(_gather_flat(shards, dims, mesh, axis))

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.axis_size(ctx.axis)
        like = next(g for g in grads if g is not None)
        rows = []
        for g, shape, dim in zip(grads, ctx.shapes, ctx.dims):
            whole = list(shape)
            whole[dim] *= n
            if g is None:  # a whole this rank's loss did not use
                g = like.new_zeros(whole)
            # (n, shard) blocks in coordinate order, one row a rank
            rows.append(g.unflatten(dim, (n, shape[dim])).movedim(dim, 0)
                        .reshape(n, -1))
        mine = ctx.mesh.reduce_scatter(torch.cat(rows, dim=1).reshape(-1),
                                       ctx.axis, dim=0)
        out, offset = [], 0
        for shape in ctx.shapes:
            size = math.prod(shape)
            out.append(mine[offset:offset + size].view(shape))
            offset += size
        return (None, None, None, *out)


def gather_shards(shards, dims, mesh, axis):
    """The whole tensors of which ``shards`` are this rank's blocks along
    ``dims`` (one a shard) on ``axis``, in one all-gather of their flat
    concatenation (one dtype and device). Differentiable for ZeRO-3:
    when a shard requires a gradient, the backward reduce-scatters the
    wholes' cotangents (summed over the axis), so every rank must use the
    wholes in its own loss. Do not use :func:`gathered` for that: its
    backward takes this rank's block of the cotangent, right only when
    every rank's cotangent of the whole is the same (tensor
    parallelism)."""
    shards, dims = list(shards), tuple(dims)
    if mesh.axis_size(axis) == 1:
        return shards
    if torch.is_grad_enabled() and any(s.requires_grad for s in shards):
        return list(_GatheredShards.apply(mesh, axis, dims, *shards))
    with torch.no_grad():
        return _gather_flat(shards, dims, mesh, axis)


def sharded_param(x, mesh, axis, dim=0):
    """The whole parameter of which ``x`` is this rank's ``dim`` block
    on ``axis`` (:func:`gather_shards` of one shard): the all-gather
    forward, the reduce-scatter of the cotangent backward."""
    return gather_shards((x,), (dim,), mesh, axis)[0]


def _recording(x):
    return torch.is_grad_enabled() and x.requires_grad


def axis_sum(x, mesh, axis):
    """``mesh.all_reduce(x, axis)``, differentiable as Megatron's g: the
    partial outputs of a row-parallel projection summed, the cotangent
    of the sum each partial's."""
    if mesh.axis_size(axis) == 1:
        return x
    if _recording(x):
        return _AxisSum.apply(x, mesh, axis)
    return mesh.all_reduce(x, axis)


def replicated(x, mesh, axis):
    """``x``, a tensor every rank of ``axis`` holds alike, entered for a
    per-rank share (Megatron's f): the identity, its gradient summed
    over the axis. Apply it once to an input that several per-rank uses
    share (Q, K and V; gate and up)."""
    if mesh.axis_size(axis) == 1 or not _recording(x):
        return x
    return _Replicated.apply(x, mesh, axis)


def gathered(x, mesh, axis, dim=-1):
    """``mesh.all_gather(x, axis, dim)``, differentiable: the gradient of
    this rank's block is its block of the whole's cotangent."""
    if mesh.axis_size(axis) == 1:
        return x
    if _recording(x):
        return _Gathered.apply(x, mesh, axis, dim)
    return mesh.all_gather(x, axis, dim)


def make_mesh(spec=None):
    """This rank's :class:`Mesh` over the initialized default process
    group, shaped by ``spec`` (default: every rank on the ``data`` axis).
    Raises when the world size is not ``spec.size``. Every rank of the
    group must call it, in the same order as its other collectives: each
    axis slice's process group is created collectively. Without a
    process group the world is this one rank."""
    world, rank = _world()
    if spec is None:
        spec = MeshSpec(data=world)
    if spec.size != world:
        raise ValueError(f"MeshSpec {spec} needs {spec.size} ranks, the "
                         f"process group has {world}")
    return _build_mesh(AXES, spec.axis_sizes(), world, rank)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_named_mesh(name):
    """This rank's :class:`Mesh` with one axis, of any name, over the
    whole process group (a pipeline's ``stage`` axis:
    ``make_named_mesh("stage")``), as the JAX tests build
    ``jax.sharding.Mesh(devices, ("stage",))``. Every rank must call
    it, in the same order as its other collectives."""
    world, rank = _world()
    return _build_mesh((name,), (world,), world, rank)


def _build_mesh(axis_names, sizes, world, rank):
    layout = np.arange(world).reshape(sizes)
    groups = {}
    for i, axis in enumerate(axis_names):
        if sizes[i] == 1:
            continue
        # every slice along this axis, each its own group; all ranks
        # create every group, in the same order
        slices = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
        for ranks in slices.tolist():
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = (ranks, group)
    st = _state.state()
    device = st.device if st.device is not None and \
        st.device.type == "cuda" else None
    return Mesh(axis_names, sizes, rank, groups, device)


def make_mesh_from_axes(axes):
    """Mesh from an axis-size dict (``{"data": 2, "model": 4}``); unknown
    axis names are an error, absent axes default to 1."""
    unknown = sorted(set(axes) - set(AXES))
    if unknown:
        raise ValueError(
            f"unknown mesh axes {unknown}; this runtime's axes are "
            f"{list(AXES)}")
    return make_mesh(MeshSpec(**{a: int(axes.get(a, 1)) for a in AXES}))


def best_mesh(n_devices, *, model_parallel=1, seq_parallel=1, fsdp=False):
    """Heuristic spec: give ``model``/``seq`` what was asked, put the rest
    on ``data`` (or ``fsdp``)."""
    rest = n_devices // (model_parallel * seq_parallel)
    if rest * model_parallel * seq_parallel != n_devices:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel="
            f"{model_parallel} * seq_parallel={seq_parallel}")
    if fsdp:
        return MeshSpec(data=1, fsdp=rest, seq=seq_parallel,
                        model=model_parallel)
    return MeshSpec(data=rest, fsdp=1, seq=seq_parallel,
                    model=model_parallel)


def log2_factors(n):
    """(a, b) with a*b == n, as square as possible (both powers of 2
    when n is)."""
    a = 2 ** (int(math.log2(n)) // 2) if n > 1 else 1
    while n % a:
        a //= 2
    return a, n // a
