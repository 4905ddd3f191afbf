"""Tensor parallelism (Megatron, done explicitly) and ZeRO-3 storage for
the port's transformer models: one copy, which ``models.llama`` and
``models.bert`` both import.

The JAX package has no counterpart. There the models only name their
modules after ``TRANSFORMER_RULES`` and GSPMD derives every collective
from the params' shardings (``sparkdl_tpu/models/bert.py:1-4``). The
port has no GSPMD: each rank of a gang holds its slice of every split
weight and calls each collective itself, by name, on its mesh
(:mod:`sparkdl_tpu_torch.parallel.mesh`):

- :func:`shard_model` lays a model built on the full shapes out on its
  mesh by the rules (:func:`~sparkdl_tpu_torch.parallel.sharding.
  tp_layout`): every parameter takes this rank's local shape (the drawn
  values' slice when the model was drawn, uninitialised when it was laid
  out on ``meta``), every projection its role on ``model`` (``col``,
  ``row`` or ``rep``), a split LoRA projection its whole adapter leaf
  (``tp_whole``), an embedding split over d_model its ``tp_split``, and
  the leaves split over ``fsdp`` their ZeRO-3 units (:class:`Zero3`);
- :func:`tp_call` runs a projection under its role, moving its input
  and output between the layouts :data:`IN` and :data:`OUT` name
  (:func:`relayout`): Megatron's f where a whole input meets a split
  weight, g (an all-reduce) after a row-parallel product, an all-gather
  where a split output must be whole. :func:`fan_in` gives several
  column-parallel projections of one input one f.
- Biases (flax's ``Dense`` has one; the rules match only ``...kernel``,
  so a bias stays whole and replicated, as under GSPMD): a
  column-parallel projection adds its block of the whole bias, entered
  through f (its gradient summed over ``model``); a row-parallel one adds
  the whole bias once, after g (its gradient then the same on every rank,
  not summed).
- :class:`Zero3` gathers a unit's ``fsdp`` shards whole before its use:
  a unit is one block, ``layers.<i>`` under whatever prefix holds the
  blocks (``bert.layers.<i>`` in a head model), and ``"top"`` the leaves
  outside them.
"""

import contextlib
import dataclasses
import re

import torch
from torch import nn

from sparkdl_tpu_torch.models.lora import LoRADense, MultiLoRADense
from sparkdl_tpu_torch.parallel.mesh import (
    axis_sum,
    gather_shards,
    gathered,
    replicated,
)

# the last-dim layout of a projection's input and output by its
# tensor-parallel role: "full" (whole, every rank alike), "shared" (whole,
# entered through Megatron's f for a per-rank use), "split" (this rank's
# block), "partial" (a summand of the whole)
IN = {"col": "shared", "row": "split", "rep": "full"}
OUT = {"col": "split", "row": "partial", "rep": "full"}

# a block's leaves, whatever prefix holds the blocks
_UNIT = re.compile(r"(?:^|\.)layers\.(\d+)\.")
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class TP:
    """A tensor-parallel model's place on its mesh's ``model`` axis."""

    mesh: object
    rank: int
    size: int


def relayout(x, have, want, tp):
    """``x``'s last dim moved from layout ``have`` to ``want`` on the
    ``model`` axis, differentiably: a partial sum is all-reduced (g), a
    split made whole by an all-gather, a whole one entered through f for
    a per-rank use ("shared") and split by taking this rank's block. A
    shared tensor never goes back to "full": its gradient is a rank's
    share."""
    if have == want:
        return x
    if have == "partial":
        x, have = axis_sum(x, tp.mesh, "model"), "full"
    elif have == "split":
        x, have = gathered(x, tp.mesh, "model"), "full"
    if have == want:
        return x
    if have == "full":
        x = replicated(x, tp.mesh, "model")
    if want == "shared":
        return x
    n = x.shape[-1] // tp.size
    return x[..., tp.rank * n:(tp.rank + 1) * n]


def fan_in(x, modules, tp):
    """``(input, layout)`` of each of ``modules`` fed the whole ``x``:
    the column-parallel ones share one f (one all-reduce of their summed
    input gradients in the backward), the others take ``x``."""
    if tp is None:
        return [(x, "full")] * len(modules)
    shared = None
    out = []
    for module in modules:
        if IN[module.tp_role] == "shared":
            if shared is None:
                shared = relayout(x, "full", "shared", tp)
            out.append((shared, "shared"))
        else:
            out.append((x, "full"))
    return out


def _apply(module, x, adapter_ids):
    # a multi-LoRA projection selects each row's adapter
    if isinstance(module, MultiLoRADense):
        return module(x, adapter_ids)
    return module(x)


def tp_call(module, x, tp, have="full", want="full", adapter_ids=None):
    """``module`` over ``x``; under tensor parallelism (``tp``) ``x``
    comes in layout ``have`` and the output leaves in ``want``, each
    moved to and from the layouts of the module's role. A module's
    ``bias`` (whole on every rank) is added by role: its block by a
    column-parallel projection, the whole once after g by a
    row-parallel one."""
    if tp is None:
        return _apply(module, x, adapter_ids)
    role = module.tp_role
    x = relayout(x, have, IN[role], tp)
    bias = getattr(module, "bias", None)
    if bias is None or role == "rep":
        return relayout(_apply(module, x, adapter_ids), OUT[role], want, tp)
    if role == "col":
        n = bias.shape[-1] // tp.size
        block = replicated(bias, tp.mesh, "model")[
            ..., tp.rank * n:(tp.rank + 1) * n]
        with bound({(module, "bias"): block}):
            y = _apply(module, x, adapter_ids)
        return relayout(y, "split", want, tp)
    with bound({(module, "bias"): None}):
        y = _apply(module, x, adapter_ids)
    y = relayout(y, "partial", "full", tp)
    return relayout(y + bias.to(y.dtype), "full", want, tp)


@contextlib.contextmanager
def bound(weights):
    """Each ``(module, leaf)`` of ``weights`` reads as the given tensor
    (an instance attribute shadows the parameter) for the ``with``
    body; the module's parameters stay as they are, and a binding
    already in place comes back afterwards."""
    saved = [(owner, leaf, owner.__dict__.get(leaf, _UNSET))
             for owner, leaf in weights]
    for (owner, leaf), w in weights.items():
        owner.__dict__[leaf] = w
    try:
        yield
    finally:
        for owner, leaf, old in saved:
            if old is _UNSET:
                owner.__dict__.pop(leaf, None)
            else:
                owner.__dict__[leaf] = old


class Regather:
    """The note a gathered weight is saved as in the graph: its unit,
    its leaf and the saved view's geometry."""

    __slots__ = ("unit", "key", "geometry")

    def __init__(self, unit, key, t):
        self.unit, self.key = unit, key
        self.geometry = (t.size(), t.stride(), t.storage_offset())


def unit_of(name):
    """The ZeRO-3 unit of the leaf ``name``: ``i`` for a leaf of block
    ``layers.<i>`` under any prefix, ``"top"`` for the others."""
    m = _UNIT.search(name)
    return int(m.group(1)) if m else "top"


class Zero3:
    """A model's ZeRO-3 storage on its mesh's ``fsdp`` axis: the split
    leaves of each unit (:func:`unit_of`), with the dim each is cut
    along, gathered whole on demand. Every rank issues the same gathers
    in the same order: the units' leaves are taken in state-dict order,
    grouped by (dtype, trained)."""

    def __init__(self, model, mesh, dims):
        self.mesh = mesh
        modules = dict(model.named_modules())
        self.units = {}
        for name, dim in dims.items():
            owner, _, leaf = name.rpartition(".")
            self.units.setdefault(unit_of(name), []).append(
                (modules[owner], leaf, dim))
        self._again = None  # (unit, weights) gathered again in a backward

    def has(self, unit, module=None):
        return any(module is None or owner is module
                   for owner, _, _ in self.units.get(unit, ()))

    def gather(self, unit):
        """``{(module, leaf): whole}`` of ``unit``: one gather a (dtype,
        trained) group; differentiable when gradients are recorded."""
        groups = {}
        for owner, leaf, dim in self.units.get(unit, ()):
            p = owner._parameters[leaf]
            groups.setdefault((p.dtype, p.requires_grad), []).append(
                ((owner, leaf), p, dim))
        out = {}
        for items in groups.values():
            wholes = gather_shards([p for _, p, _ in items],
                                   [d for _, _, d in items], self.mesh,
                                   "fsdp")
            out.update(zip((k for k, _, _ in items), wholes))
        return out

    def release(self):
        self._again = None

    def _gathered_again(self, unit):
        if self._again is None or self._again[0] != unit:
            if self._again is None:
                # dropped when this backward ends
                torch.autograd.Variable._execution_engine.queue_callback(
                    self.release)
            self._again = None
            with torch.no_grad():
                self._again = (unit, self.gather(unit))
        return self._again[1]

    def run(self, unit, fn, *args, hooks=True):
        """``fn(*args)`` with ``unit``'s leaves gathered whole; with
        ``hooks`` and gradients recorded, the gathered weights the graph
        saves are noted, not kept, and gathered again in the backward."""
        weights = self.gather(unit)
        with bound(weights):
            if not (hooks and torch.is_grad_enabled()):
                return fn(*args)
            # by storage, not data_ptr: every meta storage (a traced
            # step's) has data_ptr 0
            ptrs = {w.untyped_storage()._cdata: k
                    for k, w in weights.items() if w.numel()}

            def pack(t):
                key = ptrs.get(t.untyped_storage()._cdata)
                return t if key is None else Regather(unit, key, t)

            def unpack(saved):
                if not isinstance(saved, Regather):
                    return saved
                whole = self._gathered_again(saved.unit)[saved.key]
                return whole.as_strided(*saved.geometry)

            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                return fn(*args)


def run_block(zero3, i, layer, *args, hooks=True):
    """Block ``i`` (``layer``) over ``args``: through ``zero3``'s unit
    when it has one, else as it is."""
    if zero3 is None or not zero3.has(i):
        return layer(*args)
    return zero3.run(i, layer, *args, hooks=hooks)


def shard_model(model, mesh, rules, device):
    """Lay ``model`` (built on the full shapes) out on ``mesh`` by
    ``rules`` (default ``TRANSFORMER_RULES``) as the module's doc says.
    Returns ``(tp_specs, zero3, tp)``: the layout, the ZeRO-3 units (None
    when ``fsdp`` is 1) and the :class:`TP` context (None when ``model``
    is 1). Raises NotImplementedError, naming the leaf, for a split the
    forward cannot compute."""
    from sparkdl_tpu_torch.parallel import sharding

    full = model.state_dict()
    rules = sharding.TRANSFORMER_RULES if rules is None else rules
    specs = sharding.tp_layout(full, rules, mesh)
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    for name, t in sharding.shard_params(full, specs, mesh).items():
        old = params.get(name)
        if old is None:
            continue
        owner, _, leaf = name.rpartition(".")
        if old.is_meta:
            local = torch.empty(t.shape, dtype=old.dtype, device=device)
        else:
            local = t.detach().to(device=device, dtype=old.dtype)
        setattr(modules[owner], leaf, nn.Parameter(
            local, requires_grad=old.requires_grad))
    dims = sharding.fsdp_dims(specs, mesh)
    zero3 = Zero3(model, mesh, dims) if dims else None
    size = mesh.axis_size("model")
    if size == 1:
        return specs, zero3, None
    for prefix, role in sharding.projection_roles(specs, mesh).items():
        modules[prefix].tp_role = role
        if isinstance(modules[prefix], LoRADense) and role != "rep":
            # the adapter leaf a split projection holds whole
            modules[prefix].tp_whole = (
                mesh, "lora_a" if role == "col" else "lora_b")
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        if leaf == "embedding":
            modules[owner].tp_split = "model" in sharding.split_dims(
                spec, mesh.shape).get(1, ())
    return specs, zero3, TP(mesh, mesh.axis_index("model"), size)


def local_params(model, params):
    """This rank's slice of the whole state dict (or flat JAX tree)
    ``params`` by ``model.tp_specs``; ``params`` itself for a model that
    is neither tensor-parallel nor ZeRO-3."""
    if model.mesh is None:
        return params
    from sparkdl_tpu_torch.parallel import sharding

    unknown = sorted(set(params) - set(model.tp_specs))
    if unknown:
        raise ValueError(f"params the model does not have: {unknown}")
    return sharding.shard_params(params, model.tp_specs, model.mesh)


def load_params(model, params, device):
    """Give ``model`` (built on ``meta``) the tensors of ``params`` (a
    state dict with its keys, this rank's slices already) as its
    weights, moved to ``device`` and cast to each weight's dtype where
    they differ, with no other copy; raises on a missing, unexpected or
    mis-shaped entry. Returns ``model``."""
    expected = model.state_dict()
    missing = sorted(set(expected) - set(params))
    unexpected = sorted(set(params) - set(expected))
    if missing or unexpected:
        raise ValueError(
            f"params do not match the model: missing {missing}, "
            f"unexpected {unexpected}")
    state = {}
    for name, ref in expected.items():
        t = torch.as_tensor(params[name])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, model expects "
                f"{tuple(ref.shape)}")
        state[name] = t.to(device=device, dtype=ref.dtype)
    model.load_state_dict(state, strict=True, assign=True)
    return model
