"""Sharding rules: which dimension of each parameter a mesh axis splits,
and this rank's slice of it.

Counterpart of ``sparkdl_tpu/parallel/sharding.py``. The rules are the
JAX package's, name-based regex -> per-dimension spec, matched against
the port's state-dict names, which keep the JAX tree's keys with
``layer_<i>`` as ``layers.<i>`` (``layers.3.attn.q_proj.kernel``), so
the JAX patterns match unchanged. A spec is a tuple with one entry a
dimension: None (whole), an axis name, or a tuple of axis names.

- :func:`param_sharding` gives ``{name: spec}`` by the JAX rules: first
  matching rule wins, no match is replicated (``()``), a split that does
  not divide the leaf or names a dimension past its ``ndim`` is
  replicated, and stacked ``lora_a`` / ``lora_b`` (N, ...) are
  left-padded so their trailing dims keep the 2-D rule.
- :func:`tp_layout` turns those specs into the layout the port's
  explicit Megatron forward computes with (``models.llama``): each
  projection is column-parallel, row-parallel or whole on ``model``, and
  its companions (the int8 scale, the int4 scales, the LoRA adapters)
  take the split that role needs; the stacked MoE experts split their
  expert dim (0) and the router stays whole, with no role (every rank
  routes over all experts); the rules' ``fsdp`` entries stay, as the
  ZeRO-3 storage split (:func:`fsdp_dims` lists each leaf's dim); a
  split the forward cannot compute raises.
- :func:`shard_params` slices each leaf to this rank's contiguous part.
- :func:`constrain` re-lays an activation to a spec (the JAX
  ``with_sharding_constraint``), :func:`full_host_value` gathers a leaf
  whole, :func:`named_sharding_for` re-lays a recorded spec onto another
  mesh, and :func:`sharding_tree_info` / :func:`tp_param_info` give the
  sharding tree as data (the reshard plan's and the checkpoint
  sidecar's input).

There is no GSPMD here: the collectives are the model's own
(:class:`sparkdl_tpu_torch.parallel.mesh.Mesh`).
"""

import re

from sparkdl_tpu_torch.parallel.mesh import gathered, replicated

MODEL = "model"
FSDP = "fsdp"

# Megatron-style rules for the transformer models: column-parallel
# up-projections, row-parallel down-projections, replicated norms.
TRANSFORMER_RULES = [
    (r"embed.*embedding", (None, "model")),
    (r"(q_proj|k_proj|v_proj|qkv).*kernel", (("fsdp",), "model")),
    (r"o_proj.*kernel", ("model", ("fsdp",))),
    (r"(gate_proj|up_proj|fc1).*kernel", (("fsdp",), "model")),
    (r"(down_proj|fc2).*kernel", ("model", ("fsdp",))),
    (r"lm_head.*kernel", (("fsdp",), "model")),
    (r"lora_a$", (None, None)),
    (r"lora_b$", (None, "model")),
    # Stacked MoE expert weights (E, d, f): experts over 'model', the
    # per-expert matrix over 'fsdp'
    (r"w_(gate|up|down)$", ("model", ("fsdp",))),
    (r"(norm|ln|layernorm).*", ()),
]

# the weight leaves of a projection, and what rides along with them
_KERNELS = ("kernel", "kernel_q", "kernel_q4")
_COMPANIONS = ("kernel_scale", "kernel_scale4", "lora_a", "lora_b")
# the stacked MoE expert leaves (E, ...), split only on the expert dim
_EXPERTS = ("w_gate", "w_up", "w_down")


def _match(rules, path):
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return None


def _names(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def param_sharding(params, rules, mesh):
    """``{name: spec}`` for the state dict ``params`` ({name: tensor or
    array}, anything with ``shape``) on ``mesh`` (an object with a
    ``shape`` dict of axis sizes), by the JAX package's rules."""
    axis_sizes = dict(mesh.shape)

    def spec_for(path, shape):
        spec = _match(rules, path)
        if spec is None:
            return ()
        # a one-name tuple is that name, as a JAX PartitionSpec holds it
        spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
        ndim = len(shape)
        if len(spec) < ndim and re.search(r"lora_(a|b)$", path):
            # stacked multi-adapter leaves (N, ...) reuse the 2-D rules
            spec = (None,) * (ndim - len(spec)) + spec
        for dim, entry in enumerate(spec):
            names = _names(entry)
            if not names:
                continue
            total = 1
            for a in names:
                total *= axis_sizes[a]
            if dim >= ndim or shape[dim] % total:
                return ()
        return spec

    return {name: spec_for(name, tuple(leaf.shape))
            for name, leaf in params.items()}


def split_dims(spec, axis_sizes):
    """{dim: axes} of the entries that split (axes of size > 1)."""
    out = {}
    for dim, entry in enumerate(spec):
        names = tuple(a for a in _names(entry) if axis_sizes.get(a, 1) > 1)
        if names:
            out[dim] = names
    return out


def _padded(ndim, spec):
    """A 2-D spec left-padded to ``ndim`` (stacked adapters)."""
    return (None,) * (ndim - len(spec)) + tuple(spec)


def _check_axes(name, spec, split):
    """Raise for a split the port cannot compute: an axis other than
    ``model`` and ``fsdp``, or one dim over both."""
    for dim, axes in split.items():
        other = sorted(set(axes) - {MODEL, FSDP})
        if other:
            raise NotImplementedError(
                f"{name}: spec {spec} splits dim {dim} over {other}; a "
                "parameter splits over 'model' (tensor parallelism) and "
                "'fsdp' (ZeRO-3 storage) only")
        if len(axes) > 1:
            raise NotImplementedError(
                f"{name}: spec {spec} splits dim {dim} over both "
                f"{list(axes)}; each axis must split a dim of its own")


def _model_split(split):
    return {d: a for d, a in split.items() if MODEL in a}


def projection_roles(specs, mesh):
    """{projection prefix: "col" | "row" | "rep"} from the specs of the
    projections' weight leaves: "col" splits the output dim over the
    ``model`` axis, "row" the input dim, "rep" neither. An ``fsdp``
    split is storage (ZeRO-3: gathered whole before each use) and gives
    no role. Raises NotImplementedError for a split the forward cannot
    compute (another axis of size > 1, both dims or a stacked dim over
    ``model``, one dim over two axes). An MoE router (``...router``) is
    computed whole outside the projections and takes no role."""
    axis_sizes = dict(mesh.shape)
    roles = {}
    for name, spec in specs.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf not in _KERNELS or prefix.rpartition(".")[2] == "router":
            continue
        split = split_dims(spec, axis_sizes)
        _check_axes(name, spec, split)
        model = _model_split(split)
        if not model:
            roles[prefix] = "rep"
        elif model in ({0: (MODEL,)}, {1: (MODEL,)}):
            roles[prefix] = "row" if 0 in model else "col"
        else:
            raise NotImplementedError(
                f"{name}: spec {spec} splits in a way the tensor-parallel "
                "forward cannot compute (only the 'model' axis over one "
                "of the two dims of a projection)")
    return roles


def _with_fsdp(name, want, spec, ndim, axis_sizes):
    """``want`` (a spec of ``model`` entries) with the ``fsdp`` entries
    of the rules' ``spec`` added: the ZeRO-3 storage split."""
    dims = [d for d, e in enumerate(spec) if FSDP in _names(e)]
    if not dims:
        return want
    out = list(want) + [None] * (ndim - len(want))
    for d in dims:
        if out[d] is None:
            out[d] = FSDP
        elif axis_sizes.get(FSDP, 1) > 1:
            raise NotImplementedError(
                f"{name}: its role splits dim {d} over {out[d]!r}, where "
                f"the rules put 'fsdp' ({spec}); each axis must split a "
                "dim of its own")
    return tuple(out)


def tp_layout(params, rules, mesh):
    """The specs the port's forward computes with: :func:`param_sharding`'s,
    with each projection's companions set by its role on ``model``
    (tensor parallelism) and every ``fsdp`` entry of the rules kept (the
    ZeRO-3 storage split, gathered whole before each use). A
    column-parallel projection takes the slice of its output columns of
    every companion: the int8 ``kernel_scale`` (N,), which the JAX rules
    replicate by the ``ndim`` rule, the int4 ``kernel_scale4`` (K/g, N)
    and ``lora_b``; ``lora_a`` stays whole. A row-parallel one keeps the
    int8 scale whole (it scales the partial product before the
    all-reduce, exact for a per-column scale), splits the int4 scales'
    K/g rows with the packed (K/2, N) rows, and splits ``lora_a``'s
    input rows, keeping ``lora_b`` whole (the JAX rule splits
    ``lora_b``'s columns instead). The embedding may split d_model, the
    stacked experts their expert dim (0) over ``model``; norms, the MoE
    router and every other leaf must be whole on ``model``. A companion
    is sliced from the whole leaf as its role needs, whatever its rule
    says, which is exact for each of them. The ``fsdp`` entries are the
    rules' (dim 0 of the q/k/v/gate/up/head kernels, dim 1 of o/down,
    the int4 scales' by the same patterns, dim 1 of the stacked
    experts). Raises NotImplementedError naming the leaf and its spec
    for any split this design cannot compute."""
    specs = param_sharding(params, rules, mesh)
    axis_sizes = dict(mesh.shape)
    roles = projection_roles(specs, mesh)
    out = {}
    for name, spec in specs.items():
        prefix, _, leaf = name.rpartition(".")
        ndim = len(params[name].shape)
        split = split_dims(spec, axis_sizes)
        _check_axes(name, spec, split)
        model = _model_split(split)
        if leaf in _KERNELS and prefix in roles:
            out[name] = spec
            continue
        if leaf in _COMPANIONS and prefix in roles:
            role = roles[prefix]
            want = {
                ("col", "kernel_scale"): (MODEL,),
                ("col", "kernel_scale4"): (None, MODEL),
                ("col", "lora_a"): _padded(ndim, (None, None)),
                ("col", "lora_b"): _padded(ndim, (None, MODEL)),
                ("row", "kernel_scale"): (),
                ("row", "kernel_scale4"): (MODEL, None),
                ("row", "lora_a"): _padded(ndim, (MODEL, None)),
                ("row", "lora_b"): (),
            }.get((role, leaf), ())
            size = axis_sizes.get(MODEL, 1)
            for dim, entry in enumerate(want):
                if entry is not None and (
                        params[name].shape[dim] % size):
                    raise NotImplementedError(
                        f"{name}: dim {dim} of shape "
                        f"{tuple(params[name].shape)} does not split "
                        f"over model={size} as its {role}-parallel "
                        "projection needs (int4 row-parallel: the local "
                        "K must hold whole groups)")
            out[name] = _with_fsdp(name, want, spec, ndim, axis_sizes)
            continue
        if (leaf == "embedding" and model in ({}, {1: (MODEL,)})) or (
                leaf in _EXPERTS and model in ({}, {0: (MODEL,)})):
            out[name] = spec
            continue
        if model:
            raise NotImplementedError(
                f"{name}: spec {spec} splits a leaf the tensor-parallel "
                "forward computes whole")
        out[name] = _with_fsdp(name, (), spec, ndim, axis_sizes)
    return out


def fsdp_dims(specs, mesh):
    """{leaf: dim} of every leaf that ``specs`` split over ``fsdp`` on
    ``mesh`` (size > 1): the dim its ZeRO-3 shard is cut along, which a
    gather makes whole again. Empty when ``fsdp`` is 1."""
    axis_sizes = dict(mesh.shape)
    out = {}
    for name, spec in specs.items():
        for dim, axes in split_dims(spec, axis_sizes).items():
            if FSDP in axes:
                out[name] = dim
    return out


def shard_params(params, specs, mesh):
    """This rank's local, contiguous slice of every leaf of ``params``
    by ``specs`` (:func:`tp_layout`): each split dimension keeps the
    block of this rank's coordinate on its axes (row-major over the
    named axes). A whole leaf is returned as it is; a split one is a
    fresh contiguous copy (torch) or array (numpy), so the full leaf
    can be freed."""
    axis_sizes = dict(mesh.shape)
    out = {}
    for name, leaf in params.items():
        split = split_dims(specs.get(name, ()), axis_sizes)
        if not split:
            out[name] = leaf
            continue
        index = [slice(None)] * len(leaf.shape)
        for dim, axes in split.items():
            n, k = 1, 0
            for a in axes:
                n *= axis_sizes[a]
                k = k * axis_sizes[a] + mesh.axis_index(a)
            block = leaf.shape[dim] // n
            index[dim] = slice(k * block, (k + 1) * block)
        part = leaf[tuple(index)]
        if not hasattr(part, "is_contiguous"):
            out[name] = part.copy()  # numpy: a C-contiguous copy
        elif part.is_contiguous():
            out[name] = part.clone()
        else:
            out[name] = part.contiguous()
    return out


def constrain(x, spec, mesh, have=()):
    """``x``, laid out on ``mesh`` by ``have`` (default whole), re-laid
    to ``spec``: the counterpart of the JAX package's ``constrain``
    (``with_sharding_constraint``), done here by the rank itself. Each
    dim whose split changes is gathered whole over its ``have`` axes and
    then sliced to this rank's block of its ``spec`` axes (row-major
    over the named axes, as :func:`shard_params` slices). Differentiable:
    a gather's gradient is this rank's block, and a whole tensor enters
    a slice through f (its gradient summed over the axis). Every rank of
    the axes must call it together."""
    axis_sizes = dict(mesh.shape)
    have_split = split_dims(have, axis_sizes)
    want_split = split_dims(spec, axis_sizes)
    for dim in sorted(set(have_split) | set(want_split)):
        old, new = have_split.get(dim, ()), want_split.get(dim, ())
        if old == new:
            continue
        for axis in reversed(old):  # the minor axis first
            x = gathered(x, mesh, axis, dim)
        for axis in new:
            x = replicated(x, mesh, axis)
            n = x.shape[dim] // axis_sizes[axis]
            x = x.narrow(dim, mesh.axis_index(axis) * n, n)
    return x


def full_host_value(x, spec, mesh):
    """The whole leaf of which ``x`` is this rank's block by ``spec`` on
    ``mesh``, on the host (a CPU tensor): gathered over every split dim.
    A collective: every rank of the split axes calls it, in the same
    order (the checkpoint's gather before a save). A whole leaf is
    copied to the host as it is."""
    import torch

    with torch.no_grad():
        for dim, axes in split_dims(spec, dict(mesh.shape)).items():
            for axis in reversed(axes):
                x = mesh.all_gather(x, axis, dim)
        return x.detach().to("cpu", copy=True)


def named_sharding_for(mesh, spec_dims):
    """A recorded per-dim spec (lists of axis names, the sharding tree
    as data) re-laid onto ``mesh``: names the mesh does not have are
    dropped (that dim goes whole), the others keep their split. Returns
    the spec as this package holds one (an entry a dim: None, a name or
    a tuple of names); the port has no ``NamedSharding``."""
    have = {str(a) for a in mesh.axis_names}
    entries = []
    for dims in (spec_dims or ()):
        kept = tuple(str(n) for n in (dims or ()) if str(n) in have)
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(kept)
    return tuple(entries)


def sharding_tree_info(params, specs, mesh):
    """The sharding tree as data: one
    :class:`~sparkdl_tpu_torch.analysis.core.ParamInfo` a leaf of
    ``params`` (this rank's leaves, a tensor-parallel model's state
    dict), with the whole leaf's shape (the local one times each dim's
    split) and dtype, the per-dim axis names of its spec in ``specs``
    (absent: whole), the axes of size > 1 that split it, and ``mesh``'s
    axis sizes. What the reshard plan and the checkpoint's sidecar
    read; no live object, so it pickles and diffs."""
    from sparkdl_tpu_torch.analysis.core import ParamInfo

    sizes = {str(a): int(n) for a, n in dict(mesh.shape).items()}
    mesh_axes = tuple(sorted(sizes.items()))
    out = []
    for name, leaf in params.items():
        shape = [int(d) for d in leaf.shape]
        spec = tuple(specs.get(name, ()) or ())
        dims = [tuple(str(a) for a in _names(entry)) for entry in spec]
        dims = (dims + [()] * len(shape))[:len(shape)]
        for dim, axes in enumerate(dims):
            for a in axes:
                shape[dim] *= sizes.get(a, 1)
        out.append(ParamInfo(
            path=name, shape=tuple(shape),
            dtype=str(leaf.dtype).rpartition(".")[2],  # "bfloat16"
            sharded_axes=tuple(a for axes in dims for a in axes
                               if sizes.get(a, 2) > 1),
            spec=tuple(dims), mesh_axes=mesh_axes))
    return out


def tp_param_info(params, specs, mesh):
    """Which leaves ``specs`` split on ``mesh``: the same list as
    :func:`sharding_tree_info` (the JAX package's two names for it); an
    entry with empty ``sharded_axes`` is whole."""
    return sharding_tree_info(params, specs, mesh)
