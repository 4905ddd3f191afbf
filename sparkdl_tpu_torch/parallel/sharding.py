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
  projection is column-parallel, row-parallel or whole, and its
  companions (the int8 scale, the int4 scales, the LoRA adapters) take
  the split that role needs; the stacked MoE experts split their expert
  dim (0) and the router stays whole, with no role (every rank routes
  over all experts); a split the forward cannot compute raises.
- :func:`shard_params` slices each leaf to this rank's contiguous part.

There is no GSPMD here: the collectives are the model's own
(:class:`sparkdl_tpu_torch.parallel.mesh.Mesh`).
"""

import re

MODEL = "model"

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


def projection_roles(specs, mesh):
    """{projection prefix: "col" | "row" | "rep"} from the specs of the
    projections' weight leaves: "col" splits the output dim over the
    ``model`` axis, "row" the input dim, "rep" neither. Raises
    NotImplementedError for a split the forward cannot compute (another
    axis of size > 1, both dims, a stacked dim). An MoE router
    (``...router``) is computed whole outside the projections and takes
    no role."""
    axis_sizes = dict(mesh.shape)
    roles = {}
    for name, spec in specs.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf not in _KERNELS or prefix.rpartition(".")[2] == "router":
            continue
        split = split_dims(spec, axis_sizes)
        if not split:
            roles[prefix] = "rep"
        elif split in ({0: (MODEL,)}, {1: (MODEL,)}):
            roles[prefix] = "row" if 0 in split else "col"
        else:
            raise NotImplementedError(
                f"{name}: spec {spec} splits in a way the tensor-parallel "
                "forward cannot compute (only the 'model' axis over one "
                "of the two dims of a projection)")
    return roles


def tp_layout(params, rules, mesh):
    """The specs the port's tensor-parallel forward computes with:
    :func:`param_sharding`'s, with each projection's companions set by
    its role. A column-parallel projection takes the slice of its
    output columns of every companion: the int8 ``kernel_scale`` (N,),
    which the JAX rules replicate by the ``ndim`` rule, the int4
    ``kernel_scale4`` (K/g, N) and ``lora_b``; ``lora_a`` stays whole. A
    row-parallel one keeps the int8 scale whole (it scales the partial
    product before the all-reduce, exact for a per-column scale), splits
    the int4 scales' K/g rows with the packed (K/2, N) rows, and splits
    ``lora_a``'s input rows, keeping ``lora_b`` whole (the JAX rule
    splits ``lora_b``'s columns instead). The embedding may split
    d_model, the stacked experts their expert dim (0) over ``model``;
    norms, the MoE router and every other leaf must be whole. A companion is
    sliced from the whole leaf as its role needs, whatever its rule
    says, which is exact for each of them. Raises NotImplementedError
    naming the leaf and its spec for any split this design cannot
    compute."""
    specs = param_sharding(params, rules, mesh)
    axis_sizes = dict(mesh.shape)
    roles = projection_roles(specs, mesh)
    out = {}
    for name, spec in specs.items():
        prefix, _, leaf = name.rpartition(".")
        ndim = len(params[name].shape)
        split = split_dims(spec, axis_sizes)
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
            out[name] = want
            continue
        if (leaf == "embedding" and split in ({}, {1: (MODEL,)})) or (
                leaf in _EXPERTS and split in ({}, {0: (MODEL,)})):
            out[name] = spec
            continue
        if split:
            raise NotImplementedError(
                f"{name}: spec {spec} splits a leaf the tensor-parallel "
                "forward computes whole")
        out[name] = ()
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
