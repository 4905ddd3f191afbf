"""Mixture-of-Experts MLP with expert parallelism.

Counterpart of ``sparkdl_tpu/models/moe.py``: a top-k routed SwiGLU
expert MLP (Mixtral-style) whose stacked expert weights (E, d, f) shard
over a mesh axis, with the JAX package's two execution models behind
the same routing:

- psum-combine (:func:`expert_parallel_moe`): every rank computes its
  LOCAL experts for all (replicated) tokens and the partial outputs are
  summed over the axis; FLOPs scale with n_experts x all tokens.
- all-to-all dispatch (:func:`expert_parallel_moe_a2a`): each rank's
  tokens travel to their experts' ranks in fixed-capacity buffers
  (:meth:`~sparkdl_tpu_torch.parallel.mesh.Mesh.all_to_all`) and back;
  FLOPs scale with the capacity.

:func:`moe_apply` is the JAX package's dense gate-weighted combine:
every expert held here computes every token, and the gates (zero off
each token's top k) weight the sum. The expert products are plain
``torch.einsum``, as the JAX package leaves them to XLA outside any
kernel.

Differences from the JAX package:

- top-k membership (:func:`_topk_mask`) takes the larger probability
  first and, on equal probabilities, the lower expert index first, the
  order ``jax.lax.top_k`` returns; ``torch.topk`` breaks ties otherwise,
  and a freshly built router is near-uniform.
- the router probabilities are recorded for the aux loss into the
  ``record`` dict a forward is handed (the model's
  ``forward(..., return_intermediates=True)``), not sown into a flax
  collection; a recompute under activation checkpointing records
  nothing again.
- the expert-parallel binders take this rank's shard (per-rank SPMD
  over the port's ``Mesh``, one process a rank), not global arrays
  under ``shard_map``: ``f(params, x)`` takes this rank's local experts
  (E/n, d, f) and the replicated router, and ``x`` replicated (psum
  form) or this rank's token shard (all-to-all form).
  ``moe_apply``'s ``axis_name`` is ``axis=(mesh, axis_name)``.
- gradients: every rank runs the same loss. A replicated input (the
  router, and the psum form's tokens) enters through an identity whose
  gradient is summed over the axis, and the psum form's axis sum hands
  its cotangent back once (Megatron's f and g), so each rank's gradient
  of a replicated input is the dense model's (a ``psum`` transpose would
  count it once a rank).
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel.mesh import axis_sum, replicated

# the expert weights, stacked on a leading expert dim
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 4
    top_k: int = 2
    dtype: torch.dtype = torch.float32


class Router(nn.Module):
    """The router: a Dense with bias over fp32 inputs, fp32 weights
    (``kernel`` (d, E), ``bias`` (E,)), as the JAX
    ``nn.Dense(n_experts, dtype=float32)``."""

    def __init__(self, d_model, n_experts, device):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty((d_model, n_experts), dtype=torch.float32,
                        device=device), requires_grad=False)
        self.bias = nn.Parameter(
            torch.empty((n_experts,), dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        return x.to(torch.float32) @ self.kernel + self.bias


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU expert MLP over stacked expert weights
    ``w_gate`` / ``w_up`` (E, d, f) and ``w_down`` (E, f, d) in
    ``cfg.dtype``, and the fp32 :class:`Router`. The weights are
    allocated uninitialised and frozen (a loader, ``init_weights`` or
    ``requires_grad_`` follows).

    Inside a tensor-parallel model (``tp`` set by the model) the module
    holds this rank's E/m experts (the expert rule splits dim 0 over
    ``model``), weights them by its slice of the gates and all-reduces
    the partial output over ``model``: :func:`expert_parallel_moe`'s
    combine."""

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = Router(d, e, device)
        for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                            ("w_down", (e, f, d))):
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device),
                requires_grad=False))
        self.tp = None  # the tensor-parallel context (set by the model)

    def forward(self, x, record=None):
        """``record``: a dict that receives ``{"router_probs":
        (probs,)}`` once (the JAX ``sow``), or None."""
        cfg = self.cfg
        probs = torch.softmax(self.router(x), dim=-1)      # (..., E) f32
        if record is not None and "router_probs" not in record:
            record["router_probs"] = (probs,)
        gates = gates_from_probs(probs, cfg.top_k).to(cfg.dtype)
        weights = (self.w_gate, self.w_up, self.w_down)
        tp, e_local = self.tp, self.w_gate.shape[0]
        if tp is None or e_local == cfg.n_experts:
            return moe_apply(x, gates, *weights)
        # the tokens and the gates, whole on every rank, enter this
        # rank's experts through f: their gradients sum every rank's
        axis = (tp.mesh, "model")
        lo = tp.rank * e_local
        return moe_apply(replicated(x, *axis),
                         replicated(gates, *axis)[..., lo:lo + e_local],
                         *weights, axis=axis)


def _topk_mask(probs, top_k):
    """Exact top-k membership mask (..., E) in {0, 1}: the ``top_k``
    largest probabilities, the lower index first among equal ones (the
    order ``jax.lax.top_k`` returns). A ``probs >= kth_value``
    comparison would select more than ``top_k`` experts on ties."""
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :top_k]
    return torch.zeros_like(probs).scatter_(-1, idx, 1.0)


def gates_from_probs(probs, top_k):
    """Top-k gates from router probabilities, renormalized over the
    selected experts."""
    gated = probs * _topk_mask(probs, top_k)
    return gated / torch.clamp(gated.sum(dim=-1, keepdim=True), min=1e-9)


def moe_gates(logits, top_k):
    """Top-k softmax gates, renormalized over the selected experts."""
    return gates_from_probs(torch.softmax(logits, dim=-1), top_k)


def load_balance_loss(probs, top_k, *, mesh=None):
    """Router load-balance auxiliary (switch-transformer form,
    generalized to top-k): ``E * sum_e f_e * P_e`` where ``f_e`` is the
    fraction of tokens routing to expert e (top-k membership) and
    ``P_e`` the mean router probability. Perfectly balanced routing
    gives ``top_k``; imbalance grows it toward ``E * top_k``.

    ``mesh``: the model's mesh. On a mesh whose data-like axes
    (``data``, ``fsdp``, ``seq``) of size > 1 split the batch (product
    R), this rank returns ``E * sum_e f_global[e] * P_r[e]``: ``f`` is
    the mean of the ranks' ``f`` (one all-reduce of the detached vector
    over those axes, divided by R; like the top-k mask it has no
    gradient) and ``P_r`` this rank's own mean probability, with its
    gradient. The value a rank returns is not the global aux; its mean
    over the ranks is, in value and in gradient, since every rank holds
    equally many tokens, and that mean is what the mesh-aware step
    returns and differentiates (C8's rule, the mean over the data
    ranks). ``model`` ranks hold the same tokens and add nothing.
    Without a mesh, or with R = 1, the local form."""
    n_experts = probs.shape[-1]
    flat = probs.reshape(-1, n_experts)
    chosen = _topk_mask(flat, top_k).to(torch.float32)
    f = chosen.mean(dim=0)
    if mesh is not None:
        from sparkdl_tpu_torch.parallel.train import _data_axes

        axes, n = _data_axes(mesh)
        if axes:
            f = f.detach()
            for axis in axes:
                f = mesh.all_reduce(f, axis)
            f = f / n
    p = flat.mean(dim=0)
    return n_experts * torch.sum(f * p)


def _router_probs(tree, under=False):
    """Every array under a ``router_probs`` key of a nested tree of
    dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        out = []
        for key, value in tree.items():
            out += _router_probs(value, under or key == "router_probs")
        return out
    if isinstance(tree, (tuple, list)):
        return [p for value in tree for p in _router_probs(value, under)]
    return [tree] if under else []


def moe_aux_loss(intermediates, top_k, *, mesh=None):
    """Sum :func:`load_balance_loss` over every recorded
    ``router_probs`` in an intermediates tree (one per MoE layer:
    ``Llama.forward(..., return_intermediates=True)``). Raises if none
    are present: a silent 0.0 would let the router train without
    balancing.

    ``mesh``: the model's mesh, as :func:`load_balance_loss` takes it.
    On data-like axes > 1 a rank's value is its share (the global
    ``f`` against its own ``P``), not the global aux; the mean over the
    ranks, which the mesh-aware step returns and differentiates, is
    JAX's aux over the global batch."""
    losses = [load_balance_loss(p, top_k, mesh=mesh)
              for p in _router_probs(intermediates)]
    if not losses:
        raise ValueError(
            "no router_probs found in intermediates — pass the tree from "
            "forward(..., return_intermediates=True) on an MoE model")
    return torch.stack(losses).sum()


def moe_apply(x, gates, w_gate, w_up, w_down, axis=None):
    """Gate-weighted expert combine: every expert of the stacked weights
    computes every token of ``x`` (..., d), and ``gates`` (..., E_here)
    weight the sum. With ``axis=(mesh, axis_name)`` the weights hold
    only this rank's experts and the partial outputs are summed over
    the axis."""
    dt = torch.promote_types(x.dtype, w_gate.dtype)
    x = x.to(dt)
    h_gate = torch.einsum("...d,edf->e...f", x, w_gate.to(dt))
    h_up = torch.einsum("...d,edf->e...f", x, w_up.to(dt))
    h = F.silu(h_gate) * h_up
    out_e = torch.einsum("e...f,efd->e...d", h, w_down.to(dt))
    combined = torch.einsum("e...d,...e->...d", out_e, gates.to(dt))
    if axis is not None:
        combined = axis_sum(combined, *axis)
    return combined


def _expert_axis_size(mesh, cfg, axis_name):
    """Shard count on ``axis_name`` + the divisibility guard shared by
    both expert-parallel execution models."""
    n_shards = dict(mesh.shape)[axis_name]
    if cfg.n_experts % n_shards:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by the "
            f"{axis_name} axis ({n_shards})")
    return n_shards


def _local_router(params, e_local, axis):
    """The replicated router's (kernel, bias), each entering through
    :func:`~sparkdl_tpu_torch.parallel.mesh.replicated`; checks that
    ``params`` holds ``e_local`` experts."""
    got = params["w_gate"].shape[0]
    if got != e_local:
        raise ValueError(f"params hold {got} experts; this rank's share "
                         f"is {e_local} (pass the local experts)")
    return (replicated(params["router"]["kernel"], *axis),
            replicated(params["router"]["bias"], *axis))


def expert_parallel_moe(mesh, cfg, *, axis_name="expert"):
    """Bind a psum-combine expert-parallel MoE forward to ``mesh``:
    returns ``f(params, x)`` on this rank's shard, every rank of the
    axis calling it with the same ``x`` (replicated tokens).

    params: {"router": {"kernel", "bias"}, "w_gate", "w_up", "w_down"}
    (the tree :class:`MoEMLP` holds), the router whole and the experts
    this rank's E/n (rank i holds experts [i*E/n, (i+1)*E/n)). Returns
    the whole output on every rank.
    """
    n_shards = _expert_axis_size(mesh, cfg, axis_name)
    e_local = cfg.n_experts // n_shards
    axis = (mesh, axis_name)

    def f(params, x):
        shard = mesh.axis_index(axis_name)
        kernel, bias = _local_router(params, e_local, axis)
        x = replicated(x, *axis)
        logits = x.to(torch.float32) @ kernel + bias
        gates = moe_gates(logits, cfg.top_k).to(x.dtype)
        # local expert slice of the gates
        g_local = gates[..., shard * e_local:(shard + 1) * e_local]
        return moe_apply(x, g_local, params["w_gate"], params["w_up"],
                         params["w_down"], axis=axis)

    return f


def expert_parallel_moe_a2a(mesh, cfg, *, axis_name="expert",
                            capacity_factor=1.25):
    """Dispatch-based expert parallelism: tokens travel by all-to-all to
    the rank holding their expert (Switch/Mixtral execution model), so
    expert FLOPs scale with CAPACITY, not with n_experts x all tokens as
    in :func:`expert_parallel_moe`.

    Per rank: route the local tokens, pack each expert's selections
    into a fixed CAPACITY buffer (``C = max(1, ceil(T_local * top_k / E
    * capacity_factor))``, slots in token order; overflowing pairs are
    DROPPED for that expert, their gate contribution zero), all-to-all
    the (E, C, d) buffers so each rank receives its own experts' tokens
    from every rank, run the expert SwiGLU on exactly those tokens,
    all-to-all back, and gate-combine.

    Returns ``f(params, x)`` on this rank's shard: ``x`` (..., d) this
    rank's tokens, ``params`` the router whole and this rank's E/n
    experts (:func:`expert_parallel_moe`'s tree); the output is this
    rank's tokens'.
    """
    n_shards = _expert_axis_size(mesh, cfg, axis_name)
    e_local = cfg.n_experts // n_shards
    axis = (mesh, axis_name)

    def f(params, x):
        d = x.shape[-1]
        lead = x.shape[:-1]
        xt = x.reshape(-1, d)                        # (T_local, d)
        T = xt.shape[0]
        E = cfg.n_experts
        # static per-expert buffer size: the all-to-all and the expert
        # products have fixed shapes wherever the router sends load
        C = max(1, int(math.ceil(T * cfg.top_k / E * capacity_factor)))
        kernel, bias = _local_router(params, e_local, axis)
        logits = xt.to(torch.float32) @ kernel + bias
        gates = moe_gates(logits, cfg.top_k)            # (T, E) f32
        sel = (gates > 0).to(torch.int32)
        # per-expert slot index of each selected token, in token order
        pos = torch.cumsum(sel, dim=0) - 1              # (T, E)
        keep = (sel == 1) & (pos < C)
        # dispatch tensor (T, E, C): one-hot slot per kept pair
        slots = torch.arange(C, device=xt.device)
        disp = ((pos[..., None] == slots) & keep[..., None]).to(xt.dtype)
        buf = torch.einsum("tec,td->ecd", disp, xt)     # (E, C, d)
        # exchange: rank s sends experts [s*e_local, (s+1)*e_local) of
        # every other rank's buffer and receives its own experts'
        # buffers from all ranks (split/concat on the expert dim)
        recv = mesh.all_to_all(buf, axis_name)          # (E, C, d) =
        # (n_shards * e_local, C, d) grouped [rank 0's e_local, ...]
        tok_e = (recv.reshape(n_shards, e_local, C, d).transpose(0, 1)
                 .reshape(e_local, n_shards * C, d))
        h = torch.einsum("ecd,edf->ecf", tok_e, params["w_gate"])
        u = torch.einsum("ecd,edf->ecf", tok_e, params["w_up"])
        out_e = torch.einsum("ecf,efd->ecd", F.silu(h) * u,
                             params["w_down"])          # (e_local, SC, d)
        back = (out_e.reshape(e_local, n_shards, C, d).transpose(0, 1)
                .reshape(E, C, d))
        out_buf = mesh.all_to_all(back, axis_name)      # (E, C, d) home
        combine = disp * gates.to(xt.dtype)[..., None]
        y = torch.einsum("tec,ecd->td", combine, out_buf)
        return y.reshape(*lead, d)

    return f
