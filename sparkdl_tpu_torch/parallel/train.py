"""The train step, the language-model losses and their helpers, and the
data-parallel pieces of a HorovodRunner gang.

Counterpart of ``sparkdl_tpu/parallel/train.py`` (``make_train_step``,
the two cross entropies, ``make_lm_loss_fn``, ``global_batch``,
``param_count``, ``shard_batch``, ``replicate``). The JAX step is a pure
function of (params, opt_state, batch); here the model and the optimizer
hold the state and ``step(batch)`` updates them in place. Data
parallelism is a gang's: :func:`shard_batch` gives each rank its rows of
the global batch, :func:`replicate` copies the root's weights to every
rank, and ``hvd.DistributedOptimizer`` averages the gradients at each
step (the JAX package's mesh sharding and ``psum`` over the data axis).
Sequence parallelism is a gang's too: :func:`shard_batch` with a mesh
and ``seq_axis=True`` gives each rank its columns and their global
positions, and the model attends across ranks through ring attention
(``Llama(attention_fn=make_ring_attention(mesh))``). Tensor
parallelism and ZeRO-3 are the model's (``Llama(cfg, mesh=mesh)``,
Megatron's f and g and the ``fsdp`` gathers done explicitly through the
differentiable collectives of :mod:`~sparkdl_tpu_torch.parallel.mesh`):
:func:`make_train_step` reads the model's mesh, averages the gradients
and the loss over its data-like axes (``data``, ``fsdp``, ``seq``) and
never over ``model``, whose ranks hold different shards, and
:func:`fused_cross_entropy` takes the head's vocabulary shard (the
vocabulary-parallel loss). :func:`instrument_step` wraps a step in the
gang telemetry of :mod:`sparkdl_tpu_torch.observe`; ``lower_train_step``
(an XLA lowering) has no counterpart here: the step's cost for the MFU
gauge is the caller's count, given to
:func:`~sparkdl_tpu_torch.observe.perf.register_step_cost`.

Usage (LoRA fine-tune)::

    model = Llama(LlamaConfig.llama3_8b(attention="flash", lora_rank=16))
    init_weights(model, generator)           # or load_jax_params
    mask = lora_mask(model)
    opt = torch.optim.AdamW(
        [p for n, p in model.named_parameters() if mask[n]], lr=1e-4,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask)
    metrics = step(global_batch(np.random.default_rng(0), vocab, 2, 2048))

``weight_decay=1e-4`` is ``optax.adamw``'s default (torch's is 1e-2);
the update is otherwise the same formula. Data-parallel, inside a
HorovodRunner ``main`` (every rank runs it)::

    hvd.init()
    replicate(model)                          # rank 0's weights
    opt = hvd.DistributedOptimizer(opt)       # before make_train_step
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask)
    metrics = step(shard_batch(global_batch(rng, vocab, 8, 2048)))

Sequence-parallel, one sequence of 8192 tokens over two ranks::

    mesh = make_mesh(MeshSpec(seq=2))         # after hvd.init()
    model = Llama(cfg, attention_fn=make_ring_attention(mesh))
    ...                                       # replicate, the optimizer
    step = make_train_step(make_lm_loss_fn(model, loss="fused"), opt,
                           param_mask=mask)
    batch = shard_batch(global_batch(rng, vocab, 1, 8192), mesh,
                        seq_axis=True)        # 4096 tokens and positions
    metrics = step(batch)

Tensor-parallel, dp x sp x tp as the JAX package's ``('data','seq',
'model')`` mesh, every rank building the model from the same whole
state dict (each keeps its slice)::

    mesh = make_mesh(MeshSpec(data=2, seq=2, model=2))
    model = Llama.from_params(cfg, params, mesh=mesh,
                              attention_fn=make_ring_attention(mesh))
    opt = torch.optim.AdamW(...)              # no DistributedOptimizer
    step = make_train_step(make_lm_loss_fn(model, loss="fused"), opt,
                           param_mask=lora_mask(model))
    metrics = step(shard_batch(batch, mesh, seq_axis=True))

ZeRO-3, with or without ``model``: the same, on a mesh with ``fsdp > 1``
(``MeshSpec(fsdp=2)``, ``MeshSpec(data=2, fsdp=2)``); ``shard_batch``
gives each rank its rows of ``data`` x ``fsdp``.

``sharding.full_host_value`` gathers a split leaf whole, and
``TrainCheckpointer.save(..., specs=model.tp_specs, mesh=mesh)`` writes
the whole tree with its sharding sidecar, which
``restore(target_mesh=...)`` re-lays onto another mesh.
"""

import functools
import time

import numpy as np
import torch
import torch.utils.checkpoint

from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel.mesh import gathered, replicated
from sparkdl_tpu_torch.parallel.sharding import MODEL

# the mesh axes whose ranks see different rows or columns of the batch:
# a mesh-aware step averages its loss and gradients over them
DATA_AXES = ("data", "fsdp", "seq")


def make_train_step(loss_fn, optimizer, *, grad_accum=1, remat=False,
                    param_mask=None, device=None):
    """Build ``step(batch) -> {"loss": tensor}``, which computes the
    loss and its gradients and takes one optimizer step in place.

    :param loss_fn: ``f(batch) -> scalar loss`` over a model it closes
        on (:func:`make_lm_loss_fn`), with that model as ``loss_fn.model``
        when ``param_mask`` is given.
    :param optimizer: a ``torch.optim`` optimizer over the trained
        parameters.
    :param grad_accum: microbatch count; the batch's leading axis is
        split and the microbatch gradients averaged (activations live
        one microbatch at a time). The loss is the microbatches' mean.
    :param remat: recompute the whole loss in the backward
        (``torch.utils.checkpoint``), as the reference checkpoints its
        whole loss function (``jax.checkpoint(loss_fn)``). It saves no
        peak memory: the backward recomputes the forward of every layer
        at once and holds all of its activations again, so a step peaks
        where it would without it. The model's ``cfg.remat``, which
        checkpoints each block, is what saves memory (``chip_smoke.py``
        phase 6b on one H100, depth 2, batch 2 x 2048: 7.62 GB above the
        model with or without this flag, 6.44 GB with ``cfg.remat``).
    :param param_mask: ``{parameter name: bool}`` (:func:`lora_mask`);
        it sets ``requires_grad``, so a frozen weight gets no gradient,
        its dW product is never computed, and the optimizer (which skips
        parameters without a gradient) never changes it, decay included.
        Activation gradients still flow through frozen weights.
    :param device: where each batch goes (CUDA unless named; raises
        without it). Must be the model's device.

    A tensor-parallel or ZeRO-3 model (``loss_fn.model.mesh``, a
    ``Llama`` built with a mesh whose ``model`` or ``fsdp`` axis is > 1)
    makes the step mesh-aware: after the backward it averages every
    gradient over the mesh's data-like axes (``data``, ``fsdp``,
    ``seq``; one fused all-reduce per axis and kind), never over
    ``model``, whose ranks hold different shards. A leaf split over
    ``fsdp`` arrives summed over ``fsdp`` already (its gather's backward
    reduce-scatters), so it is all-reduced over ``data`` and ``seq``
    only; every gradient is then divided by ``data x fsdp x seq``. The
    returned loss is likewise the mean over those axes: the global
    batch's loss on every rank. That is the global batch's mean when
    each rank's loss is the mean over equally many tokens
    (:func:`make_lm_loss_fn`), or when a loss that ignores labels takes
    the model's mesh (:func:`cross_entropy_loss` and
    :func:`fused_cross_entropy` with ``ignore_index`` and
    ``mesh=model.mesh``); a user loss that ignores labels and takes no
    mesh gives the mean of the ranks' means. Wrapping its
    optimizer in ``hvd.DistributedOptimizer`` (a mean over the whole
    world) raises ValueError.
    """
    device = resolve_device(device)
    model = getattr(loss_fn, "model", None)
    mesh = getattr(model, "mesh", None)
    if mesh is not None and hasattr(optimizer, "_hvd_op"):
        raise ValueError(
            "hvd.DistributedOptimizer averages every gradient over the "
            "whole gang, which under tensor parallelism or ZeRO-3 mixes "
            "shards of different ranks (rank 0's lora_b columns with "
            "rank 1's); pass the plain optimizer: the step averages over "
            "the mesh's data-like axes itself")
    if model is not None:
        model_device = next(model.parameters()).device
        if model_device.type != device.type:
            raise ValueError(f"the model is on {model_device}, the step "
                             f"would feed it batches on {device}")
    if param_mask is not None:
        if model is None:
            raise ValueError("param_mask needs the model: pass a loss_fn "
                             "with a .model (make_lm_loss_fn sets it)")
        params = dict(model.named_parameters())
        if set(param_mask) != set(params):
            raise ValueError(
                "param_mask does not match the model's parameters: "
                f"missing {sorted(set(params) - set(param_mask))}, "
                f"unexpected {sorted(set(param_mask) - set(params))}")
        for name, p in params.items():
            p.requires_grad_(bool(param_mask[name]))
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_of(batch):
        if remat:
            return torch.utils.checkpoint.checkpoint(loss_fn, batch,
                                                     use_reentrant=False)
        return loss_fn(batch)

    def step(batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = loss_of(batch)
            loss.backward()
            total = loss.detach()
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"{grad_accum} microbatches")
            size = n // grad_accum
            total = 0.0
            for i in range(grad_accum):
                micro = {k: v[i * size:(i + 1) * size]
                         for k, v in batch.items()}
                loss = loss_of(micro)
                (loss / grad_accum).backward()
                total = total + loss.detach()
            total = total / grad_accum
        if mesh is not None:
            _average_grads(optimizer, mesh, _fsdp_split(model))
            total = _data_mean(total, mesh)
        optimizer.step()
        return {"loss": total}

    return step


def _wait_for_device(out):
    """Block until the work that produced ``out``'s CUDA tensors (a
    step's returned loss) is done on their cards."""
    tensors = (out.values() if isinstance(out, dict)
               else out if isinstance(out, (list, tuple)) else (out,))
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def instrument_step(step_fn, name="train_step"):
    """``step_fn`` with gang telemetry (the JAX function's): at each call
    the hang detector's progress mark (``health.note_step``, at entry),
    ``mem.oom_guard``, a ``cat="train"`` span with the call's ``step``
    and ``phase`` (``"compile"`` for the first call, ``"execute"``
    after), the ``<name>_seconds`` histogram and ``<name>_total`` counter
    by phase, the ``<name>_per_second`` gauge over the execute calls,
    and ``perf.note_step`` (achieved FLOP/s, MFU and the bandwidth
    gauges, against the cost given to ``perf.register_step_cost``).

    A step returns its loss before the card has run its kernels: with
    telemetry on, the span ends only once the card has finished the
    returned tensors' work (a synchronize of their cards), so the
    attribution and the MFU time the step, not its launch. With
    telemetry off, one test of the switch, then ``step_fn``."""
    from sparkdl_tpu_torch import observe

    state = {"calls": 0, "first_exec_t0": None}

    @functools.wraps(step_fn)
    def stepped(*args, **kwargs):
        if not observe.enabled():
            return step_fn(*args, **kwargs)
        from sparkdl_tpu_torch.observe import health, mem, perf

        health.note_step(state["calls"])
        phase = "compile" if state["calls"] == 0 else "execute"
        t0 = time.perf_counter()
        with mem.oom_guard(phase="step"), \
                observe.span(name, cat="train", step=state["calls"],
                             phase=phase):
            out = step_fn(*args, **kwargs)
            _wait_for_device(out)
        dt = time.perf_counter() - t0
        state["calls"] += 1
        observe.observe_value(f"{name}_seconds", dt, phase=phase)
        observe.inc(f"{name}_total", phase=phase)
        if phase == "execute":
            perf.note_step(name, dt)
            if state["first_exec_t0"] is None:
                state["first_exec_t0"] = t0
            elapsed = time.perf_counter() - state["first_exec_t0"]
            if elapsed > 0:
                observe.set_gauge(f"{name}_per_second",
                                  (state["calls"] - 1) / elapsed)
        return out

    return stepped


def _data_axes(mesh):
    """The data-like axes of ``mesh`` of size > 1 and their product."""
    axes = [a for a in DATA_AXES if mesh.axis_size(a) > 1]
    return axes, int(np.prod([mesh.axis_size(a) for a in axes]))


def _data_mean(x, mesh):
    """The mean of the detached scalar ``x`` over the data-like axes."""
    axes, n = _data_axes(mesh)
    if not axes:
        return x
    x = x.detach().reshape(1)
    for axis in axes:
        x = mesh.all_reduce(x, axis)
    return x[0] / n


def _fsdp_split(model):
    """The ids of ``model``'s parameters split over ``fsdp``."""
    zero3 = getattr(model, "zero3", None)
    if zero3 is None:
        return frozenset()
    return frozenset(id(owner._parameters[leaf])
                     for entries in zero3.units.values()
                     for owner, leaf, _ in entries)


def _average_grads(optimizer, mesh, fsdp_split=frozenset()):
    """Average the optimizer's gradients in place over the data-like
    axes of ``mesh`` of size > 1: one flat buffer per (dtype, device,
    split over ``fsdp`` or not), all-reduced over each axis in turn
    (a parameter of ``fsdp_split``, whose gradient the reduce-scatter
    summed over ``fsdp``, skips that axis), then divided by their
    product. Every rank holds the same parameters with gradients, in
    the same order."""
    axes, n = _data_axes(mesh)
    if not axes:
        return
    by_kind = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                by_kind.setdefault((p.grad.dtype, p.grad.device,
                                    id(p) in fsdp_split), []).append(p)
    with torch.no_grad():
        for (_, _, split), params in by_kind.items():
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            for axis in axes:
                if not (split and axis == "fsdp"):
                    flat = mesh.all_reduce(flat, axis)
            flat /= n
            offset = 0
            for p in params:
                size = p.grad.numel()
                p.grad.copy_(flat[offset:offset + size].view_as(p.grad))
                offset += size


def _kept_divisor(keep, mesh):
    """What a loss with ``ignore_index`` divides its summed NLL by: the
    kept count, or, on a mesh whose data-like axes (size > 1, product
    R) split the batch, the whole batch's kept count over R (one scalar
    all-reduce, no gradient), so that the step's mean over the ranks is
    the whole batch's mean however unequally the ranks keep."""
    if mesh is not None:
        axes, n = _data_axes(mesh)
        if axes:
            count = keep.sum().to(torch.float32).reshape(1)
            for axis in axes:
                count = mesh.all_reduce(count, axis)
            return count[0].clamp_min(1) / n
    return keep.sum().clamp_min(1)


def cross_entropy_loss(logits, labels, *, ignore_index=None, mesh=None):
    """Token-level softmax cross entropy with fp32 accumulation: the mean
    negative log-likelihood of ``labels`` (B, S) under ``logits``
    (B, S, V), over the tokens whose label is not ``ignore_index``.

    ``mesh``: the model's mesh. With ``ignore_index`` and data-like axes
    (``data``, ``fsdp``, ``seq``) > 1, this rank's summed NLL times their
    rank count over the whole batch's kept count, whose mean over the
    ranks (the step's) is the whole batch's loss."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    if ignore_index is None:
        return -logp.gather(-1, labels[..., None])[..., 0].mean()
    keep = labels != ignore_index
    nll = -logp.gather(-1, labels.masked_fill(~keep, 0)[..., None])[..., 0]
    return (nll * keep).sum() / _kept_divisor(keep, mesh)


def _chunk_lse_gold(h, w, labels, lo, matmul_dtype):
    """One chunk's logsumexp over the vocabulary block ``w`` holds,
    whose first column is token ``lo``, and the gold logit of each label
    that falls in the block (0 for the others)."""
    if matmul_dtype is not None:
        h, w = h.to(matmul_dtype), w.to(matmul_dtype)
    # operands rounded to matmul_dtype, products summed in fp32 (the JAX
    # package's preferred_element_type=float32)
    logits = h.float() @ w.float()
    local = labels - lo
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])
    return (torch.logsumexp(logits, dim=-1),
            torch.where(mine, gold[..., 0], 0.0))


def fused_cross_entropy(hidden, w_head, labels, *, chunk_size=256,
                        ignore_index=None, matmul_dtype=None,
                        freeze_head=False, mesh=None):
    """Chunked linear + softmax cross entropy: ``CE(hidden @ w_head,
    labels)`` without the (B, S, V) logits of the whole sequence.

    The sequence is cut in slices of ``chunk_size`` tokens (the last may
    be shorter); each slice's logits are recomputed in the backward
    (``torch.utils.checkpoint``) instead of being kept.

    Vocabulary-parallel with ``mesh`` whose ``model`` axis is > 1
    (Megatron's split head): ``w_head`` is this rank's (D, V/m) block of
    columns, at coordinate ``mesh.axis_index("model")``, and ``hidden``
    is whole on every rank of the axis. Each rank computes its chunk logits on its
    columns only; the per-row logsumexps and the gold logit (from the
    rank whose block holds the label, 0 from the others) travel in one
    differentiable all-gather a chunk and are merged on every rank, so
    every rank returns the whole loss. ``hidden`` enters through f: its
    gradient sums every rank's share (one all-reduce in the backward).

    :param hidden: (B, S, D) final hidden states.
    :param w_head: (D, V) unembedding.
    :param labels: (B, S) int targets.
    :param ignore_index: label value left out of the mean; with
        ``mesh``, the mean of the whole batch as :func:`cross_entropy_loss`
        takes it.
    :param matmul_dtype: round both matmul operands to this dtype first
        (fp32 accumulation either way).
    :param freeze_head: no gradient to ``w_head`` (LoRA's frozen head).
    """
    s = hidden.shape[1]
    chunk = min(chunk_size, s)
    labels = labels.long()
    keep = (torch.ones_like(labels, dtype=torch.bool) if ignore_index is None
            else labels != ignore_index)
    labels = labels.masked_fill(~keep, 0)
    if freeze_head:
        w_head = w_head.detach()
    split = mesh is not None and mesh.axis_size(MODEL) > 1
    lo = 0
    if split:
        hidden = replicated(hidden, mesh, MODEL)
        lo = mesh.axis_index(MODEL) * w_head.shape[-1]
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        lse, gold = torch.utils.checkpoint.checkpoint(
            _chunk_lse_gold, hidden[:, sl], w_head, labels[:, sl], lo,
            matmul_dtype, use_reentrant=False)
        if split:
            # (..., 2m): every rank's (logsumexp, gold) pair
            both = gathered(torch.stack([lse, gold], dim=-1), mesh, MODEL)
            both = both.unflatten(-1, (-1, 2))
            lse, gold = (torch.logsumexp(both[..., 0], dim=-1),
                         both[..., 1].sum(dim=-1))
        nll = lse - gold
        loss_sum = loss_sum + (nll * keep[:, sl]).sum()
    if ignore_index is None:
        return loss_sum / keep.numel()
    return loss_sum / _kept_divisor(keep, mesh)


def global_batch(rng, vocab, batch, seq):
    """Synthetic LM batch (benchmarks and smoke runs): numpy int32
    ``inputs`` and ``targets`` (batch, seq), the targets shifted by one."""
    tokens = np.asarray(rng.integers(0, vocab, size=(batch, seq + 1)),
                        np.int32)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def make_lm_loss_fn(model, *, loss="logits", chunk=512, ce_bf16=False):
    """The language-model loss ``f(batch) -> scalar`` over ``model``,
    with ``f.model = model`` (what :func:`make_train_step` masks).

    ``loss="logits"``: the fp32 logits and :func:`cross_entropy_loss`.
    ``loss="fused"``: the hidden states into :func:`fused_cross_entropy`
    (chunks of ``chunk`` tokens, frozen head, the unembedding operands
    rounded to bf16 with ``ce_bf16``): the (B, S, V) logits never exist
    whole.

    The logits path takes the model's mesh (``model.mesh``). A
    tensor-parallel model whose head is split over the vocabulary takes
    the vocabulary-parallel fused loss (``mesh=model.mesh``); its logits
    path gathers the head's shards through the differentiable
    all-gather. A ZeRO-3 head comes whole over ``fsdp``
    (``model.head_kernel()``). Neither path ignores labels, so the
    mean over the ranks is the global batch's mean (C8 needs no count).
    """
    if loss not in ("logits", "fused"):
        raise ValueError(f"unknown loss path {loss!r}")

    def loss_fn(batch):
        device = next(model.parameters()).device
        inputs = torch.as_tensor(batch["inputs"], device=device)
        targets = torch.as_tensor(batch["targets"], device=device)
        # a sequence shard's global positions (shard_batch(seq_axis=True))
        positions = batch.get("positions")
        mesh = getattr(model, "mesh", None)
        if loss == "fused":
            hidden = model(inputs, positions, return_hidden=True)
            split = (getattr(model, "tp", None) is not None
                     and model.lm_head.tp_role == "col")
            return fused_cross_entropy(
                hidden, model.head_kernel(), targets, chunk_size=chunk,
                freeze_head=True,
                matmul_dtype=torch.bfloat16 if ce_bf16 else None,
                mesh=mesh if split else None)
        return cross_entropy_loss(model(inputs, positions), targets,
                                  mesh=mesh)

    loss_fn.model = model
    return loss_fn


def shard_batch(batch, mesh=None, *, seq_axis=False, rank=None,
                size=None):
    """This rank's block of a host global batch.

    Without ``mesh``: the ``rank``-th of ``size`` contiguous, equal
    slices of every array's leading axis (``hvd.rank()`` and
    ``hvd.size()`` by default). With ``mesh`` (the JAX package's
    ``shard_batch(batch, mesh, seq_axis=...)``): the rows of this rank's
    coordinate on ``data`` x ``fsdp`` (ranks that differ only on ``seq``
    or ``model`` get the same rows); with ``seq_axis=True`` also the
    ``seq`` coordinate's contiguous slice of the second axis of every
    array that has one, and ``positions``, those columns' global
    positions (rows, S_local) int64, which the model needs for RoPE and
    ring attention for its causal mask. Raises ValueError when an axis
    does not split evenly.

    Why the gang's averaged gradient (``hvd.DistributedOptimizer``, a
    mean over every rank) is the gradient of the global batch's mean
    loss: the blocks are equal, so that loss is the mean of the ranks'
    losses, each the mean over its own tokens, and its gradient is the
    mean of the gradients of the ranks' losses. Each rank's gradient
    holds every path through its own activations: under ring attention
    a rank's loss also depends on the other ranks' keys and values, and
    the ring's backward carries those shares to the rank that holds
    them before its weights' gradients are formed."""
    if mesh is None:
        if seq_axis:
            raise ValueError("seq_axis=True needs the mesh")
        if rank is None or size is None:
            from sparkdl_tpu_torch import hvd

            rank = hvd.rank() if rank is None else rank
            size = hvd.size() if size is None else size
    else:
        if rank is not None or size is not None:
            raise ValueError("pass mesh or rank and size, not both")
        rank = (mesh.axis_index("data") * mesh.axis_size("fsdp")
                + mesh.axis_index("fsdp"))
        size = mesh.axis_size("data") * mesh.axis_size("fsdp")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a gang of {size}")
    rows = {k: v.shape[0] for k, v in batch.items()}
    n = next(iter(rows.values()))
    if any(r != n for r in rows.values()) or n % size:
        raise ValueError(f"a batch of {rows} rows does not split evenly "
                         f"over {size} ranks")
    per = n // size
    out = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    if not seq_axis:
        return out
    n_seq, idx = mesh.axis_size("seq"), mesh.axis_index("seq")
    cols = {v.shape[1] for v in out.values() if v.ndim >= 2}
    if len(cols) != 1 or next(iter(cols)) % n_seq:
        raise ValueError(f"sequence lengths {sorted(cols)} do not split "
                         f"evenly over seq={n_seq}")
    s_local = next(iter(cols)) // n_seq
    cut = slice(idx * s_local, (idx + 1) * s_local)
    out = {k: v[:, cut] if v.ndim >= 2 else v for k, v in out.items()}
    out["positions"] = np.broadcast_to(
        np.arange(idx * s_local, (idx + 1) * s_local, dtype=np.int64),
        (per, s_local)).copy()
    return out


def replicate(module, root_rank=0):
    """Copy ``root_rank``'s parameters and buffers into ``module`` on
    every rank of the gang, in place (``hvd.broadcast_parameters`` over
    its state dict); returns ``module``."""
    from sparkdl_tpu_torch import hvd

    hvd.broadcast_parameters(module.state_dict(), root_rank=root_rank)
    return module


def param_count(params):
    """Number of values in a module's parameters or a state dict."""
    tensors = (params.parameters() if isinstance(params, torch.nn.Module)
               else params.values())
    return sum(int(t.numel()) for t in tensors)
