"""The single-card train step, the language-model losses and their
helpers.

Counterpart of ``sparkdl_tpu/parallel/train.py`` (``make_train_step``,
the two cross entropies, ``make_lm_loss_fn``, ``global_batch``,
``param_count``). The JAX step is a pure function of (params,
opt_state, batch); here the model and the optimizer hold the state and
``step(batch)`` updates them in place. Sharding, the mesh, HorovodRunner
gangs and the telemetry wrappers are not ported yet.

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
the update is otherwise the same formula.
"""

import numpy as np
import torch
import torch.utils.checkpoint

from sparkdl_tpu_torch.ops._dispatch import resolve_device


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
        (``torch.utils.checkpoint``) instead of keeping its activations.
    :param param_mask: ``{parameter name: bool}`` (:func:`lora_mask`);
        it sets ``requires_grad``, so a frozen weight gets no gradient,
        its dW product is never computed, and the optimizer (which skips
        parameters without a gradient) never changes it, decay included.
        Activation gradients still flow through frozen weights.
    :param device: where each batch goes (CUDA unless named; raises
        without it). Must be the model's device.
    """
    device = resolve_device(device)
    model = getattr(loss_fn, "model", None)
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
        optimizer.step()
        return {"loss": total}

    return step


def cross_entropy_loss(logits, labels, *, ignore_index=None):
    """Token-level softmax cross entropy with fp32 accumulation: the mean
    negative log-likelihood of ``labels`` (B, S) under ``logits``
    (B, S, V), over the tokens whose label is not ``ignore_index``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    if ignore_index is None:
        return -logp.gather(-1, labels[..., None])[..., 0].mean()
    keep = labels != ignore_index
    nll = -logp.gather(-1, labels.masked_fill(~keep, 0)[..., None])[..., 0]
    return (nll * keep).sum() / keep.sum().clamp_min(1)


def _chunk_nll(h, w, labels, matmul_dtype):
    if matmul_dtype is not None:
        h, w = h.to(matmul_dtype), w.to(matmul_dtype)
    # operands rounded to matmul_dtype, products summed in fp32 (the JAX
    # package's preferred_element_type=float32)
    logits = h.float() @ w.float()
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def fused_cross_entropy(hidden, w_head, labels, *, chunk_size=256,
                        ignore_index=None, matmul_dtype=None,
                        freeze_head=False):
    """Chunked linear + softmax cross entropy: ``CE(hidden @ w_head,
    labels)`` without the (B, S, V) logits of the whole sequence.

    The sequence is cut in slices of ``chunk_size`` tokens (the last may
    be shorter); each slice's logits are recomputed in the backward
    (``torch.utils.checkpoint``) instead of being kept.

    :param hidden: (B, S, D) final hidden states.
    :param w_head: (D, V) unembedding.
    :param labels: (B, S) int targets.
    :param ignore_index: label value left out of the mean.
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
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        nll = torch.utils.checkpoint.checkpoint(
            _chunk_nll, hidden[:, sl], w_head, labels[:, sl], matmul_dtype,
            use_reentrant=False)
        loss_sum = loss_sum + (nll * keep[:, sl]).sum()
    return loss_sum / keep.sum().clamp_min(1)


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
    """
    if loss not in ("logits", "fused"):
        raise ValueError(f"unknown loss path {loss!r}")

    def loss_fn(batch):
        device = next(model.parameters()).device
        inputs = torch.as_tensor(batch["inputs"], device=device)
        targets = torch.as_tensor(batch["targets"], device=device)
        if loss == "fused":
            hidden = model(inputs, return_hidden=True)
            return fused_cross_entropy(
                hidden, model.lm_head.kernel, targets, chunk_size=chunk,
                freeze_head=True,
                matmul_dtype=torch.bfloat16 if ce_bf16 else None)
        return cross_entropy_loss(model(inputs), targets)

    loss_fn.model = model
    return loss_fn


def param_count(params):
    """Number of values in a module's parameters or a state dict."""
    tensors = (params.parameters() if isinstance(params, torch.nn.Module)
               else params.values())
    return sum(int(t.numel()) for t in tensors)
