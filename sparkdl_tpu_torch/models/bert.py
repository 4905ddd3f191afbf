"""BERT encoder (BASELINE.json config 3: BERT-base SQuAD fine-tune):
bidirectional, learned positions, post-LN blocks, a GELU MLP, and the
question-answering and classification heads.

Counterpart of ``sparkdl_tpu/models/bert.py``, under its module names
(``embed``, ``pos_embed``, ``type_embed``, ``embed_norm``, ``attn`` with
``q_proj`` ... ``o_proj``, ``attn_norm``, ``fc1``, ``fc2``, ``mlp_norm``,
``qa_head``, ``pooler``, ``classifier``; block ``layer_<i>`` is
``layers.<i>``, as in the port's Llama). Dense kernels keep flax's
(in, out) layout.

- every Dense computes in ``cfg.dtype`` (bf16), casting its input; the
  LayerNorms are fp32, so the residual stream is fp32 (``x + a`` is
  fp32 + bf16);
- the embeddings are looked up in ``cfg.dtype`` and summed before the
  fp32 ``embed_norm``;
- attention without a mask is the port's plain
  :func:`~sparkdl_tpu_torch.parallel.ring_attention.attention_reference`
  (not causal); with a padding mask (B, S), true on kept keys, masked
  keys get a -1e30 bias: input-dtype products accumulated in fp32, an
  fp32 softmax. JAX computes it outside any kernel, and so does the
  port: it is not routed to the flash kernels;
- the GELU is jax's tanh approximation (``nn.gelu``'s default);
- the heads are fp32 on the fp32 hidden states.

A difference kept on purpose: the port always holds ``type_embed``
(flax creates it only when ``init`` is given ``token_type_ids``); a
forward without ``token_type_ids`` does not use it, as in JAX.

On a mesh (``mesh=``, ``rules=``, default ``TRANSFORMER_RULES``: the
JAX package's GSPMD sharding of the same names), the model lays its
weights out through :mod:`~sparkdl_tpu_torch.models.megatron`, as the
Llama does, and every rank of a gang builds it alike:

- ``model > 1``: ``q_proj``, ``k_proj``, ``v_proj`` and ``fc1`` are
  column-parallel (Q, K and V behind one f), ``o_proj`` and ``fc2``
  row-parallel (g after each); a rank computes its ``n_heads / model``
  heads, with the padding mask or without; each projection's bias is
  whole, its block added by a column-parallel projection and the whole
  once after g by a row-parallel one. The three embedding tables split
  d_model: the split lookups are summed, then gathered once before the
  fp32 ``embed_norm``, which needs the whole row. The LayerNorms,
  ``pooler``, ``qa_head`` and ``classifier`` stay whole (role ``rep``).
  Heads that do not divide over ``model`` raise NotImplementedError
  (GSPMD reshards a head across ranks; the port does not).
- ``fsdp > 1``: ZeRO-3, each block's kernels gathered whole before the
  block runs and again in its backward (the unit is the block under
  the head model's ``bert.`` prefix too); the embeddings have no
  ``fsdp`` entry and stay whole.

A head model holds the layout (``mesh``, ``tp_specs``, ``zero3``,
:meth:`local_params`, :meth:`from_params`), so
:func:`~sparkdl_tpu_torch.parallel.train.make_train_step` finds the mesh
and the ZeRO-3 split through ``loss_fn.model``.
"""

import contextlib
import dataclasses
import functools
import operator

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models import megatron
from sparkdl_tpu_torch.models.layers import Dense, Embed, LayerNorm
from sparkdl_tpu_torch.models.megatron import IN, fan_in, tp_call
from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel.mesh import gathered
from sparkdl_tpu_torch.parallel.ring_attention import (
    NEG_INF,
    attention_reference,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=128, d_model=32, n_layers=2,
                        n_heads=2, d_ff=64, max_position=64)
        defaults.update(kw)
        return cls(**defaults)


def _sharded(mesh):
    return mesh is not None and (mesh.axis_size("model") > 1
                                 or mesh.axis_size("fsdp") > 1)


def _build_on(mesh, generator, device):
    """Where a model's full shapes are laid: on ``meta`` when it goes on
    a mesh with nothing drawn (its weights are loaded afterwards), else
    on ``device``."""
    if _sharded(mesh) and generator is None:
        return torch.device("meta")
    return device


class BertSelfAttention(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.cfg = cfg
        # this rank's heads and the tensor-parallel context (set by the
        # model's layout)
        self.n_heads = cfg.n_heads
        self.tp = None
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, Dense(cfg.d_model, cfg.d_model, cfg.dtype,
                                        device, generator=generator))

    def forward(self, x, attention_mask=None):
        cfg, tp, h = self.cfg, self.tp, self.n_heads
        b, s, _ = x.shape
        hd = cfg.d_model // cfg.n_heads
        (xq, lq), (xk, lk), (xv, lv) = fan_in(
            x, (self.q_proj, self.k_proj, self.v_proj), tp)
        q = tp_call(self.q_proj, xq, tp, lq, "split").reshape(b, s, h, hd)
        k = tp_call(self.k_proj, xk, tp, lk, "split").reshape(b, s, h, hd)
        v = tp_call(self.v_proj, xv, tp, lv, "split").reshape(b, s, h, hd)
        if attention_mask is not None:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) * hd ** -0.5
            keep = attention_mask.to(torch.bool)[:, None, None, :]
            p = torch.softmax(scores.masked_fill(~keep, NEG_INF), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                             v.float()).to(v.dtype)
        else:
            o = attention_reference(q, k, v, causal=False)
        return tp_call(self.o_proj, o.reshape(b, s, h * hd), tp,
                       have="split")


class BertBlock(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.attn = BertSelfAttention(cfg, device, generator)
        self.attn_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.fc1 = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, device,
                         generator=generator)
        self.fc2 = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, device,
                         generator=generator)
        self.mlp_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.tp = None  # the tensor-parallel context (set by the layout)

    def forward(self, x, attention_mask=None):
        tp = self.tp
        x = self.attn_norm(x + self.attn(x, attention_mask))
        # the hidden in the layout fc2 takes: no collective between the
        # two when fc2 is row-parallel
        mid = "full" if tp is None else IN[self.fc2.tp_role]
        ((xf, have),) = fan_in(x, (self.fc1,), tp)
        h = tp_call(self.fc1, xf, tp, have=have, want=mid)
        h = tp_call(self.fc2, F.gelu(h, approximate="tanh"), tp, have=mid)
        return self.mlp_norm(x + h)


def _lay_out(model, bert, mesh, rules, device):
    """Lay ``model`` (``bert`` itself or a head model over it) out on
    ``mesh`` (:func:`~sparkdl_tpu_torch.models.megatron.shard_model`),
    and give ``bert``'s blocks their heads and contexts."""
    cfg, size = bert.cfg, mesh.axis_size("model")
    if cfg.n_heads % size:
        raise NotImplementedError(
            f"n_heads={cfg.n_heads} does not divide over model={size}: a "
            "rank computes whole heads (GSPMD's reshard of a head across "
            "ranks is not ported)")
    model.tp_specs, model.zero3, model.tp = megatron.shard_model(
        model, mesh, rules, device)
    model.mesh = mesh
    bert.zero3, bert.tp = model.zero3, model.tp
    if model.tp is None:
        return
    for layer in bert.layers:
        layer.tp = layer.attn.tp = model.tp
        layer.attn.n_heads = cfg.n_heads // size


@contextlib.contextmanager
def _top_unit(model):
    """The outermost model's forward: a stale backward regather dropped,
    the ZeRO-3 leaves outside the blocks gathered for its length (none
    under ``TRANSFORMER_RULES``)."""
    zero3 = model.zero3
    top = {}
    if zero3 is not None:
        zero3.release()
        if zero3.has("top"):
            top = zero3.gather("top")
    with megatron.bound(top):
        yield


class _Laid(nn.Module):
    """What the three models share: the layout's attributes and the
    constructors from a whole state dict."""

    def _init_layout(self):
        self.mesh, self.tp_specs, self.zero3, self.tp = None, None, None, None

    @classmethod
    def from_params(cls, cfg, params, device=None, *, mesh=None, rules=None,
                    **kw):
        """A model whose weights ARE the tensors of ``params`` (a state
        dict or flat JAX tree with this model's keys), moved to
        ``device`` and cast to each weight's dtype where they differ.
        With a tensor-parallel or ZeRO-3 ``mesh``, ``params`` is whole
        and the model takes this rank's slice of it. ``kw``: the model's
        other arguments (``num_classes``)."""
        device = resolve_device(device)
        model = cls(cfg, device="meta", mesh=mesh, rules=rules, **kw)
        return megatron.load_params(model, model.local_params(params),
                                    device)

    def local_params(self, params):
        """This rank's slice of the whole state dict (or flat JAX tree)
        ``params`` by :attr:`tp_specs`; ``params`` itself off a mesh."""
        return megatron.local_params(self, params)


class Bert(_Laid):
    """The encoder: fp32 hidden states (B, S, d_model). Weights on
    ``device`` (CUDA unless named), drawn from ``generator`` with flax's
    initialisers (none drawn on a mesh without one: load them). On a
    tensor-parallel or ZeRO-3 ``mesh`` this rank keeps its slice (the
    module's doc)."""

    def __init__(self, cfg, device=None, generator=None, *, mesh=None,
                 rules=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        build = _build_on(mesh, generator, device)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, build,
                           generator)
        self.pos_embed = Embed(cfg.max_position, cfg.d_model, cfg.dtype,
                               build, generator)
        self.type_embed = Embed(cfg.type_vocab, cfg.d_model, cfg.dtype,
                                build, generator)
        self.embed_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, build)
        self.layers = nn.ModuleList(BertBlock(cfg, build, generator)
                                    for _ in range(cfg.n_layers))
        self._init_layout()
        self.outer = True  # False inside a head model, which lays it out
        if _sharded(mesh):
            _lay_out(self, self, mesh, rules, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with (_top_unit(self) if self.outer else contextlib.nullcontext()):
            return self._encode(input_ids, token_type_ids, attention_mask)

    def _encode(self, input_ids, token_type_ids, attention_mask):
        s = input_ids.shape[1]
        rows = [(self.embed, self.embed(input_ids)),
                (self.pos_embed, self.pos_embed(
                    torch.arange(s, device=input_ids.device))[None])]
        if token_type_ids is not None:
            rows.append((self.type_embed, self.type_embed(token_type_ids)))
        # the split lookups summed, then gathered once: the fp32
        # embed_norm needs the whole row
        split = [r for m, r in rows if getattr(m, "tp_split", False)]
        whole = [r for m, r in rows if not getattr(m, "tp_split", False)]
        x = None
        if split:
            x = gathered(functools.reduce(operator.add, split),
                         self.tp.mesh, "model")
        for r in whole:
            x = r if x is None else x + r
        x = self.embed_norm(x)
        for i, layer in enumerate(self.layers):
            x = megatron.run_block(self.zero3, i, layer, x, attention_mask)
        return x


class BertForQuestionAnswering(_Laid):
    """Span prediction (the SQuAD fine-tune): fp32 ``(start, end)``
    logits, (B, S) each."""

    def __init__(self, cfg, device=None, generator=None, *, mesh=None,
                 rules=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        build = _build_on(mesh, generator, device)
        self.bert = Bert(cfg, build, generator)
        self.bert.outer = False
        self.qa_head = Dense(cfg.d_model, 2, torch.float32, build,
                             generator=generator)
        self._init_layout()
        if _sharded(mesh):
            _lay_out(self, self.bert, mesh, rules, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with _top_unit(self):
            x = self.bert(input_ids, token_type_ids, attention_mask)
            logits = tp_call(self.qa_head, x, self.tp)
        return logits[..., 0], logits[..., 1]


class BertForSequenceClassification(_Laid):
    """fp32 class logits (B, num_classes) from the pooled token 0
    (``tanh`` of the fp32 ``pooler``)."""

    def __init__(self, cfg, num_classes=2, device=None, generator=None, *,
                 mesh=None, rules=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.num_classes = num_classes
        build = _build_on(mesh, generator, device)
        self.bert = Bert(cfg, build, generator)
        self.bert.outer = False
        self.pooler = Dense(cfg.d_model, cfg.d_model, torch.float32, build,
                            generator=generator)
        self.classifier = Dense(cfg.d_model, num_classes, torch.float32,
                                build, generator=generator)
        self._init_layout()
        if _sharded(mesh):
            _lay_out(self, self.bert, mesh, rules, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with _top_unit(self):
            x = self.bert(input_ids, token_type_ids, attention_mask)
            pooled = torch.tanh(tp_call(self.pooler, x[:, 0], self.tp))
            return tp_call(self.classifier, pooled, self.tp)
