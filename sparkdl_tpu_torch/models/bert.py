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
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import Dense, Embed, LayerNorm
from sparkdl_tpu_torch.ops._dispatch import resolve_device
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


class BertSelfAttention(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, Dense(cfg.d_model, cfg.d_model, cfg.dtype,
                                        device, generator=generator))

    def forward(self, x, attention_mask=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.d_model // cfg.n_heads
        q = self.q_proj(x).reshape(b, s, cfg.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, cfg.n_heads, hd)
        v = self.v_proj(x).reshape(b, s, cfg.n_heads, hd)
        if attention_mask is not None:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) * hd ** -0.5
            keep = attention_mask.to(torch.bool)[:, None, None, :]
            p = torch.softmax(scores.masked_fill(~keep, NEG_INF), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                             v.float()).to(v.dtype)
        else:
            o = attention_reference(q, k, v, causal=False)
        return self.o_proj(o.reshape(b, s, cfg.d_model))


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

    def forward(self, x, attention_mask=None):
        x = self.attn_norm(x + self.attn(x, attention_mask))
        h = self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.mlp_norm(x + h)


class Bert(nn.Module):
    """The encoder: fp32 hidden states (B, S, d_model). Weights on
    ``device`` (CUDA unless named), drawn from ``generator`` with flax's
    initialisers."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device,
                           generator)
        self.pos_embed = Embed(cfg.max_position, cfg.d_model, cfg.dtype,
                               device, generator)
        self.type_embed = Embed(cfg.type_vocab, cfg.d_model, cfg.dtype,
                                device, generator)
        self.embed_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(BertBlock(cfg, device, generator)
                                    for _ in range(cfg.n_layers))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        s = input_ids.shape[1]
        x = self.embed(input_ids)
        x = x + self.pos_embed(torch.arange(s, device=input_ids.device))[None]
        if token_type_ids is not None:
            x = x + self.type_embed(token_type_ids)
        x = self.embed_norm(x)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x


class BertForQuestionAnswering(nn.Module):
    """Span prediction (the SQuAD fine-tune): fp32 ``(start, end)``
    logits, (B, S) each."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = Bert(cfg, device, generator)
        self.qa_head = Dense(cfg.d_model, 2, torch.float32, device,
                             generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.qa_head(x)
        return logits[..., 0], logits[..., 1]


class BertForSequenceClassification(nn.Module):
    """fp32 class logits (B, num_classes) from the pooled token 0
    (``tanh`` of the fp32 ``pooler``)."""

    def __init__(self, cfg, num_classes=2, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.num_classes = num_classes
        self.bert = Bert(cfg, device, generator)
        self.pooler = Dense(cfg.d_model, cfg.d_model, torch.float32, device,
                            generator=generator)
        self.classifier = Dense(cfg.d_model, num_classes, torch.float32,
                                device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(torch.tanh(self.pooler(x[:, 0])))
