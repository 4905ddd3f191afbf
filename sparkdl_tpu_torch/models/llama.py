"""Llama-family decoder: the training forward and the paged serving mode.

Counterpart of ``sparkdl_tpu/models/llama.py``. The module and parameter
names follow the JAX package's param tree
(``layers.3.attn.q_proj.kernel`` is ``layer_3/attn/q_proj/kernel``),
and projection weights keep its (in, out) layout, so a JAX tree loads
one to one (:mod:`sparkdl_tpu_torch.models.from_jax`).

- activations and dense weights in ``cfg.dtype`` (bf16), RoPE, norms
  and softmax in fp32, the ``lm_head`` in fp32 over fp32 activations;
- training (``decode=False``): the whole sequence at positions
  ``0..S-1``, GQA by repeating each kv head over its query heads, then
  dense attention (``attention="reference"``) or the flash kernels
  (``attention="flash"``,
  :func:`sparkdl_tpu_torch.ops.attention.flash_attention`);
  LoRA adapters (``lora_rank > 0``) on the ``lora_targets`` projections,
  every other weight frozen; ``remat`` recomputes each block in the
  backward;
- serving (``decode=True``, ``page_size > 0``): the KV cache is one
  pooled physical store per layer, (n_pages, page, Hkv, D), shared by
  all batch rows through per-row block tables (:class:`PagedKVCache`);
  single-token steps attend through
  :func:`sparkdl_tpu_torch.ops.paged_attention.paged_attention_decode`,
  multi-token prefill gathers each row's pages and attends in plain
  PyTorch, as the JAX model does; dense or weight-only int8.

The dense slot cache, int4, multi-LoRA, MoE, injected attention
functions (ring attention) and the tensor-parallel binding are not
ported yet: each raises NotImplementedError by name.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from sparkdl_tpu_torch.models.lora import LoRADense
from sparkdl_tpu_torch.ops import attention as _attention
from sparkdl_tpu_torch.ops import paged_attention as _paged
from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel import ring_attention as _ring

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    # RoPE rescaling: None, ("linear", factor), or ("llama3", factor,
    # low_freq_factor, high_freq_factor, original_max_position_embeddings)
    rope_scaling: Optional[tuple] = None
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False           # recompute each block in the backward
    attention: str = "reference"  # "reference" (dense) | "flash" (kernels)
    flash_block: int = 0          # TPU tile size: only 0 is ported
    decode: bool = False          # KV-cache autoregressive mode
    max_cache_len: int = 2048     # KV-cache capacity for decoding
    # Paged KV cache: page_size > 0 pools n_pages pages of page_size
    # positions, shared by all rows through block tables
    page_size: int = 0
    n_pages: int = 0
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q_proj", "v_proj")
    quant: str = ""               # "" (dense) | "int8" weight-only
    multi_lora: int = 0           # not ported yet: 0 only
    n_experts: int = 0            # not ported yet: 0 only

    def __post_init__(self):
        if self.quant == "int4":
            raise NotImplementedError("quant='int4' is not ported yet")
        if self.quant not in ("", "int8"):
            raise ValueError(
                f"unknown quant mode {self.quant!r}; expected '' or 'int8'")
        if self.quant and self.lora_rank:
            raise ValueError(
                f"quant={self.quant!r} requires lora_rank=0 (merge "
                "adapters with merge_lora_with, then quantize)")
        if self.attention not in ("reference", "flash"):
            raise ValueError(
                f"attention must be 'reference' or 'flash', got "
                f"{self.attention!r}")
        for name in ("flash_block", "multi_lora", "n_experts"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    "(0 only)")

    @classmethod
    def llama3_8b(cls, **kw):
        """Llama-3-8B widths; ``kw`` overrides any field (a cut depth:
        ``n_layers=2``)."""
        defaults = dict(vocab_size=128256, d_model=4096, n_layers=32,
                        n_heads=32, n_kv_heads=8, d_ff=14336)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw):
        """CI-size config (full architecture, small dims)."""
        defaults = dict(vocab_size=256, d_model=64, n_layers=2,
                        n_heads=4, n_kv_heads=2, d_ff=128)
        defaults.update(kw)
        return cls(**defaults)


def rope_freqs(head_dim, max_seq, theta, scaling=None, device=None):
    """RoPE cos/sin tables (max_seq, head_dim / 2) in fp32. ``scaling``
    as in :attr:`LlamaConfig.rope_scaling`: ``linear`` stretches every
    position uniformly; ``llama3`` keeps short wavelengths, stretches
    long ones by ``factor`` and interpolates the band between."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    if scaling is not None:
        kind = scaling[0]
        if kind == "linear":
            inv = inv / scaling[1]
        elif kind == "llama3":
            _, factor, low_ff, high_ff, orig_len = scaling
            wavelen = 2.0 * math.pi / inv
            low_wl = orig_len / low_ff
            high_wl = orig_len / high_ff
            smooth = (orig_len / wavelen - low_ff) / (high_ff - low_ff)
            inv_mid = (1 - smooth) * inv / factor + smooth * inv
            inv = torch.where(
                wavelen < high_wl, inv,
                torch.where(wavelen > low_wl, inv / factor, inv_mid))
        else:
            raise ValueError(f"unknown rope scaling kind {kind!r}")
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)                       # (S, D/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, positions):
    """Rotate x (B, S, H, D) at positions (B, S) in fp32; the two halves
    of the head dim pair up (not interleaved)."""
    c = cos[positions][..., None, :]                # (B, S, 1, D/2)
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _param(shape, dtype, device):
    # frozen weights: no autograd state; filled by a loader or init_weights
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """Bias-free projection over a (in, out) ``kernel``, computed in
    ``dtype`` (the JAX package's ``nn.Dense(use_bias=False)``)."""

    def __init__(self, d_in, features, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((d_in, features), dtype, device)

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel


class Embed(nn.Module):
    def __init__(self, vocab, d_model, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, d_model), dtype, device)

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32, device)

    def forward(self, x):
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


def _dense(cfg, d_in, features, device, name):
    if cfg.quant:
        from sparkdl_tpu_torch.models.quant import QuantDense

        return QuantDense(d_in, features, cfg.dtype, device)
    if cfg.lora_rank and name in cfg.lora_targets:
        return LoRADense(d_in, features, cfg.lora_rank, cfg.lora_alpha,
                         cfg.dtype, device)
    return Dense(d_in, features, cfg.dtype, device)


@dataclasses.dataclass
class PagedKVCache:
    """The pooled physical cache of every layer: ``k`` and ``v`` are
    (n_layers, n_pages, page, Hkv, D). Page 0 is the dump page for
    padding junk and inactive rows."""

    k: torch.Tensor
    v: torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.d_model // cfg.n_heads
        self.q_proj = _dense(cfg, cfg.d_model, cfg.n_heads * hd, device,
                             "q_proj")
        self.k_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd, device,
                             "k_proj")
        self.v_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd, device,
                             "v_proj")
        self.o_proj = _dense(cfg, cfg.n_heads * hd, cfg.d_model, device,
                             "o_proj")

    def forward(self, x, cos, sin, positions, block_tables=None, k_pool=None,
                v_pool=None):
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        hkv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, cfg.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, hkv, hd)
        v = self.v_proj(x).reshape(b, s, hkv, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        if k_pool is None:
            # training: GQA by repeating each kv head over its rep query
            # heads (jnp.repeat on the head axis), then attend
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            if cfg.attention == "flash":
                o = _attention.flash_attention(q, k, v, causal=True)
            else:
                o = _ring.attention_reference(q, k, v, causal=True)
            return self.o_proj(o.reshape(b, s, cfg.n_heads * hd))
        # write: logical -> physical scatter, in place into the pool
        P = cfg.page_size
        tables = block_tables.long()
        page_of = torch.gather(tables, 1, positions // P)     # (b, s)
        k_pool[page_of, positions % P] = k.to(k_pool.dtype)
        v_pool[page_of, positions % P] = v.to(v_pool.dtype)
        if s == 1:
            o = _paged.paged_attention_decode(
                q[:, 0].contiguous(), k_pool, v_pool,
                block_tables.to(torch.int32).contiguous(),
                (positions[:, 0] + 1).to(torch.int32))
            return self.o_proj(o.reshape(b, s, cfg.n_heads * hd))
        # read: gather each row's pages into its logical view; GQA by
        # grouping the query heads of each kv head (no K/V repeat);
        # input-dtype operands, fp32 scores and accumulation
        L = tables.shape[1] * P
        k = k_pool[tables].reshape(b, L, hkv, hd)
        v = v_pool[tables].reshape(b, L, hkv, hd)
        mask = (torch.arange(L, device=x.device)[None, None, :]
                <= positions[:, :, None])                     # (b, s, L)
        qg = q.reshape(b, s, hkv, rep, hd)
        scores = torch.einsum("bsgrd,blgd->bgrsl", qg.float(),
                              k.float()) * hd ** -0.5
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bgrsl,blgd->bsgrd", probs.float(), v.float())
        o = o.to(v.dtype).reshape(b, s, cfg.n_heads * hd)
        return self.o_proj(o)


class MLP(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device,
                                "gate_proj")
        self.up_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device, "up_proj")
        self.down_proj = _dense(cfg, cfg.d_ff, cfg.d_model, device,
                                "down_proj")

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, cos, sin, positions, block_tables=None, k_pool=None,
                v_pool=None):
        h = x + self.attn(self.attn_norm(x), cos, sin, positions,
                          block_tables, k_pool, v_pool)
        return h + self.mlp(self.mlp_norm(h))


class Llama(nn.Module):
    """The decoder. ``Llama(cfg)`` allocates its weights uninitialised
    on ``device`` (CUDA unless the caller names another); fill them with
    :func:`~sparkdl_tpu_torch.models.from_jax.load_jax_params`, or build
    the model from a state dict with :meth:`from_params`."""

    def __init__(self, cfg, device=None, *, attention_fn=None,
                 paged_attention_fn=None):
        super().__init__()
        for name, value in (("attention_fn", attention_fn),
                            ("paged_attention_fn", paged_attention_fn)):
            if value is not None:
                raise NotImplementedError(
                    f"{name} (ring attention, tensor-parallel decode) is "
                    "not ported yet")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        if cfg.quant:
            from sparkdl_tpu_torch.models.quant import QuantDense

            # int8 head over FP32 activations, as the JAX package
            self.lm_head = QuantDense(cfg.d_model, cfg.vocab_size,
                                      torch.float32, device)
        else:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size,
                                 torch.float32, device)
        self._rope = {}  # device -> (cos, sin), built at first use

    @classmethod
    def from_params(cls, cfg, params, device=None):
        """A model whose weights ARE the tensors of ``params`` (a state
        dict with this model's keys), moved to ``device`` and cast to
        each weight's dtype where they differ — no other copy. Raises
        on a missing, unexpected or mis-shaped entry."""
        device = resolve_device(device)
        model = cls(cfg, device="meta")
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

    @property
    def device(self):
        return self.embed.embedding.device

    def init_cache(self):
        """A zeroed :class:`PagedKVCache` for this config, on the
        model's device."""
        cfg = self.cfg
        if not (cfg.decode and cfg.page_size and cfg.n_pages):
            raise NotImplementedError(
                "only the paged decode cache is ported: set decode=True, "
                "page_size > 0 and n_pages > 0")
        shape = (cfg.n_layers, cfg.n_pages, cfg.page_size, cfg.n_kv_heads,
                 cfg.d_model // cfg.n_heads)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def _rope_tables(self, device, length):
        """cos/sin tables of ``length`` positions, kept per device for the
        longest length asked so far (a prefix of a longer table is the
        shorter one)."""
        tables = self._rope.get(device)
        if tables is None or tables[0].shape[0] < length:
            cfg = self.cfg
            tables = rope_freqs(cfg.d_model // cfg.n_heads, length,
                                cfg.rope_theta, cfg.rope_scaling,
                                device=device)
            self._rope[device] = tables
        return tables

    def forward(self, tokens, positions=None, block_tables=None, cache=None,
                return_hidden=False, adapter_ids=None):
        """Logits (B, S, vocab) in fp32 for tokens (B, S).

        Training (``cfg.decode`` False): the whole sequence at positions
        ``0..S-1`` (or ``positions``, (S,) or (B, S)), no cache.
        Serving (``cfg.decode``, ``cfg.page_size > 0``): tokens at
        explicit positions (B, S), their K/V written into ``cache``
        through the rows' block tables (B, max_pages).

        ``return_hidden=True`` returns the final-norm hidden states
        (B, S, d_model) instead, the input of
        :func:`sparkdl_tpu_torch.parallel.train.fused_cross_entropy`.
        ``adapter_ids`` (multi-LoRA) is not ported yet and raises."""
        cfg = self.cfg
        if adapter_ids is not None:
            raise NotImplementedError("adapter_ids (multi-LoRA) is not "
                                      "ported yet")
        b, s = tokens.shape
        if cfg.decode:
            if not cfg.page_size:
                raise NotImplementedError(
                    "only the paged decode path is ported: set decode=True "
                    "and page_size > 0")
            if positions is None or block_tables is None or cache is None:
                raise ValueError("paged decode needs explicit positions, "
                                 "block_tables and cache")
            if s > cfg.max_cache_len:
                raise ValueError(
                    f"sequence {s} exceeds max_cache_len {cfg.max_cache_len}")
            length = cfg.max_cache_len
        else:
            if block_tables is not None or cache is not None:
                raise NotImplementedError(
                    "block_tables and cache belong to the paged decode "
                    "path (decode=True, page_size > 0); the training "
                    "forward takes tokens (and positions) only")
            if positions is None:
                positions = torch.arange(s, device=tokens.device)
            # the table covers training (seq s) and cached decoding
            length = max(s, cfg.max_cache_len)
        positions = torch.as_tensor(positions, device=tokens.device).long()
        positions = positions.expand(b, s)
        cos, sin = self._rope_tables(tokens.device, length)
        x = self.embed(tokens.long())
        for i, layer in enumerate(self.layers):
            if cfg.decode:
                x = layer(x, cos, sin, positions, block_tables, cache.k[i],
                          cache.v[i])
            elif cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, cos, sin, positions, use_reentrant=False)
            else:
                x = layer(x, cos, sin, positions)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.lm_head(x.to(torch.float32))


def init_weights(model, generator, std=0.02):
    """Fill ``model``'s weights in place with random values drawn from
    ``generator`` (a ``torch.Generator`` on the model's device): every
    projection, the embedding, the head and ``lora_a`` normal(0, std),
    ``lora_b`` zeros and the norm scales ones (the JAX LoRA init, with
    normal(std) in place of the base projections' lecun-normal).
    Returns ``model``. Dense models only: an int8 model is built from a
    dense state dict
    (:func:`~sparkdl_tpu_torch.models.quant.quantize_llama_params`)."""
    if model.cfg.quant:
        raise ValueError("init_weights fills dense weights; quantize a dense "
                         "state dict for an int8 model")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "lora_b":
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
    return model
