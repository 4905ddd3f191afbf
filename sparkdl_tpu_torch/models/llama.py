"""Llama-family decoder in its paged serving mode.

Counterpart of ``sparkdl_tpu/models/llama.py``, ported for the serving
slice: the paged KV-cache decode path, dense or weight-only int8. The
module and parameter names follow the JAX package's param tree
(``layers.3.attn.q_proj.kernel`` is ``layer_3/attn/q_proj/kernel``),
and projection weights keep its (in, out) layout, so a JAX tree loads
one to one (:mod:`sparkdl_tpu_torch.models.from_jax`).

- activations and dense weights in ``cfg.dtype`` (bf16 to serve), RoPE,
  norms and softmax in fp32, the ``lm_head`` in fp32;
- the KV cache is one pooled physical store per layer,
  (n_pages, page, Hkv, D), shared by all batch rows through per-row
  block tables (:class:`PagedKVCache`); the forward writes the step's
  K/V into it in place;
- single-token steps attend through
  :func:`sparkdl_tpu_torch.ops.paged_attention.paged_attention_decode`
  (the CUDA kernel on the card); multi-token prefill gathers each row's
  pages into its logical view and attends in plain PyTorch, as the JAX
  model does.

Training mode, the dense slot cache, LoRA, int4, MoE and the
tensor-parallel binding are not ported yet.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.ops import paged_attention as _paged
from sparkdl_tpu_torch.ops._dispatch import resolve_device

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
    decode: bool = False          # KV-cache autoregressive mode
    max_cache_len: int = 2048     # KV-cache capacity for decoding
    # Paged KV cache: page_size > 0 pools n_pages pages of page_size
    # positions, shared by all rows through block tables
    page_size: int = 0
    n_pages: int = 0
    quant: str = ""               # "" (dense) | "int8" weight-only

    def __post_init__(self):
        if self.quant == "int4":
            raise NotImplementedError("quant='int4' is not ported yet")
        if self.quant not in ("", "int8"):
            raise ValueError(
                f"unknown quant mode {self.quant!r}; expected '' or 'int8'")

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
    # inference-only weights: no autograd state; filled by a loader
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


def _dense(cfg, d_in, features, device):
    if cfg.quant:
        from sparkdl_tpu_torch.models.quant import QuantDense

        return QuantDense(d_in, features, cfg.dtype, device)
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
        self.q_proj = _dense(cfg, cfg.d_model, cfg.n_heads * hd, device)
        self.k_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd, device)
        self.v_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd, device)
        self.o_proj = _dense(cfg, cfg.n_heads * hd, cfg.d_model, device)

    def forward(self, x, cos, sin, positions, block_tables, k_pool, v_pool):
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        hkv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, cfg.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, hkv, hd)
        v = self.v_proj(x).reshape(b, s, hkv, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
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
        self.gate_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device)
        self.up_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device)
        self.down_proj = _dense(cfg, cfg.d_ff, cfg.d_model, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, cos, sin, positions, block_tables, k_pool, v_pool):
        h = x + self.attn(self.attn_norm(x), cos, sin, positions,
                          block_tables, k_pool, v_pool)
        return h + self.mlp(self.mlp_norm(h))


class Llama(nn.Module):
    """The decoder. ``Llama(cfg)`` allocates its weights uninitialised
    on ``device`` (CUDA unless the caller names another); fill them with
    :func:`~sparkdl_tpu_torch.models.from_jax.load_jax_params`, or build
    the model from a state dict with :meth:`from_params`."""

    def __init__(self, cfg, device=None):
        super().__init__()
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

    def _rope_tables(self, device):
        tables = self._rope.get(device)
        if tables is None:
            cfg = self.cfg
            tables = rope_freqs(cfg.d_model // cfg.n_heads,
                                cfg.max_cache_len, cfg.rope_theta,
                                cfg.rope_scaling, device=device)
            self._rope[device] = tables
        return tables

    def forward(self, tokens, positions, block_tables, cache):
        """Logits (B, S, vocab) in fp32 for tokens (B, S) at explicit
        positions (B, S), writing their K/V into ``cache`` through the
        rows' block tables (B, max_pages)."""
        cfg = self.cfg
        if not (cfg.decode and cfg.page_size):
            raise NotImplementedError(
                "only the paged decode path is ported: set decode=True "
                "and page_size > 0")
        b, s = tokens.shape
        positions = torch.as_tensor(positions, device=tokens.device).long()
        positions = positions.expand(b, s)
        if s > cfg.max_cache_len:
            raise ValueError(
                f"sequence {s} exceeds max_cache_len {cfg.max_cache_len}")
        cos, sin = self._rope_tables(tokens.device)
        x = self.embed(tokens.long())
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, positions, block_tables, cache.k[i],
                      cache.v[i])
        x = self.final_norm(x)
        return self.lm_head(x.to(torch.float32))
