"""Llama-family decoder: the training forward and the serving modes.

Counterpart of ``sparkdl_tpu/models/llama.py``. The module and parameter
names follow the JAX package's param tree
(``layers.3.attn.q_proj.kernel`` is ``layer_3/attn/q_proj/kernel``),
and projection weights keep its (in, out) layout, so a JAX tree loads
one to one (:mod:`sparkdl_tpu_torch.models.from_jax`).

- activations and dense weights in ``cfg.dtype`` (bf16), RoPE, norms
  and softmax in fp32, the ``lm_head`` in fp32 over fp32 activations;
- training (``decode=False``): the whole sequence at positions
  ``0..S-1`` (or the ``positions`` given: a sequence shard's start at
  its offset), GQA by repeating each kv head over its query heads, then
  dense attention (``attention="reference"``), the flash kernels
  (``attention="flash"``,
  :func:`sparkdl_tpu_torch.ops.attention.flash_attention`) or, when
  given, ``attention_fn(q, k, v)`` in place of both (ring attention
  under sequence parallelism,
  :func:`sparkdl_tpu_torch.parallel.ring_attention.make_ring_attention`);
  LoRA adapters (``lora_rank > 0``) on the ``lora_targets`` projections,
  every other weight frozen; ``remat`` recomputes each block in the
  backward;
- serving (``decode=True``) over one of two caches:

  - paged (``page_size > 0``): one pooled physical store per layer,
    (n_pages, page, Hkv, D), shared by all batch rows through per-row
    block tables (:class:`PagedKVCache`); single-token steps attend
    through
    :func:`sparkdl_tpu_torch.ops.paged_attention.paged_attention_decode`,
    multi-token steps gather each row's pages and attend in plain
    PyTorch, as the JAX model does, from any start position (chunked
    prefill, shared prefixes, speculative verify);
  - dense slot cache (``page_size == 0``, :class:`DenseKVCache`): each
    row owns ``max_cache_len`` rows of K/V. With explicit ``positions``
    every row writes and attends at its own positions (slot-mapped
    serving); without them the cache's one shared index places the
    tokens and advances by S (``generate`` and the speculative
    rewind). Attention masks key t unless t <= the query's position,
    so rows past a row's position are never read, whatever they hold;
    it runs in plain PyTorch, as the JAX package computes it outside
    any kernel;

  dense, or weight-only int8 or int4;
- multi-LoRA serving (``multi_lora = N``): N adapters stacked on one
  frozen base, on attention projections only, selected per batch row by
  ``adapter_ids`` (adapter 0 when omitted);
- tensor parallelism (``Llama(cfg, mesh=...)``, a mesh whose ``model``
  axis is > 1), in training and serving: Megatron, done explicitly, as
  there is no GSPMD here. Each rank of a port gang holds its slice of
  every split weight (:func:`sparkdl_tpu_torch.parallel.sharding.tp_layout`
  of the rules, default ``TRANSFORMER_RULES``), computes attention on its
  own n_heads/m query heads and n_kv_heads/m kv heads (its cache holds
  only those), and calls each collective by name on the mesh's ``model``
  group: an all-reduce after each row-parallel projection (o_proj,
  down_proj; Megatron's g), an all-gather where a split output must be
  whole (the embedding's d_model, the head's vocabulary). A projection
  the rules leave whole (divisibility) computes whole, with no
  collective. When gradients are recorded the collectives are the
  differentiable ones of :mod:`sparkdl_tpu_torch.parallel.mesh`, and
  each column-parallel input enters through Megatron's f (Q, K and V
  share one, gate and up another), as does a whole trained leaf that a
  split projection uses (``lora_a`` of a column-parallel target,
  ``lora_b`` of a row-parallel one), so its gradient is summed over
  ``model`` as GSPMD sums it. Every rank must run the same forwards and
  backwards in the same order (``cfg.remat``'s recompute re-issues a
  block's all-reduces on every rank alike). A mesh with ``fsdp > 1``
  stores the weights ZeRO-3. The machinery is
  :mod:`~sparkdl_tpu_torch.models.megatron`, which BERT shares.
  ``paged_attention_fn`` replaces the single-token paged decode call
  (the engine passes
  :func:`~sparkdl_tpu_torch.ops.paged_attention.paged_attention_decode_sharded`).

- Mixtral-style sparse FFN (``n_experts > 0``): a top-k routed expert
  MLP (:class:`~sparkdl_tpu_torch.models.moe.MoEMLP`, ``moe_mlp``) in
  place of the dense MLP on every ``moe_every``-th layer, in every mode
  above; its router probabilities come back with
  ``forward(..., return_intermediates=True)`` for
  :func:`~sparkdl_tpu_torch.models.moe.moe_aux_loss`. Tensor-parallel,
  each rank holds n_experts/m experts and all-reduces their combine.

The TPU's kernel-mode fields (``paged_kernel``, ``quant_kernel``) are
not fields here.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from sparkdl_tpu_torch.models import megatron
from sparkdl_tpu_torch.models.lora import LoRADense, MultiLoRADense
from sparkdl_tpu_torch.models.megatron import IN, bound, fan_in, tp_call
from sparkdl_tpu_torch.models.moe import MoEConfig, MoEMLP
from sparkdl_tpu_torch.ops import attention as _attention
from sparkdl_tpu_torch.ops import paged_attention as _paged
from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.parallel import ring_attention as _ring
from sparkdl_tpu_torch.parallel.mesh import gathered

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
    quant: str = ""               # "" (dense) | "int8" | "int4" weight-only
    # int4 group size (rows per scale); must match the checkpoint's
    # quantize group, since it sizes the (in/group, out) scales
    quant_group: int = 64
    # multi-LoRA serving: > 0 stacks that many adapters on the frozen
    # base (state dicts from models.lora.stack_lora_adapters); the
    # forward's adapter_ids select one a batch row. Attention targets
    # only.
    multi_lora: int = 0
    # Mixtral-style sparse FFN: n_experts > 0 replaces the dense MLP
    # with a top-k routed expert MLP on every moe_every-th layer (1 =
    # all layers); the router-balance aux loss reads
    # forward(..., return_intermediates=True) through models.moe
    n_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1

    def __post_init__(self):
        if self.quant not in ("", "int8", "int4"):
            raise ValueError(
                f"unknown quant mode {self.quant!r}; expected '', 'int8' "
                "or 'int4'")
        if self.quant and self.lora_rank:
            raise ValueError(
                f"quant={self.quant!r} requires lora_rank=0 (merge "
                "adapters with merge_lora_with, then quantize)")
        if self.attention not in ("reference", "flash"):
            raise ValueError(
                f"attention must be 'reference' or 'flash', got "
                f"{self.attention!r}")
        if self.multi_lora:
            attn_names = {"q_proj", "k_proj", "v_proj", "o_proj"}
            bad = set(self.lora_targets) - attn_names
            if bad:
                raise ValueError(
                    f"multi_lora supports attention adapter targets only; "
                    f"got {sorted(bad)}")
            if self.quant:
                raise ValueError(
                    "multi_lora and quant are mutually exclusive (quantize "
                    "a merged single-adapter tree instead)")
            if not self.lora_rank:
                raise ValueError("multi_lora requires lora_rank > 0")
        if self.n_experts > 0:
            if not 0 < self.moe_top_k <= self.n_experts:
                raise ValueError(
                    f"moe_top_k={self.moe_top_k} must be in "
                    f"[1, n_experts={self.n_experts}]")
            if self.moe_every < 1:
                raise ValueError(
                    f"moe_every={self.moe_every} must be >= 1")
        if self.flash_block:
            raise NotImplementedError(
                f"flash_block={self.flash_block!r} is not ported yet "
                "(0 only)")

    def use_moe(self, i):
        """Whether layer ``i`` carries the expert MLP."""
        return (self.n_experts > 0
                and i % self.moe_every == self.moe_every - 1)

    @classmethod
    def llama3_8b(cls, **kw):
        """Llama-3-8B widths; ``kw`` overrides any field (a cut depth:
        ``n_layers=2``)."""
        defaults = dict(vocab_size=128256, d_model=4096, n_layers=32,
                        n_heads=32, n_kv_heads=8, d_ff=14336)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama31_8b(cls, **kw):
        """Llama-3.1-8B: the 3.0 widths with Meta's llama3 RoPE rescale
        (factor 8 over the 8192-token original window), which serves
        positions past that window; ``kw`` overrides any field."""
        kw.setdefault("rope_scaling", ("llama3", 8.0, 1.0, 4.0, 8192))
        return cls.llama3_8b(**kw)

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
        self.tp_split = False  # d_model split over the model axis

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


def _quant_dense(cfg, d_in, features, dtype, device):
    from sparkdl_tpu_torch.models.quant import QuantDense, QuantDense4

    if cfg.quant == "int4":
        return QuantDense4(d_in, features, dtype, device,
                           group=cfg.quant_group)
    return QuantDense(d_in, features, dtype, device)


def _dense(cfg, d_in, features, device, name):
    if cfg.quant:
        return _quant_dense(cfg, d_in, features, cfg.dtype, device)
    if cfg.multi_lora and name in cfg.lora_targets:
        return MultiLoRADense(d_in, features, cfg.lora_rank, cfg.lora_alpha,
                              cfg.multi_lora, cfg.dtype, device)
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


@dataclasses.dataclass
class DenseKVCache:
    """The dense slot cache of every layer: ``k`` and ``v`` are
    (n_layers, batch, max_cache_len, Hkv, D), one run of rows a batch
    row. ``index`` is the shared index of a forward without
    ``positions``: its tokens go to rows ``index..index+S-1`` of every
    batch row, and it advances by S. Setting it back rewinds the cache
    (rejected speculation): the rows beyond it are hidden by position
    until they are written again."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0


def _attend(q, k, v, positions, hd):
    """Attention of q (b, s, H, D) over the logical K/V view (b, L, Hkv,
    D): key t is visible to the query at position p iff t <= p, so rows
    past a query's position (junk, padding, another request's rows) are
    never read. GQA by grouping the query heads of each kv head (no K/V
    repeat); fp32 scores and accumulation; returns (b, s, H * D) in
    v's dtype."""
    b, s, n_heads, _ = q.shape
    L, hkv = k.shape[1], k.shape[2]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= positions[:, :, None])                         # (b, s, L)
    qg = q.reshape(b, s, hkv, n_heads // hkv, hd)
    scores = torch.einsum("bsgrd,blgd->bgrsl", qg.float(),
                          k.float()) * hd ** -0.5
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bgrsl,blgd->bsgrd", probs.float(), v.float())
    return o.to(v.dtype).reshape(b, s, n_heads * hd)


class Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        # this rank's heads, the tensor-parallel context and the decode
        # binding (set by the model)
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads
        self.tp = None
        self.paged_fn = None
        self.attention_fn = None
        hd = cfg.d_model // cfg.n_heads
        self.q_proj = _dense(cfg, cfg.d_model, cfg.n_heads * hd, device,
                             "q_proj")
        self.k_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd, device,
                             "k_proj")
        self.v_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd, device,
                             "v_proj")
        self.o_proj = _dense(cfg, cfg.n_heads * hd, cfg.d_model, device,
                             "o_proj")

    def _proj(self, module, x, adapter_ids, have="full", want="full"):
        return tp_call(module, x, self.tp, have, want, adapter_ids)

    def forward(self, x, cos, sin, positions, block_tables=None, k_cache=None,
                v_cache=None, adapter_ids=None):
        """``k_cache`` / ``v_cache``: this layer's pool (paged, with
        ``block_tables``) or its dense slot rows (b, L, Hkv, D); None in
        training."""
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        n_heads, hkv = self.n_heads, self.n_kv_heads
        rep = n_heads // hkv
        b, s, _ = x.shape
        # under tensor parallelism: this rank's heads ("split"), Q, K
        # and V behind one f
        (xq, lq), (xk, lk), (xv, lv) = fan_in(
            x, (self.q_proj, self.k_proj, self.v_proj), self.tp)
        q = self._proj(self.q_proj, xq, adapter_ids, lq, "split").reshape(
            b, s, n_heads, hd)
        k = self._proj(self.k_proj, xk, adapter_ids, lk, "split").reshape(
            b, s, hkv, hd)
        v = self._proj(self.v_proj, xv, adapter_ids, lv, "split").reshape(
            b, s, hkv, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        if k_cache is None:
            # training: GQA by repeating each kv head over its rep query
            # heads (jnp.repeat on the head axis), then attend
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            if self.attention_fn is not None:
                o = self.attention_fn(q, k, v)
            elif cfg.attention == "flash":
                o = _attention.flash_attention(q, k, v, causal=True)
            else:
                o = _ring.attention_reference(q, k, v, causal=True)
            return self._proj(self.o_proj, o.reshape(b, s, n_heads * hd),
                              adapter_ids, have="split")
        if block_tables is None:
            # dense slot cache: write each row's tokens at its own
            # positions, then attend over all of its rows by position
            rows = torch.arange(b, device=x.device)[:, None]
            k_cache[rows, positions] = k.to(k_cache.dtype)
            v_cache[rows, positions] = v.to(v_cache.dtype)
            o = _attend(q, k_cache, v_cache, positions, hd)
            return self._proj(self.o_proj, o, adapter_ids, have="split")
        # paged write: logical -> physical scatter, in place into the pool
        P = cfg.page_size
        tables = block_tables.long()
        page_of = torch.gather(tables, 1, positions // P)     # (b, s)
        k_cache[page_of, positions % P] = k.to(k_cache.dtype)
        v_cache[page_of, positions % P] = v.to(v_cache.dtype)
        if s == 1:
            decode = (self.paged_fn if self.paged_fn is not None
                      else _paged.paged_attention_decode)
            o = decode(q[:, 0].contiguous(), k_cache, v_cache,
                       block_tables.to(torch.int32).contiguous(),
                       (positions[:, 0] + 1).to(torch.int32))
            return self._proj(self.o_proj, o.reshape(b, s, n_heads * hd),
                              adapter_ids, have="split")
        # read: gather each row's pages into its logical view
        L = tables.shape[1] * P
        o = _attend(q, k_cache[tables].reshape(b, L, hkv, hd),
                    v_cache[tables].reshape(b, L, hkv, hd), positions, hd)
        return self._proj(self.o_proj, o, adapter_ids, have="split")


class MLP(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device,
                                "gate_proj")
        self.up_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device, "up_proj")
        self.down_proj = _dense(cfg, cfg.d_ff, cfg.d_model, device,
                                "down_proj")
        self.tp = None  # the tensor-parallel context (set by the model)

    def forward(self, x):
        tp = self.tp
        # the hidden in the layout down_proj takes: no collective between
        # the three when down_proj is row-parallel
        mid = "full" if tp is None else IN[self.down_proj.tp_role]
        (xg, lg), (xu, lu) = fan_in(x, (self.gate_proj, self.up_proj), tp)
        g = tp_call(self.gate_proj, xg, tp, have=lg, want=mid)
        u = tp_call(self.up_proj, xu, tp, have=lu, want=mid)
        return tp_call(self.down_proj, F.silu(g) * u, tp, have=mid)


class Block(nn.Module):
    def __init__(self, cfg, device, use_moe=False):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.use_moe = use_moe
        if use_moe:
            self.moe_mlp = MoEMLP(
                MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                          n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                          dtype=cfg.dtype), device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, cos, sin, positions, block_tables=None, k_cache=None,
                v_cache=None, adapter_ids=None, record=None):
        """``record``: the dict an MoE layer's router probabilities go
        to (:meth:`MoEMLP.forward`), or None."""
        h = x + self.attn(self.attn_norm(x), cos, sin, positions,
                          block_tables, k_cache, v_cache, adapter_ids)
        if self.use_moe:
            return h + self.moe_mlp(self.mlp_norm(h), record)
        return h + self.mlp(self.mlp_norm(h))


class Llama(nn.Module):
    """The decoder. ``Llama(cfg)`` allocates its weights uninitialised
    on ``device`` (CUDA unless the caller names another); fill them with
    :func:`~sparkdl_tpu_torch.models.from_jax.load_jax_params`, or build
    the model from a state dict with :meth:`from_params`.

    ``mesh`` (:class:`sparkdl_tpu_torch.parallel.mesh.Mesh`) with a
    ``model`` axis > 1 makes the model tensor-parallel: it holds only
    this rank's slice of each weight, laid out by ``rules`` (default
    ``TRANSFORMER_RULES``; :attr:`tp_specs` after construction), and
    computes on this rank's heads. An ``fsdp`` axis > 1 shards the
    weights the rules split over it (ZeRO-3), gathered whole before each
    use; :attr:`mesh` is set when either axis is > 1.
    ``paged_attention_fn(q, k_pool, v_pool, tables, lens)`` takes the
    place of the single-token paged decode call; ``attention_fn(q, k,
    v)`` (B, S, H, D each, kv heads repeated) that of the training
    forward's attention."""

    def __init__(self, cfg, device=None, *, attention_fn=None,
                 paged_attention_fn=None, mesh=None, rules=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        sharded = mesh is not None and (mesh.axis_size("model") > 1
                                        or mesh.axis_size("fsdp") > 1)
        # a sharded model is laid out on the full shapes first, with no
        # memory behind them, then given its local weights
        build = torch.device("meta") if sharded else device
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, build)
        self.layers = nn.ModuleList(
            Block(cfg, build, cfg.use_moe(i)) for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.rms_eps, build)
        if cfg.quant:
            # quantized head over FP32 activations, as the JAX package
            self.lm_head = _quant_dense(cfg, cfg.d_model, cfg.vocab_size,
                                        torch.float32, build)
        else:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size,
                                 torch.float32, build)
        self.tp, self.tp_specs, self.mesh = None, None, None
        self.zero3 = None  # the ZeRO-3 units (fsdp > 1)
        self.n_kv_heads = cfg.n_kv_heads  # this rank's, in the cache
        if sharded:
            self._shard(mesh, rules, device)
        for layer in self.layers:
            layer.attn.paged_fn = paged_attention_fn
            layer.attn.attention_fn = attention_fn
        self._rope = {}  # device -> (cos, sin), built at first use

    def _shard(self, mesh, rules, device):
        """Give every weight its local shape on ``device`` by the rules'
        layout, the ZeRO-3 units their split leaves, and each projection
        its role (:func:`~sparkdl_tpu_torch.models.megatron.shard_model`);
        then each attention its heads."""
        cfg, size = self.cfg, mesh.axis_size("model")
        if cfg.n_kv_heads % size:
            raise NotImplementedError(
                f"n_kv_heads={cfg.n_kv_heads} does not divide over "
                f"model={size}: the tensor-parallel cache holds each "
                "rank's kv heads (a replicated pool is not ported)")
        if cfg.n_experts % size:
            raise NotImplementedError(
                f"n_experts={cfg.n_experts} does not divide over "
                f"model={size}: each rank holds whole experts (replicated "
                "experts are not ported)")
        self.tp_specs, self.zero3, self.tp = megatron.shard_model(
            self, mesh, rules, device)
        self.mesh = mesh
        if self.tp is None:
            return
        self.n_kv_heads = cfg.n_kv_heads // size
        for layer in self.layers:
            layer.attn.tp = self.tp
            (layer.moe_mlp if layer.use_moe else layer.mlp).tp = self.tp
            layer.attn.n_heads = cfg.n_heads // size
            layer.attn.n_kv_heads = self.n_kv_heads

    @classmethod
    def from_params(cls, cfg, params, device=None, *, mesh=None, rules=None,
                    paged_attention_fn=None, attention_fn=None):
        """A model whose weights ARE the tensors of ``params`` (a state
        dict with this model's keys), moved to ``device`` and cast to
        each weight's dtype where they differ — no other copy. Raises
        on a missing, unexpected or mis-shaped entry. With a
        tensor-parallel or ZeRO-3 ``mesh``, ``params`` is the whole state
        dict and the model takes this rank's slice of it, its ``model``
        and its ``fsdp`` block alike
        (:func:`~sparkdl_tpu_torch.parallel.sharding.shard_params`)."""
        device = resolve_device(device)
        model = cls(cfg, device="meta", mesh=mesh, rules=rules,
                    paged_attention_fn=paged_attention_fn,
                    attention_fn=attention_fn)
        return megatron.load_params(model, model.local_params(params),
                                    device)

    def local_params(self, params):
        """This rank's slice of the whole state dict (or flat JAX tree)
        ``params`` by :attr:`tp_specs`; ``params`` itself for a model
        that is neither tensor-parallel nor ZeRO-3."""
        return megatron.local_params(self, params)

    @property
    def device(self):
        return self.embed.embedding.device

    def head_kernel(self):
        """The head's (d_model, V) kernel as this rank computes with it
        (its vocabulary block under tensor parallelism), gathered whole
        over ``fsdp`` under ZeRO-3 (the top-level unit, differentiable)."""
        if self.zero3 is not None and self.zero3.has("top", self.lm_head):
            return self.zero3.gather("top")[self.lm_head, "kernel"]
        return self.lm_head.kernel

    def _block(self, i, layer, *args, hooks=True):
        return megatron.run_block(self.zero3, i, layer, *args, hooks=hooks)

    def init_cache(self, batch=None):
        """A zeroed cache for this decode config, on the model's device:
        a :class:`PagedKVCache` when ``cfg.page_size > 0`` (shared by
        every row, so no ``batch``), else a :class:`DenseKVCache` of
        ``batch`` rows at shared index 0."""
        cfg = self.cfg
        if not cfg.decode:
            raise ValueError("init_cache needs a decode config "
                             "(decode=True)")
        hd = cfg.d_model // cfg.n_heads
        if cfg.page_size:
            if not cfg.n_pages:
                raise ValueError("the paged cache needs n_pages > 0")
            if batch is not None:
                raise ValueError("the paged cache is shared by every row; "
                                 "batch sizes the dense slot cache only")
            shape = (cfg.n_layers, cfg.n_pages, cfg.page_size,
                     self.n_kv_heads, hd)
            return PagedKVCache(
                k=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                v=torch.zeros(shape, dtype=cfg.dtype, device=self.device))
        if batch is None or batch < 1:
            raise ValueError("the dense slot cache needs batch >= 1")
        shape = (cfg.n_layers, batch, cfg.max_cache_len, self.n_kv_heads, hd)
        return DenseKVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def _rope_tables(self, device, length):
        """cos/sin tables of ``length`` positions, kept per device for the
        longest length asked so far (a prefix of a longer table is the
        shorter one). A traced step's (``meta``) are made anew, never
        kept."""
        if device.type == "meta":
            cfg = self.cfg
            return rope_freqs(cfg.d_model // cfg.n_heads, length,
                              cfg.rope_theta, cfg.rope_scaling, device=device)
        tables = self._rope.get(device)
        if tables is None or tables[0].shape[0] < length:
            cfg = self.cfg
            tables = rope_freqs(cfg.d_model // cfg.n_heads, length,
                                cfg.rope_theta, cfg.rope_scaling,
                                device=device)
            self._rope[device] = tables
        return tables

    def forward(self, tokens, positions=None, block_tables=None, cache=None,
                return_hidden=False, adapter_ids=None,
                return_intermediates=False):
        """Logits (B, S, vocab) in fp32 for tokens (B, S).

        Training (``cfg.decode`` False): the whole sequence at positions
        ``0..S-1`` (or ``positions``, (S,) or (B, S)), no cache.
        Serving (``cfg.decode``): the tokens' K/V written into ``cache``
        (:meth:`init_cache`) and attended over. Paged
        (``cfg.page_size > 0``): tokens at explicit positions (B, S)
        through the rows' block tables (B, max_pages). Dense slot
        cache: at explicit positions (B,) or (B, S), each row at its
        own, or, with ``positions`` None, at the cache's shared index,
        which then advances by S.

        ``return_hidden=True`` returns the final-norm hidden states
        (B, S, d_model) instead, the input of
        :func:`sparkdl_tpu_torch.parallel.train.fused_cross_entropy`.
        ``adapter_ids`` (B,): each row's adapter of a multi-LoRA model
        (``cfg.multi_lora``); adapter 0 when omitted.

        ``return_intermediates=True`` returns ``(out, intermediates)``,
        the counterpart of the JAX ``apply(..., mutable=["intermediates"])``:
        ``{"layer_<i>": {"moe_mlp": {"router_probs": (probs,)}}}`` for
        each MoE layer (empty for a dense model), recorded once a layer
        under ``cfg.remat`` too, with its graph kept, so
        :func:`~sparkdl_tpu_torch.models.moe.moe_aux_loss` of it
        reaches the routers."""
        cfg = self.cfg
        b, s = tokens.shape
        if adapter_ids is not None:
            if not cfg.multi_lora:
                raise ValueError("adapter_ids requires a multi_lora model "
                                 "(LlamaConfig.multi_lora > 0)")
            adapter_ids = torch.as_tensor(adapter_ids,
                                          device=tokens.device).long()
            if tuple(adapter_ids.shape) != (b,):
                raise ValueError(f"adapter_ids must be ({b},), got "
                                 f"{tuple(adapter_ids.shape)}")
        elif cfg.multi_lora:
            adapter_ids = torch.zeros((b,), dtype=torch.long,
                                      device=tokens.device)
        if cfg.decode:
            if cache is None:
                raise ValueError("decode needs a cache (model.init_cache())")
            if s > cfg.max_cache_len:
                raise ValueError(
                    f"sequence {s} exceeds max_cache_len {cfg.max_cache_len}")
            if cfg.page_size:
                if positions is None or block_tables is None:
                    raise ValueError("paged decode needs explicit positions "
                                     "and block_tables")
            elif block_tables is not None:
                raise ValueError("block_tables belong to the paged cache "
                                 "(page_size > 0)")
            elif positions is None:
                start = cache.index
                if start + s > cfg.max_cache_len:
                    raise ValueError(
                        f"cache index {start} + {s} tokens exceeds "
                        f"max_cache_len {cfg.max_cache_len}")
                positions = torch.arange(start, start + s,
                                         device=tokens.device)
                cache.index = start + s
            length = cfg.max_cache_len
        else:
            if block_tables is not None or cache is not None:
                raise ValueError(
                    "block_tables and cache belong to the decode path "
                    "(decode=True); the training forward takes tokens "
                    "(and positions) only")
            # the table covers training (seq s) and cached decoding, and
            # the largest position asked for: a sequence shard's
            # positions start at its offset
            length = max(s, cfg.max_cache_len)
            if positions is None:
                positions = torch.arange(s, device=tokens.device)
            else:
                positions = torch.as_tensor(positions, device=tokens.device)
                length = max(length, int(positions.max()) + 1)
        positions = torch.as_tensor(positions, device=tokens.device).long()
        if positions.ndim == 1 and positions.shape[0] == b and s == 1 \
                and cfg.decode:
            positions = positions[:, None]  # slot-mapped (B,): one a row
        positions = positions.expand(b, s)
        cos, sin = self._rope_tables(tokens.device, length)
        zero3, top = self.zero3, {}
        if zero3 is not None:
            zero3.release()
            if zero3.has("top", self.embed):
                top = zero3.gather("top")
        with bound(top):
            x = self.embed(tokens.long())
        if self.embed.tp_split:
            x = gathered(x, self.tp.mesh, "model")
        intermediates = {}
        for i, layer in enumerate(self.layers):
            record = None
            if return_intermediates and layer.use_moe:
                # the recompute of a checkpointed block finds it filled
                record = {}
                intermediates[f"layer_{i}"] = {"moe_mlp": record}
            if cfg.decode:
                x = self._block(i, layer, x, cos, sin, positions,
                                block_tables, cache.k[i], cache.v[i],
                                adapter_ids, record)
            elif cfg.remat and torch.is_grad_enabled():
                # the recompute gathers the block's weights again
                x = torch.utils.checkpoint.checkpoint(
                    self._block, i, layer, x, cos, sin, positions, None,
                    None, None, adapter_ids, record, hooks=False,
                    use_reentrant=False)
            else:
                x = self._block(i, layer, x, cos, sin, positions, None,
                                None, None, adapter_ids, record)
        if zero3 is not None and not top and zero3.has("top") and (
                not return_hidden or zero3.has("top", self.final_norm)):
            top = zero3.gather("top")
        with bound(top):
            x = self.final_norm(x)
            if not return_hidden:
                x = tp_call(self.lm_head, x.to(torch.float32), self.tp)
        return (x, intermediates) if return_intermediates else x


def init_weights(model, generator, std=0.02):
    """Fill ``model``'s weights in place with random values drawn from
    ``generator`` (a ``torch.Generator`` on the model's device): every
    projection, the embedding, the head and ``lora_a`` normal(0, std),
    ``lora_b`` and the MoE routers' ``bias`` zeros and the norm scales
    ones (the JAX LoRA init, with normal(std) in place of the base
    projections' and the stacked experts' lecun-normal).
    Returns ``model``. Dense models only: a quantized model is built
    from a dense state dict
    (:func:`~sparkdl_tpu_torch.models.quant.quantize_llama_params`)."""
    if model.cfg.quant:
        raise ValueError("init_weights fills dense weights; quantize a dense "
                         "state dict for a quantized model")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf in ("lora_b", "bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
    return model
