"""HuggingFace Llama checkpoint ↔ the port's Llama state dict.

Counterpart of ``sparkdl_tpu/models/convert.py``. ``params_from_hf``
maps a ``transformers`` ``LlamaForCausalLM`` state dict onto the names
``Llama(cfg).state_dict()`` uses (``embed.embedding``,
``layers.<i>.attn.q_proj.kernel``, ...), so ``Llama.from_params``,
``model.load_state_dict`` and
:func:`~sparkdl_tpu_torch.models.quant.quantize_llama_params` take it
directly; ``config_from_hf`` derives the matching
:class:`~sparkdl_tpu_torch.models.llama.LlamaConfig`, and
``params_to_hf`` is the way back. The architectures agree convention
for convention (half-split RoPE, SwiGLU gate/up/down, pre-norm RMS,
GQA), so conversion is renaming plus the transpose of every projection:
torch's ``Linear`` weight is (out, in), the port's kernel (in, out).
A ``tie_word_embeddings`` checkpoint has no ``lm_head.weight``; the
embedding is the head.

The conversion works tensor by tensor in torch, on each tensor's own
device (a Llama-3-8B state dict on the card never visits the host);
nothing here imports ``transformers``. It is as strict as the JAX
version: a tensor the mapping does not consume raises.
"""

import torch

from sparkdl_tpu_torch.models.llama import LlamaConfig

# buffers some checkpoints carry that hold no weight
_HARMLESS = ("rotary_emb.inv_freq", "position_ids")
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def config_from_hf(hf_config, **overrides):
    """LlamaConfig from a ``transformers.LlamaConfig`` (or any object
    with the same attribute names). ``linear`` and ``llama3``
    ``rope_scaling`` are translated; any other kind raises
    NotImplementedError (a plain-RoPE conversion of a rescaled
    checkpoint would be silently wrong at long context)."""
    scaling = getattr(hf_config, "rope_scaling", None)
    rope_scaling = None
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind == "linear":
            rope_scaling = ("linear", float(scaling["factor"]))
        elif kind == "llama3":
            rope_scaling = (
                "llama3", float(scaling["factor"]),
                float(scaling["low_freq_factor"]),
                float(scaling["high_freq_factor"]),
                int(scaling["original_max_position_embeddings"]),
            )
        else:
            raise NotImplementedError(
                f"rope_scaling={scaling!r} is not supported; a "
                "plain-RoPE conversion of a rescaled checkpoint would "
                "be silently wrong")
    kw = dict(
        rope_scaling=rope_scaling,
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rms_eps=float(getattr(hf_config, "rms_norm_eps", 1e-6)),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _tensor(w):
    """A state dict's value (a torch tensor, or an array) as a tensor,
    no copy."""
    return torch.as_tensor(w).detach()


def _kernel(w, dtype):
    """A torch (out, in) weight as the port's (in, out) kernel."""
    return _tensor(w).to(dtype).t().contiguous()


def _scale(w):
    return _tensor(w).to(torch.float32)


def params_from_hf(state_dict, cfg, dtype=torch.float32):
    """The port's Llama state dict from an HF Llama one (``model.
    state_dict()`` of a ``LlamaForCausalLM``: ``model.embed_tokens.
    weight``, ...). Every kernel, the head included (from
    ``lm_head.weight`` or, tied, from the embedding), and the embedding
    are cast to ``dtype`` (default fp32, as the JAX version; pass
    ``torch.bfloat16`` for serving); the norm scales are fp32. Each
    tensor stays on its device. Raises ValueError on a tensor the
    mapping does not consume (an attention bias, an adapter), which a
    conversion that dropped it would make silently wrong."""
    sd = state_dict
    consumed = {"model.embed_tokens.weight", "model.norm.weight"}
    params = {"embed.embedding":
              _tensor(sd["model.embed_tokens.weight"]).to(dtype)}
    for i in range(cfg.n_layers):
        hf, ours = f"model.layers.{i}", f"layers.{i}"
        for name in _ATTN:
            key = f"{hf}.self_attn.{name}.weight"
            params[f"{ours}.attn.{name}.kernel"] = _kernel(sd[key], dtype)
            consumed.add(key)
        for name in _MLP:
            key = f"{hf}.mlp.{name}.weight"
            params[f"{ours}.mlp.{name}.kernel"] = _kernel(sd[key], dtype)
            consumed.add(key)
        for ours_norm, hf_norm in (("attn_norm", "input_layernorm"),
                                   ("mlp_norm", "post_attention_layernorm")):
            key = f"{hf}.{hf_norm}.weight"
            params[f"{ours}.{ours_norm}.scale"] = _scale(sd[key])
            consumed.add(key)
    params["final_norm.scale"] = _scale(sd["model.norm.weight"])
    if "lm_head.weight" in sd:
        params["lm_head.kernel"] = _kernel(sd["lm_head.weight"], dtype)
        consumed.add("lm_head.weight")
    else:  # tie_word_embeddings
        params["lm_head.kernel"] = _kernel(sd["model.embed_tokens.weight"],
                                           dtype)
    leftover = [k for k in sd
                if k not in consumed and not k.endswith(_HARMLESS)]
    if leftover:
        raise ValueError(
            f"unmapped weights in the HF state dict: {leftover[:6]}"
            f"{'...' if len(leftover) > 6 else ''} — this checkpoint "
            "carries tensors (biases? adapters?) the conversion would "
            "silently drop")
    return params


def params_to_hf(params, cfg, dtype=None):
    """Inverse of :func:`params_from_hf`: an HF Llama state dict (torch
    tensors on each tensor's device) from the port's dense state dict
    (``model.state_dict()``; merge LoRA adapters first), for
    ``LlamaForCausalLM.load_state_dict``. ``dtype`` casts every tensor
    (default: each keeps its own)."""
    def w(t):
        t = _tensor(t)
        return t if dtype is None else t.to(dtype)

    def linear(t):
        return w(t).t().contiguous()

    sd = {"model.embed_tokens.weight": w(params["embed.embedding"]),
          "model.norm.weight": w(params["final_norm.scale"]),
          "lm_head.weight": linear(params["lm_head.kernel"])}
    for i in range(cfg.n_layers):
        hf, ours = f"model.layers.{i}", f"layers.{i}"
        for name in _ATTN:
            sd[f"{hf}.self_attn.{name}.weight"] = linear(
                params[f"{ours}.attn.{name}.kernel"])
        for name in _MLP:
            sd[f"{hf}.mlp.{name}.weight"] = linear(
                params[f"{ours}.mlp.{name}.kernel"])
        sd[f"{hf}.input_layernorm.weight"] = w(
            params[f"{ours}.attn_norm.scale"])
        sd[f"{hf}.post_attention_layernorm.weight"] = w(
            params[f"{ours}.mlp_norm.scale"])
    return sd
