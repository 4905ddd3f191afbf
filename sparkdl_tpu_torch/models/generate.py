"""Autoregressive generation for the decoder: a prefill, then cached
decode steps over the dense slot cache, greedy or temperature sampling
restricted by top-k / top-p.

Counterpart of ``sparkdl_tpu/models/generate.py`` (the sampling
definitions the serving engines share, and ``generate``). The JAX
package runs the decode loop as one compiled scan; here it is a Python
loop whose state stays on the device, with no host copy until the end
(one a step only when ``eos_id`` asks for the early stop). A
``torch.Generator`` on the logits' device stands in for the jax PRNG
key; the two give different draws from one seed, so the tests compare
greedy decoding and hold sampled output to distributions.
"""

import dataclasses

import numpy as np
import torch

from sparkdl_tpu_torch.ops._dispatch import resolve_device

NEG_INF = -1e30


def restrict_logits(logits, *, top_k=0, top_p=1.0):
    """Mask (..., V) TEMPERATURE-SCALED logits down to the sampling
    support: ``top_k`` keeps the k largest, ``top_p`` keeps the minimal
    sorted prefix whose mass reaches p (the top token always
    survives)."""
    l = logits.to(torch.float32)
    if top_k:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, NEG_INF, l)
    if top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        # keep entries whose cumulative mass BEFORE them is < p
        before = torch.cumsum(probs, dim=-1) - probs
        keep = before < top_p
        cutoff = torch.where(keep, sorted_l, torch.inf).amin(
            dim=-1, keepdim=True)
        l = torch.where(l < cutoff, NEG_INF, l)
    return l


def sample_logits(logits, generator=None, *, temperature, top_k=0,
                  top_p=1.0):
    """One sampling step over (..., V) logits: greedy at temperature 0,
    else temperature-scaled categorical restricted by
    :func:`restrict_logits`."""
    return sample_logits_with_lp(logits, generator, temperature=temperature,
                                 top_k=top_k, top_p=top_p)[0]


def sample_logits_with_lp(logits, generator=None, *, temperature, top_k=0,
                          top_p=1.0):
    """(token int32, logprob fp32): one sampling step plus the chosen
    token's logprob under the distribution actually sampled — the
    restricted temperature-scaled one (greedy reports the raw softmax
    logprob)."""
    if temperature == 0.0:
        tok = torch.argmax(logits, dim=-1)
        lp_all = torch.log_softmax(logits.to(torch.float32), dim=-1)
    else:
        l = restrict_logits(logits.to(torch.float32) / temperature,
                            top_k=top_k, top_p=top_p)
        probs = torch.softmax(l, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        tok = torch.multinomial(flat, 1, generator=generator).reshape(
            probs.shape[:-1])
        lp_all = torch.log_softmax(l, dim=-1)
    lp = torch.gather(lp_all, -1, tok[..., None])[..., 0]
    return tok.to(torch.int32), lp


def decode_twin(model, params, device, **cfg_kw):
    """A decode-mode model over ``params`` (a state dict with
    ``model``'s keys; None: ``model``'s own weights) on ``device``, with
    the dense slot cache (``page_size`` 0) and ``cfg_kw`` replaced in
    ``model``'s config; the tensors are shared, not copied, where their
    device and dtype already match."""
    from sparkdl_tpu_torch.models.llama import Llama

    cfg = dataclasses.replace(model.cfg, decode=True, page_size=0,
                              n_pages=0, **cfg_kw)
    if params is None:
        params = model.state_dict()
    return Llama.from_params(cfg, params, device)


def generate(model, params, prompt_tokens, *, max_new_tokens=32,
             temperature=0.0, top_k=0, top_p=1.0, generator=None,
             eos_id=None, return_logprobs=False, device=None):
    """Generate continuations of ``prompt_tokens`` (batch, prompt_len).

    ``model`` gives the config (a training or decode config: the
    decode-mode twin over the dense slot cache is derived, sharing the
    weights); ``params`` is a state dict with its keys (None: the
    model's own). ``top_k`` / ``top_p`` restrict temperature sampling
    (``temperature > 0``) as in :func:`restrict_logits`; ``generator``,
    a ``torch.Generator`` on ``device``, drives the draws (the JAX
    ``rng``). With ``eos_id`` the output is cut after the first decode
    step in which every row emitted it (the prefill token is exempt).
    Runs on ``device`` (default CUDA).

    Returns the (batch, prompt_len + n) int32 tokens, n <=
    ``max_new_tokens``; with ``return_logprobs`` a ``(tokens,
    logprobs)`` pair, the (batch, n) logprobs of the generated tokens
    under the distribution actually sampled."""
    device = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int64)
                             if not torch.is_tensor(prompt_tokens)
                             else prompt_tokens, device=device).long()
    b, p_len = prompt.shape
    cfg = model.cfg
    if p_len + max_new_tokens > cfg.max_cache_len:
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_cache_len ({cfg.max_cache_len}); raise "
            "LlamaConfig.max_cache_len")
    dec = decode_twin(model, params, device)

    def step(logits):
        return sample_logits_with_lp(logits[:, -1], generator,
                                     temperature=float(temperature),
                                     top_k=int(top_k), top_p=float(top_p))

    with torch.no_grad():
        cache = dec.init_cache(batch=b)
        token, lp = step(dec(prompt, cache=cache))
        toks, lps = [token], [lp]
        for _ in range(max_new_tokens - 1):
            token, lp = step(dec(token[:, None], cache=cache))
            toks.append(token)
            lps.append(lp)
            if eos_id is not None and bool((token == eos_id).all()):
                break  # every row ended on this loop step
    out = torch.cat([prompt.to(torch.int32), torch.stack(toks, 1)], dim=1)
    if return_logprobs:
        return out, torch.stack(lps, 1)
    return out
