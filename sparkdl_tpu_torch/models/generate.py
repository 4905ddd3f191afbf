"""Sampling for the decoder: greedy, or temperature sampling restricted
by top-k / top-p.

Counterpart of ``sparkdl_tpu/models/generate.py:21-75`` (the sampling
definitions the serving engine uses). A ``torch.Generator`` on the
logits' device stands in for the jax PRNG key; the two give different
draws from one seed, so the tests compare greedy decoding.
"""

import torch

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
