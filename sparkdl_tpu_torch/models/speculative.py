"""Speculative decoding: a cheap DRAFT model proposes k tokens, the
target model verifies them in ONE forward, and the longest agreeing
prefix is accepted — greedy outputs are exactly the target model's own
greedy decode, whatever the draft.

Counterpart of ``sparkdl_tpu/models/speculative.py``. The natural draft
is the int8 (or int4) weights of the same model: a decode step is bound
by its weight bytes, and by the host's launches, which a round pays once
for up to k+1 tokens. Rejected speculation rewinds both dense caches by
setting their shared index back (:func:`set_cache_index`): a forward
writes a position before it attends to it, and the mask hides every
row past a query's position, so the stale rows beyond the index are
never read and are overwritten by the next round.

Differences from the JAX module: ``k`` defaults to 4 (the JAX package
reads an environment knob first); the rounds run as Python loops over
forwards whose state stays on the device, with one host copy of the
proposals and the target's choices a round.
"""

import numpy as np
import torch

from sparkdl_tpu_torch.models.generate import decode_twin
from sparkdl_tpu_torch.ops._dispatch import resolve_device

# the draft length a verify round proposes when the caller passes no k
# (the JAX package's SPARKDL_TPU_SPEC_DRAFT_K), read at call time
DEFAULT_K = 4


def set_cache_index(cache, idx):
    """Rewind (or advance) a dense slot cache's shared index to ``idx``;
    returns the cache. Stale K/V rows beyond it are harmless: the
    decode path writes a position before attending to it."""
    cache.index = int(idx)
    return cache


def _check_scratch(p_len, max_new_tokens, k, max_cache_len):
    # + k scratch: the last verify writes up to k positions past the
    # final accepted token
    if p_len + max_new_tokens + k > max_cache_len:
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) + k "
            f"({k}) speculation scratch exceeds max_cache_len "
            f"({max_cache_len}); raise max_cache_len or lower k")


def speculative_generate(model, params, draft_params, prompt_tokens, *,
                         max_new_tokens=32, k=None, draft_model=None,
                         eos_id=None, device=None):
    """Greedy generation with draft-model speculation. Returns
    ``(tokens, stats)``: tokens exactly as
    :func:`~sparkdl_tpu_torch.models.generate.generate` (greedy) would
    produce them, (batch, prompt_len + n) int32, and ``stats`` =
    {"rounds", "proposed", "accepted"}. The whole batch accepts in
    lockstep: a round keeps the longest prefix on which every row
    agrees.

    ``params`` / ``draft_params``: state dicts of ``model`` and of
    ``draft_model`` (default: the target architecture, e.g. int8
    weights of the same model with ``draft_model`` an int8 config's
    model). ``k``: tokens proposed a round (default 4). Runs on
    ``device`` (default CUDA)."""
    k = DEFAULT_K if k is None else int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int64),
                             device=device)
    b, p_len = prompt.shape
    L = model.cfg.max_cache_len
    _check_scratch(p_len, max_new_tokens, k, L)
    target = decode_twin(model, params, device)
    d_model = draft_model if draft_model is not None else model
    draft = decode_twin(d_model, draft_params, device,
                        max_cache_len=max(d_model.cfg.max_cache_len, L))
    stats = {"rounds": 0, "proposed": 0, "accepted": 0}
    with torch.no_grad():
        cache = target.init_cache(batch=b)
        d_cache = draft.init_cache(batch=b)
        # both caches hold the prompt; the draft's logits are discarded
        token = torch.argmax(target(prompt, cache=cache)[:, -1], -1)
        draft(prompt, cache=d_cache)
        new = [token.cpu().numpy()]  # list of (B,) accepted tokens
        n_new = 1
        pos = p_len  # both caches sit at this index
        while n_new < max_new_tokens:
            set_cache_index(d_cache, pos)
            tok, props = token, []
            for _ in range(k):
                tok = torch.argmax(draft(tok[:, None], cache=d_cache)[:, -1],
                                   -1)
                props.append(tok)
            # a logits-discarded step writes the last proposal's K/V, so
            # a fully accepted round leaves the draft cache whole
            draft(tok[:, None], cache=d_cache)
            proposals = torch.stack(props, 1)                   # (B, k)
            set_cache_index(cache, pos)
            seq = torch.cat([token[:, None], proposals], 1)
            greedy = torch.argmax(target(seq, cache=cache), -1)  # (B, k+1)
            prop = proposals.cpu().numpy()
            g = greedy.cpu().numpy()
            # the longest prefix on which the draft matched the target,
            # over the whole batch
            agree = (prop == g[:, :k]).all(axis=0)
            m = int(np.argmin(agree)) if not agree.all() else k
            # accepted proposals + the target's own next token
            step_tokens = [prop[:, i] for i in range(m)] + [g[:, m]]
            stats["rounds"] += 1
            stats["proposed"] += k
            stats["accepted"] += m
            take = min(len(step_tokens), max_new_tokens - n_new)
            new.extend(step_tokens[:take])
            n_new += take
            token = torch.as_tensor(step_tokens[take - 1], device=device)
            pos = pos + m + 1
            if eos_id is not None:
                arr = np.stack(new[-take:], axis=1)
                hit = np.nonzero((arr == eos_id).all(axis=0))[0]
                if hit.size:
                    overshoot = take - (int(hit[0]) + 1)
                    if overshoot:
                        del new[len(new) - overshoot:]
                    break
    toks = torch.as_tensor(np.stack(new, axis=1).astype(np.int32),
                           device=device)
    return torch.cat([prompt.to(torch.int32), toks], 1), stats


def assemble_round(proposals, m, final):
    """Pack a speculation round's output: row b's tokens are
    ``proposals[b, :m[b]]`` then ``final[b]`` (bonus or correction),
    padded with zeros; returns (tokens (B, k+1) int32, counts = m + 1).
    One definition for the greedy and the sampling acceptance."""
    b, k = proposals.shape
    idx = torch.arange(k + 1, device=proposals.device)[None]
    padded = torch.nn.functional.pad(proposals, (0, 1))
    m = m.to(torch.long)
    tokens = torch.where(
        idx < m[:, None], padded,
        torch.where(idx == m[:, None], final[:, None].to(padded.dtype),
                    torch.zeros_like(padded)))
    return tokens.to(torch.int32), m + 1


def spec_acceptance(q_probs, p_probs, proposals):
    """The rejection scheme's probabilities: ``(accept (B, k), residual
    (B, k, V))``. Proposal x at step i is accepted with probability
    min(1, p_i(x) / q_i(x)); a rejection at step i resamples from the
    residual max(p_i - q_i, 0), normalised. Over x ~ q_i that makes the
    step's output exactly p_i (Leviathan et al.)."""
    k = q_probs.shape[1]
    px = torch.gather(p_probs[:, :k], -1, proposals[..., None].long())[..., 0]
    qx = torch.gather(q_probs, -1, proposals[..., None].long())[..., 0]
    accept = torch.clamp(px / torch.clamp(qx, min=1e-30), max=1.0)
    resid = torch.clamp(p_probs[:, :k] - q_probs, min=0.0)
    # an all-zero residual has probability 0 (it needs p <= q
    # everywhere, which makes rejection impossible); the floor only
    # guards the division
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-30)
    return accept, resid


def spec_sample_tokens(q_probs, p_probs, proposals, generator=None):
    """Distribution-exact speculative accept / resample (the sampling
    counterpart of the greedy longest-agreeing-prefix rule).

    ``q_probs`` (B, k, V): the draft's distributions at each proposal
    step; ``p_probs`` (B, k+1, V): the target's at the k+1 verified
    positions; ``proposals`` (B, k): the tokens the draft sampled from
    ``q_probs``; ``generator``: the ``torch.Generator`` of the draws.
    Returns ``(tokens (B, k+1), counts (B,))``: row b's first
    ``counts[b]`` tokens are the round's output — the accepted
    proposals, then one token resampled from the residual at the first
    rejection or, when all k are accepted, the bonus drawn from the
    k+1-th target distribution (:func:`spec_acceptance`)."""
    b, k, _v = q_probs.shape
    accept_p, resid = spec_acceptance(q_probs, p_probs, proposals)
    u = torch.rand((b, k), generator=generator, device=q_probs.device)
    # u < p(x) / q(x), as the JAX package's u * q(x) < p(x)
    accept = u < accept_p
    all_acc = accept.all(-1)
    m = torch.where(all_acc, torch.full_like(all_acc, k, dtype=torch.long),
                    torch.argmin(accept.to(torch.int32), -1))
    mc = torch.clamp(m, max=k - 1)
    rows = torch.arange(b, device=q_probs.device)
    # the residual at the first rejection (clamped for the gather;
    # unused on full acceptance, where an all-zero row is drawn from p
    # instead, which multinomial requires)
    r = resid[rows, mc]
    r = torch.where(r.sum(-1, keepdim=True) > 0, r, p_probs[rows, mc])
    resampled = torch.multinomial(r, 1, generator=generator)[:, 0]
    bonus = torch.multinomial(p_probs[:, k], 1, generator=generator)[:, 0]
    final = torch.where(all_acc, bonus, resampled)
    return assemble_round(proposals.to(torch.long), m, final)
