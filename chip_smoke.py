#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version at the main paths' shapes, serve
Llama-3-8B at full width (random int8 weights, paged KV cache) through
``ContinuousBatchingEngine``, then LoRA-fine-tune it at full width
through ``make_train_step``, and show both runs went through their
kernels.

    python3 chip_smoke.py [--report PATH]

Needs one CUDA card (sm_90a) and ``nvcc``; exits nonzero without them
and on any failed check. Phases:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
1. build every ``sparkdl_tpu_torch/ops/csrc/*.cu`` (one nvcc each, all
   started together);
2. the serving kernels against their plain versions on the card at the
   shapes one decode step (and a prefill) gives them, timed with CUDA
   events (L2 flushed between runs, median of 25) beside the bound
   computed from bytes or operations, and ``torch._weight_int8pack_mm``
   timed beside the int8 matmul as its library yardstick;
3. serving at full width: 16 requests (prompts 64-1024 tokens, budgets
   32-128, greedy) through 8 slots, pages of 64; every request must end
   on its full budget, and the launch counters, zeroed just before the
   run, must equal what the engine's own step and prefill counts
   predict;
4. the kernel path against the plain path at model level: the same
   weights at depth 2 (full width), one prefill and 4 decode steps;
   then the serving model is freed;
2b. the three flash-attention kernels (forward, dq, dk/dv) against
   their plain versions at the training shape (B 2, S 2048, H 32,
   D 128, causal) and at a ragged S of 1000 (causal and not, D 128 and
   64), timed at the training shape beside their bounds and beside
   ``scaled_dot_product_attention`` (forward, and its backward against
   dq + dk/dv);
5. LoRA fine-tuning at full width (Llama-3-8B, rank 16 on q and v,
   flash attention, random bf16 weights): batch 2 x 2048, AdamW on the
   adapters, one warm-up step and 5 timed ones; the loss must fall, the
   adapters move, a frozen matrix stay bit-identical, and each flash
   counter, zeroed after the warm-up, read 32 x 5; then one more step
   under ``torch.profiler`` (device time by kernel, idle share);
6. the kernel path against the plain path for one training step at
   depth 2 (full width, batch 1 x 2048): loss and every adapter
   gradient;
6b. the peak memory of one train step at depth 2 (batch 2 x 2048)
   without remat, with the step's ``remat=True`` and with
   ``cfg.remat``; the three losses must be bit-identical.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
carry the kernels' record (``{"kernels": [...]}``) and the card.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

SEED = 0
TIMED_RUNS = 25

DEVICE = "cuda"
N_REQUESTS = 16

# qmm shapes of ONE decode step at Llama-3-8B width with 8 slots:
# (M, K, N, x dtype, calls per decode step, calls are per layer) — per
# layer q and o (4096 -> 4096), k and v (4096 -> 1024), gate and up
# (4096 -> 14336), down (14336 -> 4096); then the lm_head on fp32
# activations; last, one prefill shape (a 512-token bucket)
QMM_SHAPES = [(8, 4096, 4096, "bf16", 2, True),
              (8, 4096, 1024, "bf16", 2, True),
              (8, 4096, 14336, "bf16", 2, True),
              (8, 14336, 4096, "bf16", 1, True),
              (8, 4096, 128256, "fp32", 1, False),
              (512, 4096, 14336, "bf16", 0, False)]

# flash shapes (B, S, H, D, causal): the training step's (one layer's
# call; 32 a step), then ragged S (no tile divides 1000), both head dims
FLASH_SHAPES = [(2, 2048, 32, 128, True),
                (1, 1000, 4, 128, True),
                (1, 1000, 4, 128, False),
                (1, 1000, 4, 64, True)]

# the training phase: batch x seq tokens a step, warm-up + timed steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 5


class CheckFailed(RuntimeError):
    pass


def _require(ok, what):
    if not ok:
        raise CheckFailed(what)


def _log(msg):
    print(msg, flush=True)


def _card_line(torch):
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _bf16_ulp(torch, x):
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


class Timer:
    """Median device time of a callable over TIMED_RUNS runs, CUDA
    events around each, the 50 MB L2 flushed before each (a decode step
    finds its weights cold: they are far larger than L2). The stream
    sleeps ~2 ms before each run, so the host has enqueued the whole
    call before the start event fires: the events time the device's
    work, not the host's Python (which ``host_us`` measures)."""

    SLEEP_CYCLES = 4_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def host_us(self, fn, calls=50):
        """Host time to issue one call, the device kept ahead of it."""
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        spent = time.perf_counter() - t
        torch.cuda.synchronize()
        return 1e6 * spent / calls

    def ms(self, fn, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(TIMED_RUNS):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def int8pack_ms(torch, timer, x, w_q, scales):
    """The library yardstick of the int8 matmul: one
    ``torch._weight_int8pack_mm`` call (bf16 x, int8 (N, K) weight, bf16
    scales: its scales round to bf16, ours stay fp32), timed on the
    card; (None, reason) where this torch has no CUDA kernel for it. It
    is never on the port's path."""
    xb = x.bfloat16()
    w_t = w_q.t().contiguous()
    sb = scales.bfloat16()
    try:
        torch._weight_int8pack_mm(xb, w_t, sb)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return timer.ms(lambda: torch._weight_int8pack_mm(xb, w_t, sb)), ""


def check_quantized_matmul(torch, timer, gen):
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    rows = []
    for m, k, n, xname, calls, per_layer in QMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=DEVICE).to(
            dtypes[xname])
        w_q = torch.randint(-127, 128, (k, n), generator=gen,
                            device=DEVICE, dtype=torch.int8)
        scales = torch.rand((n,), generator=gen, device=DEVICE) * 1e-2 \
            + 1e-4
        out = qmm.quantized_matmul(x, w_q, scales)
        ref = qmm.quantized_matmul_reference(x, w_q, scales)
        torch.cuda.synchronize()
        # tolerance: the two sum K fp32 products in different orders (at
        # most 1e-5 of the sum of |terms|, far above fp32's order-change
        # error at these K), and a bf16 output may land one ulp apart
        mag = x.float().abs() @ (w_q.float().abs() * scales)
        err = (out.float() - ref.float()).abs()
        tol = 1e-5 * mag + (_bf16_ulp(torch, ref.float())
                            if xname == "bf16" else 1e-6 * ref.abs())
        bad = int((err > tol).sum())
        _require(bad == 0 and bool(torch.isfinite(out).all()),
                 f"quantized_matmul ({m}, {k}, {n}) {xname}: {bad} "
                 f"elements beyond tolerance, max err {err.max().item()}")
        xb = x.element_size()
        nbytes = k * n + 4 * n + m * k * xb + m * n * xb
        flops = 2 * m * k * n
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[xname])
        row = {
            "shape": [m, k, n], "x": xname,
            "calls_per_decode_step": calls, "per_layer": per_layer,
            "max_abs_err": err.max().item(),
            "ms": timer.ms(lambda: qmm.quantized_matmul(x, w_q, scales)),
            "plain_ms": timer.ms(
                lambda: qmm.quantized_matmul_reference(x, w_q, scales)),
            "host_us": timer.host_us(
                lambda: qmm.quantized_matmul(x, w_q, scales)),
            "bound_ms": bound * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_FLOPS[xname] else "operations"),
        }
        row["library_ms"], row["library_missing"] = int8pack_ms(
            torch, timer, x, w_q, scales)
        _log("qmm " + json.dumps(row))
        rows.append(row)
        del x, w_q, scales, out, ref, mag, err, tol
    return rows


def check_paged_attention(torch, timer, gen):
    from sparkdl_tpu_torch.ops import paged_attention as pa

    b, h, hkv, d, page, max_len = 8, 32, 8, 128, 64, 2048
    max_pages = max_len // page
    n_pages = b * max_pages + 1
    q = torch.randn((b, h, d), generator=gen, device=DEVICE).bfloat16()
    k_pool = torch.randn((n_pages, page, hkv, d), generator=gen,
                         device=DEVICE).bfloat16()
    v_pool = torch.randn((n_pages, page, hkv, d), generator=gen,
                         device=DEVICE).bfloat16()
    # one token, a page boundary, one past it, mid, full, ...; the last
    # row is an inactive slot: every entry on the dump page 0
    lens_h = np.array([1, 64, 65, 300, 1000, 2048, 777, 5], np.int32)
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    tables_h = np.zeros((b, max_pages), np.int32)
    for i in range(b - 1):
        used = -(-int(lens_h[i]) // page)
        tables_h[i, :used] = perm[i * max_pages:i * max_pages + used]
    tables = torch.as_tensor(tables_h, device=DEVICE)
    lens = torch.as_tensor(lens_h, device=DEVICE)
    out = pa.paged_attention_decode(q, k_pool, v_pool, tables, lens)
    ref = pa.paged_attention_decode_reference(q, k_pool, v_pool, tables,
                                              lens)
    # the plain version rounds each probability to bf16 before the PV
    # product (relative error <= 2^-9, allowed 2^-8 of the probability-
    # weighted |v|), and both round the output to bf16 (one ulp)
    weighted_abs = pa.paged_attention_decode_reference(
        q.float(), k_pool.float(), v_pool.float().abs(), tables, lens)
    err = (out.float() - ref.float()).abs()
    tol = 2.0 ** -8 * weighted_abs + _bf16_ulp(torch, ref.float()) + 1e-5
    bad = int((err > tol).sum())
    _require(bad == 0 and bool(torch.isfinite(out).all()),
             f"paged_attention_decode: {bad} elements beyond tolerance, "
             f"max err {err.max().item()}")
    visible = int(lens_h.sum())
    nbytes = (visible * hkv * d * 2 * 2 + 2 * q.numel() * 2
              + tables.numel() * 4 + lens.numel() * 4)
    flops = visible * h * d * 2 * 2
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"])
    row = {
        "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "page": page,
                  "lens": lens_h.tolist()},
        "calls_per_decode_step": 1, "per_layer": True,
        "max_abs_err": err.max().item(),
        "ms": timer.ms(lambda: pa.paged_attention_decode(
            q, k_pool, v_pool, tables, lens)),
        "plain_ms": timer.ms(lambda: pa.paged_attention_decode_reference(
            q, k_pool, v_pool, tables, lens)),
        "host_us": timer.host_us(lambda: pa.paged_attention_decode(
            q, k_pool, v_pool, tables, lens)),
        "bound_ms": bound * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / PEAK_FLOPS["bf16"] else "operations"),
    }
    _log("paged " + json.dumps(row))
    return row


def random_int8_llama(torch, cfg, gen):
    """Llama at ``cfg`` with weights drawn on the card, normal with std
    0.02, each projection quantized to int8 as it is drawn."""
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.ops.quantized_matmul import quantize_int8

    model = Llama(cfg, device=DEVICE)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, _, leaf = name.rpartition(".")
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "embedding":
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=p.device) * 0.02)
            elif leaf == "kernel_q":
                w = torch.randn(p.shape, generator=gen,
                                device=p.device) * 0.02
                w_q, s = quantize_int8(w)
                p.copy_(w_q)
                modules[owner].kernel_scale.copy_(s)
                del w, w_q, s
            elif leaf != "kernel_scale":
                raise CheckFailed(f"unexpected weight {name}")
    return model


def serve(torch, model):
    """Phase 3: the main path, counters zeroed just before the run."""
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
    from sparkdl_tpu_torch.ops import paged_attention as pa
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    cfg = model.cfg
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, device=DEVICE)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(64, 1025, N_REQUESTS)]
    budgets = [int(n) for n in rng.integers(32, 129, N_REQUESTS)]
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]

    # host clocks around the engine's own prefill and decode-chunk calls;
    # both end in a host copy of their tokens, so the device is done
    spent = {"prefill": [], "decode": 0.0}
    prefill_fn, decode_fn = engine._prefill_segment, engine._decode_chunk

    def timed_prefill(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill_fn(*a, **k)
        spent["prefill"].append(time.perf_counter() - t)

    def timed_decode(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_fn(*a, **k)
        spent["decode"] += time.perf_counter() - t
        return out

    engine._prefill_segment, engine._decode_chunk = timed_prefill, timed_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qmm.quantized_matmul.launches = 0
    pa.paged_attention_decode.launches = 0
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = {"quantized_matmul": qmm.quantized_matmul.launches,
                "paged_attention_decode": pa.paged_attention_decode.launches}

    stats = dict(engine.stats)
    for rid, budget in zip(rids, budgets):
        toks = results.get(rid)
        _require(toks is not None and len(toks) == budget,
                 f"request {rid} returned {None if toks is None else len(toks)}"
                 f" tokens, budget {budget}")
        _require(engine.finish_reasons[rid] == "length",
                 f"request {rid} finished on {engine.finish_reasons[rid]}")
        _require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                 f"request {rid}: token outside the vocabulary")
        lps = engine.logprobs[rid]
        _require(bool(np.isfinite(lps).all() and (lps <= 1e-6).all()),
                 f"request {rid}: logprobs not finite and <= 0")
    want = {"paged_attention_decode": cfg.n_layers * stats["steps"],
            "quantized_matmul": (7 * cfg.n_layers + 1)
            * (stats["steps"] + stats["prefill_segments"])}
    for name, n in launches.items():
        _require(n > 0 and n == want[name],
                 f"{name}: {n} launches on the main path, engine counts "
                 f"predict {want[name]}")
    decoded = sum(len(results[r]) for r in rids) - len(rids)
    report = {
        "requests": len(rids), "n_slots": 8, "page_size": 64, "chunk": 16,
        "n_layers": cfg.n_layers,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": int(decoded + len(rids)),
        "wall_s": wall,
        "decode_s": spent["decode"],
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "decode_tokens_per_s": decoded / spent["decode"],
        "prefill_s": sum(spent["prefill"]),
        "prefill_ms_mean": 1e3 * statistics.mean(spent["prefill"]),
        "prefill_ms_max": 1e3 * max(spent["prefill"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stats": stats, "launches": launches,
    }
    _log("serving " + json.dumps(report))
    return report


@contextlib.contextmanager
def plain_ops():
    """Route the models' kernel calls to their plain versions (the
    comparisons of phases 4 and 6 only; the package has no such
    switch)."""
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import paged_attention as pa
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    saved = (pa.paged_attention_decode, qmm.quantized_matmul, fa.flash_fwd,
             fa.flash_bwd_dq, fa.flash_bwd_dkv)
    pa.paged_attention_decode = pa.paged_attention_decode_reference
    qmm.quantized_matmul = qmm.quantized_matmul_reference
    fa.flash_fwd = fa.flash_attention_reference
    fa.flash_bwd_dq = fa.flash_bwd_dq_reference
    fa.flash_bwd_dkv = fa.flash_bwd_dkv_reference
    try:
        yield
    finally:
        (pa.paged_attention_decode, qmm.quantized_matmul, fa.flash_fwd,
         fa.flash_bwd_dq, fa.flash_bwd_dkv) = saved


def kernel_vs_plain_model(torch, model):
    """Phase 4: depth 2 of the same weights, one prefill of 100 tokens
    in two rows and 4 decode steps, through the kernels and through the
    plain versions; logits compared."""
    from sparkdl_tpu_torch.models.llama import Llama

    cfg = dataclasses.replace(model.cfg, n_layers=2, decode=True,
                              page_size=64, n_pages=8)
    params = {k: v for k, v in model.state_dict().items()
              if not k.startswith("layers.") or k.split(".")[1] in ("0", "1")}
    small = Llama.from_params(cfg, params, device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 100)),
                             device=DEVICE)
    steps = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 2, 1)),
                            device=DEVICE)
    tables = torch.as_tensor([[1, 2, 0], [4, 3, 0]], dtype=torch.int32,
                             device=DEVICE)

    def run():
        cache = small.init_cache()
        outs = [small(prompt, torch.arange(100, device=DEVICE)[None],
                      tables, cache)]
        for i in range(4):
            pos = torch.full((2, 1), 100 + i, device=DEVICE)
            outs.append(small(steps[i], pos, tables, cache))
        return [o.float() for o in outs]

    with torch.no_grad():
        got = run()
        with plain_ops():
            ref = run()
    # bf16 activations round at different points in the two paths (one
    # ulp here and there, 2^-8 relative); after two layers and the head
    # the logits may move by a few of those ulps of their scale
    report = []
    for i, (g, r) in enumerate(zip(got, ref)):
        err = (g - r).abs()
        scale = r.abs().max().item()
        row = {"call": "prefill" if i == 0 else f"decode {i}",
               "max_abs_err": err.max().item(), "logit_scale": scale,
               "mean_abs_err": err.mean().item(),
               "argmax_agree": float((g.argmax(-1) == r.argmax(-1))
                                     .float().mean())}
        report.append(row)
        _require(bool(torch.isfinite(g).all())
                 and row["max_abs_err"] <= 2.0 ** -4 * scale
                 and row["mean_abs_err"] <= 2.0 ** -8 * scale,
                 f"model logits, kernels vs plain, {row}")
    _log("model " + json.dumps(report))
    return report


def _flash_bound(kind, b, s, h, d, causal):
    """(bound ms, bound_by) of one flash call: bf16 tensors (B, S, H, D)
    read or written once, fp32 (B, H, S) vectors, and 4 (forward), 6
    (dq) or 8 (dk/dv) * D flops a visible (query, key) pair."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensors, vectors, per_pair = {"fwd": (4, 1, 4), "dq": (5, 2, 6),
                                  "dkv": (6, 2, 8)}[kind]
    nbytes = tensors * b * s * h * d * 2 + vectors * b * h * s * 4
    flops = per_pair * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_flash(torch, timer, gen):
    """Phase 2b: the three flash kernels against their plain versions
    at FLASH_SHAPES, and their times at the training shape."""
    import torch.nn.functional as F

    from sparkdl_tpu_torch.ops import flash_attention as fa

    rows = []
    for b, s, h, d, causal in FLASH_SHAPES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device=DEVICE).bfloat16()
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        # the plain versions on the same inputs (the backward's on the
        # kernel's own lse and delta, so each kernel is held alone)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal)
        rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
        rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal)
        torch.cuda.synchronize()
        # Tolerances. o: both round each probability to bf16 before the
        # PV product, the kernel relative to its running max and the
        # plain version relative to the row's max, so each term may
        # differ by 2^-7 of p|v| (a unit roundoff of 2^-8 on each side);
        # both round the output to bf16 (one ulp). lse: fp32 on both
        # sides, summed in another order (1e-4 of a value near 8).
        # dq, dk, dv: the same formula on both sides, but s, dp and p
        # are fp32 sums in another order, so ds and p may round to bf16
        # the other way (one ulp, 2^-7 of the term); and dp - delta
        # cancels where a row's softmax is one-hot (the first causal
        # row: dq is 0 there), leaving each side's fp32 rounding of dp,
        # at most D 2^-23 of sum|do||v| a side (the tensor cores' sum
        # rounds no better than twice fp32's unit roundoff); then one
        # ulp of the bf16 output.
        weighted = fa.flash_attention_reference(
            q.float(), k.float(), v.float().abs(), causal)[0]
        scale = d ** -0.5
        p, ds = fa._probs_and_ds(q, k, v, do, lse, delta, causal, None)
        ds_tol = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(),
                              v.float().abs())
        ds_tol = 2.0 ** -7 * ds.abs() + p * ds_tol * (d * 2.0 ** -22 * scale)
        del ds
        checks = {
            "o": (o, ro, 2.0 ** -7 * weighted),
            "lse": (lse, rlse, torch.full_like(rlse, 1e-4)),
            "dq": (dq, rdq, torch.einsum("bhqk,bkhd->bqhd", ds_tol,
                                         k.float().abs())),
            "dk": (dk, rdk, torch.einsum("bhqk,bqhd->bkhd", ds_tol,
                                         q.float().abs())),
            "dv": (dv, rdv, 2.0 ** -7 * torch.einsum(
                "bhqk,bqhd->bkhd", p, do.float().abs())),
        }
        del p, ds_tol, weighted
        errs, worst = {}, {}
        for name, (got, ref, tol) in checks.items():
            ref = ref.float()
            err = (got.float() - ref).abs()
            if name != "lse":
                tol = tol + _bf16_ulp(torch, ref) + 1e-6
            bad = int((err > tol).sum())
            errs[name] = err.max().item()
            worst[name] = (err / tol).max().item()
            _require(bad == 0 and bool(torch.isfinite(got).all()),
                     f"flash {name} (B {b}, S {s}, H {h}, D {d}, causal "
                     f"{causal}): {bad} elements beyond tolerance, max err "
                     f"{errs[name]}")
        del checks
        row = {"shape": {"B": b, "S": s, "H": h, "D": d, "causal": causal},
               "max_abs_err": errs, "worst_err_over_tol": worst}
        if (b, s, h, d, causal) == FLASH_SHAPES[0]:
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
            out = F.scaled_dot_product_attention(ql, kl, vl,
                                                 is_causal=causal)
            calls = {
                "fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                        lambda: fa.flash_attention_reference(q, k, v,
                                                             causal),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal)),
                "dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                               causal),
                       lambda: fa.flash_bwd_dq_reference(
                           q, k, v, do, lse, delta, causal),
                       None),
                "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal),
                        lambda: fa.flash_bwd_dkv_reference(
                            q, k, v, do, lse, delta, causal),
                        lambda: torch.autograd.grad(
                            out, (ql, kl, vl), dot, retain_graph=True)),
            }
            for kind, (kernel, plain, library) in calls.items():
                bound, bound_by = _flash_bound(kind, b, s, h, d, causal)
                row[kind] = {"ms": timer.ms(kernel),
                             "plain_ms": timer.ms(plain),
                             "library_ms": (timer.ms(library) if library
                                            else None),
                             "host_us": timer.host_us(kernel),
                             "bound_ms": bound, "bound_by": bound_by}
            # one SDPA backward computes dq, dk and dv together: its time
            # stands on the dk/dv row only, beside both backward kernels
            row["fwd"]["library_covers"] = "o (SDPA returns no lse)"
            row["dq"]["library_covers"] = ("none: SDPA's one backward "
                                           "call is on flash_bwd_dkv")
            row["dkv"]["library_covers"] = "dq, dk, dv"
            del out, ql, kl, vl
        _log("flash " + json.dumps(row))
        rows.append(row)
        del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rlse, rdq, rdk, rdv
    return rows


def _train_cfg(**kw):
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(attention="flash", lora_rank=16,
                                 lora_alpha=16.0,
                                 lora_targets=("q_proj", "v_proj"), **kw)


def profile_step(torch, step, batch, step_ms):
    """One more training step under ``torch.profiler`` (outside the
    counted window): device time by kernel name and their sum (one
    stream, so the device's busy time), with the idle share of an
    unprofiled step of ``step_ms`` (the profiled step's own wall time
    carries the profiler's cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)["loss"].item()
    wall_ms = 1e3 * (time.perf_counter() - t)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    summary = {"profiled_wall_ms": wall_ms, "step_ms": step_ms,
               "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
               "kernels": [{"name": k[:160], "ms": ms, "count": n}
                           for k, (ms, n) in top]}
    _log("profile " + json.dumps({**summary,
                                  "kernels": summary["kernels"][:12]}))
    return summary


def train(torch, gen):
    """Phase 5: the training main path, counters zeroed after the
    warm-up step, then one more step profiled."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
        param_count,
    )

    cfg = _train_cfg()
    t = time.perf_counter()
    model = init_weights(Llama(cfg, device=DEVICE), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    mask = lora_mask(model)
    lora = [p for n, p in model.named_parameters() if mask[n]]
    opt = torch.optim.AdamW(lora, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device=DEVICE)
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    lora_start = [p.detach().clone() for p in lora]
    frozen = model.layers[0].attn.q_proj.kernel
    frozen_start = frozen.detach().clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    losses = [step(batch)["loss"].item()]
    warmup_s = time.perf_counter() - t
    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    peak = torch.cuda.max_memory_allocated()

    _require(all(np.isfinite(losses)), f"training losses {losses}")
    _require(losses[-1] < losses[0],
             f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    moved = sum(not torch.equal(p, p0) for p, p0 in zip(lora, lora_start))
    _require(moved == len(lora),
             f"{len(lora) - moved} of {len(lora)} adapters did not move")
    _require(torch.equal(frozen, frozen_start),
             "a frozen base matrix changed")
    want = cfg.n_layers * TRAIN_STEPS
    for name, n in launches.items():
        _require(n == want, f"{name}: {n} launches in {TRAIN_STEPS} steps, "
                 f"want {cfg.n_layers} a step ({want})")

    # model FLOPs a token, bench.py's formula: forward 2N, backward dX
    # 2N, dW 2N_train (the adapters), attention 3 x 4 S d_model / 2 a
    # layer (causal)
    n_matmul = param_count(model) - cfg.vocab_size * cfg.d_model
    n_train = sum(p.numel() for p in lora)
    attn = 3 * (4 * TRAIN_SEQ * cfg.d_model) / 2 * cfg.n_layers
    flops_per_token = 4 * n_matmul + 2 * n_train + attn
    # rates over all the timed steps, so that a stall in one shows;
    # the median step stays beside them as the per-step latency
    step_s = statistics.median(times)
    tokens_per_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / sum(times)
    report = {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "n_layers": cfg.n_layers,
        "lora_rank": cfg.lora_rank, "lora_params": n_train,
        "losses": losses, "step_ms": [1e3 * x for x in times],
        "step_ms_median": 1e3 * step_s,
        "step_ms_mean": 1e3 * sum(times) / TRAIN_STEPS,
        "tokens_per_s": tokens_per_s,
        "model_flops_per_token": flops_per_token,
        "model_tflops_per_s": flops_per_token * tokens_per_s / 1e12,
        "share_of_989_tflops": flops_per_token * tokens_per_s
        / PEAK_FLOPS["bf16"],
        "peak_mem_gb": peak / 1e9, "warmup_s": warmup_s, "init_s": init_s,
        "launches": launches,
    }
    report["profile"] = profile_step(torch, step, batch, 1e3 * step_s)
    _log("train " + json.dumps({k: v for k, v in report.items()
                                if k != "profile"}))
    return report


def kernel_vs_plain_train(torch, gen):
    """Phase 6: one training step's loss and adapter gradients at depth
    2 (full width, batch 1 x 2048), through the kernels and through the
    plain versions."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
    )

    cfg = _train_cfg(n_layers=2)
    model = init_weights(Llama(cfg, device=DEVICE), gen)
    lora = {n: p for n, p in model.named_parameters() if p.requires_grad}
    with torch.no_grad():
        # non-zero lora_b, so lora_a carries a gradient too
        for n, p in lora.items():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    loss_fn = make_lm_loss_fn(model)
    batch = global_batch(np.random.default_rng(SEED + 2), cfg.vocab_size, 1,
                         TRAIN_SEQ)

    def run():
        for p in lora.values():
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in lora.items()}

    got_loss, got = run()
    with plain_ops():
        ref_loss, ref = run()
    # The paths differ in attention alone: the kernels and the plain
    # versions round p to bf16 against other maxima, so an attention
    # output may differ by 2^-7 of its p|v| sum, and by one ulp where it
    # rounds to bf16; that reaches the loss through 2 layers and the
    # fp32 head (2^-10 of it allowed), and each adapter gradient, a sum
    # over 2048 tokens, as 2^-5 of its norm at most.
    report = {"loss": got_loss, "plain_loss": ref_loss, "grads": {}}
    _require(np.isfinite(got_loss)
             and abs(got_loss - ref_loss) <= 2.0 ** -10 * abs(ref_loss),
             f"training loss, kernels {got_loss} vs plain {ref_loss}")
    for name, g in got.items():
        r = ref[name]
        rel = ((g - r).norm() / r.norm()).item()
        report["grads"][name] = {"rel_norm_err": rel,
                                 "max_abs_err": (g - r).abs().max().item(),
                                 "norm": r.norm().item()}
        _require(bool(torch.isfinite(g).all()) and r.norm() > 0
                 and rel <= 2.0 ** -5,
                 f"{name} gradient, kernels vs plain: relative error {rel}")
    report["worst_rel_norm_err"] = max(
        x["rel_norm_err"] for x in report["grads"].values())
    _log("train_vs_plain " + json.dumps(
        {k: v for k, v in report.items() if k != "grads"}))
    return report


def remat_memory(torch, gen):
    """Phase 6b: the peak memory of one ``make_train_step`` step above
    what the model holds, at depth 2 (full width, batch 2 x 2048),
    without remat, with the step's ``remat=True`` (the whole loss
    checkpointed) and with ``cfg.remat`` (each block checkpointed). The
    kernels are deterministic and a recomputed forward is the same
    forward, so the three losses must be bit-identical."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
    )

    model = init_weights(Llama(_train_cfg(n_layers=2), device=DEVICE), gen)
    mask = lora_mask(model)
    lora = [p for n, p in model.named_parameters() if mask[n]]
    # lr 0: every variant starts from the same weights
    opt = torch.optim.SGD(lora, lr=0.0)
    batch = global_batch(np.random.default_rng(SEED + 3),
                         model.cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    base_cfg = model.cfg
    report = {"n_layers": base_cfg.n_layers, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ}
    for name, step_remat, block_remat in (("none", False, False),
                                          ("step", True, False),
                                          ("block", False, True)):
        model.cfg = dataclasses.replace(base_cfg, remat=block_remat)
        step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                               remat=step_remat, device=DEVICE)
        opt.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = step(batch)["loss"].item()
        report[name] = {"loss": loss, "peak_above_model_gb":
                        (torch.cuda.max_memory_allocated() - held) / 1e9}
    model.cfg = base_cfg
    losses = {report[k]["loss"] for k in ("none", "step", "block")}
    _require(len(losses) == 1 and all(np.isfinite(list(losses))),
             f"remat changed the loss: {report}")
    _log("remat " + json.dumps(report))
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", default="",
                        help="also write every record to this JSON file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from sparkdl_tpu_torch.models.llama import LlamaConfig
    from sparkdl_tpu_torch.ops import _build

    # the plain versions' fp32 products are full fp32, as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = _card_line(torch)
    _log(f"card: {card}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    _build.build(_build.sources())
    _log(f"build: {time.perf_counter() - t:.1f} s for {_build.sources()}")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    timer = Timer(torch)
    qmm_rows = check_quantized_matmul(torch, timer, gen)
    paged_row = check_paged_attention(torch, timer, gen)
    del timer

    cfg = LlamaConfig.llama3_8b(max_cache_len=2048, quant="int8")
    t = time.perf_counter()
    model = random_int8_llama(torch, cfg, gen)
    _log(f"weights: {time.perf_counter() - t:.1f} s")
    serving = serve(torch, model)
    model_rows = kernel_vs_plain_model(torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    timer = Timer(torch)
    flash_rows = check_flash(torch, timer, gen)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    training = train(torch, gen)
    gc.collect()
    torch.cuda.empty_cache()
    train_rows = kernel_vs_plain_train(torch, gen)
    gc.collect()
    torch.cuda.empty_cache()
    remat_rows = remat_memory(torch, gen)

    # one decode step's worth of each kernel, at the served depth
    def per_step(rows, key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r["calls_per_decode_step"]
                   * (cfg.n_layers if r["per_layer"] else 1) for r in rows)

    # one training step's worth of each flash kernel: a call a layer
    main_flash = flash_rows[0]
    n_train_layers = training["n_layers"]

    def flash_line(name, kind, body_line):
        t = main_flash[kind]
        return {"name": name, "route": "cuda",
                "source": "sparkdl_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": f"sparkdl_tpu/ops/pallas/flash_attention.py:"
                            f"{body_line}",
                "launches": training["launches"][name],
                "max_abs_err": max(
                    e for r in flash_rows
                    for n, e in r["max_abs_err"].items()
                    if n in {"fwd": ("o", "lse"), "dq": ("dq",),
                             "dkv": ("dk", "dv")}[kind]),
                "ms": t["ms"] * n_train_layers,
                "plain_ms": t["plain_ms"] * n_train_layers,
                "bound_ms": t["bound_ms"] * n_train_layers,
                "bound_by": t["bound_by"],
                "library_ms": (None if t["library_ms"] is None
                               else t["library_ms"] * n_train_layers),
                "library_covers": t["library_covers"]}

    kernels = [
        {"name": "quantized_matmul", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/quantized_matmul.cu",
         "replaces": "sparkdl_tpu/ops/pallas/quantized_matmul.py:79",
         "launches": serving["launches"]["quantized_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in qmm_rows),
         "ms": per_step(qmm_rows, "ms"),
         "plain_ms": per_step(qmm_rows, "plain_ms"),
         "bound_ms": per_step(qmm_rows, "bound_ms"),
         "bound_by": "bytes", "library_ms": per_step(qmm_rows, "library_ms")},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/paged_attention.cu",
         "replaces": "sparkdl_tpu/ops/pallas/paged_attention.py:46",
         "launches": serving["launches"]["paged_attention_decode"],
         "max_abs_err": paged_row["max_abs_err"],
         "ms": per_step([paged_row], "ms"),
         "plain_ms": per_step([paged_row], "plain_ms"),
         "bound_ms": per_step([paged_row], "bound_ms"),
         "bound_by": paged_row["bound_by"], "library_ms": None},
        flash_line("flash_fwd", "fwd", 45),
        flash_line("flash_bwd_dq", "dq", 158),
        flash_line("flash_bwd_dkv", "dkv", 206),
    ]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"card": card, "kernels": kernels, "qmm": qmm_rows,
                       "paged": paged_row, "serving": serving,
                       "model": model_rows, "flash": flash_rows,
                       "train": training, "train_vs_plain": train_rows,
                       "remat": remat_rows,
                       "total_s": time.perf_counter() - t_start}, f,
                      indent=1)
    _log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
