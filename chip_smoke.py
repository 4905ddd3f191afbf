#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version at the serving path's shapes, then
serve Llama-3-8B at full width (random int8 weights, paged KV cache)
through ``ContinuousBatchingEngine`` and show the run went through both
kernels.

    python3 chip_smoke.py [--report PATH]

Needs one CUDA card (sm_90a) and ``nvcc``; exits nonzero without them
and on any failed check. Phases:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
1. build every ``sparkdl_tpu_torch/ops/csrc/*.cu`` (one nvcc each, all
   started together);
2. each kernel against its plain version on the card at the shapes one
   decode step (and a prefill) gives it, timed with CUDA events (L2
   flushed between runs, median of 25) beside the bound computed from
   bytes or operations;
3. serving at full width: 16 requests (prompts 64-1024 tokens, budgets
   32-128, greedy) through 8 slots, pages of 64; every request must end
   on its full budget, and the launch counters, zeroed just before the
   run, must equal what the engine's own step and prefill counts
   predict;
4. the kernel path against the plain path at model level: the same
   weights at depth 2 (full width), one prefill and 4 decode steps.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
carry the kernels' record (``{"kernels": [...]}``) and the card.
"""

import argparse
import contextlib
import dataclasses
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
    """Route the model's two kernel calls to their plain versions (the
    comparison of phase 4 only; the package has no such switch)."""
    from sparkdl_tpu_torch.ops import paged_attention as pa
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    saved = (pa.paged_attention_decode, qmm.quantized_matmul)
    pa.paged_attention_decode = pa.paged_attention_decode_reference
    qmm.quantized_matmul = qmm.quantized_matmul_reference
    try:
        yield
    finally:
        pa.paged_attention_decode, qmm.quantized_matmul = saved


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

    # one decode step's worth of each kernel, at the served depth
    def per_step(rows, key):
        return sum(r[key] * r["calls_per_decode_step"]
                   * (cfg.n_layers if r["per_layer"] else 1) for r in rows)

    kernels = [
        {"name": "quantized_matmul", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/quantized_matmul.cu",
         "replaces": "sparkdl_tpu/ops/pallas/quantized_matmul.py:79",
         "launches": serving["launches"]["quantized_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in qmm_rows),
         "ms": per_step(qmm_rows, "ms"),
         "plain_ms": per_step(qmm_rows, "plain_ms"),
         "bound_ms": per_step(qmm_rows, "bound_ms"),
         "bound_by": "bytes", "library_ms": None},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/paged_attention.cu",
         "replaces": "sparkdl_tpu/ops/pallas/paged_attention.py:46",
         "launches": serving["launches"]["paged_attention_decode"],
         "max_abs_err": paged_row["max_abs_err"],
         "ms": per_step([paged_row], "ms"),
         "plain_ms": per_step([paged_row], "plain_ms"),
         "bound_ms": per_step([paged_row], "bound_ms"),
         "bound_by": paged_row["bound_by"], "library_ms": None},
    ]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"card": card, "kernels": kernels, "qmm": qmm_rows,
                       "paged": paged_row, "serving": serving,
                       "model": model_rows,
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
