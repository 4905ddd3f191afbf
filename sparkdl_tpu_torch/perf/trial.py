"""The autotuner's trial harnesses: one measured run of a bench, its
metrics appended as one ledger line to the history the caller names.

Run as::

    python -m sparkdl_tpu_torch.perf.trial serve|train|gbdt \\
        --settings '{"sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK": 8}' \\
        --history PATH [--device cuda|cpu] [--layers N] [--config NAME]

``--settings`` (``{"dotted.name": value}``, registered in
:mod:`sparkdl_tpu_torch.utils.knobs`) are set before the run, for the
process's life: they are how the autotuner's overrides reach a trial
(not the environment). The run writes nothing but its line in
``--history`` (through ``observe.perf.append_history``, tagged
``bench="trial:<bench>"``, ``gbdt_bench`` for gbdt) and one JSON line
on stdout. It is the
autotuner's harness, not a benchmark. A trial runs on the card unless
``--device cpu``; ``--config`` is ``llama3_8b`` (Meta's published
widths, the default) or ``tiny`` (for gbdt: the JAX bench's smoke
shape); ``--layers`` cuts the depth (the widths stay; serve and train
only).

- ``serve``: the JAX package's serve traffic
  (``benchmarks/serve_bench.py``: 4 streams x 4 requests, closed loop,
  prompts of 64 random tokens, 128 new tokens each, 8 slots) through
  the port's continuous-batching engine (paged KV cache of
  :data:`SERVE_PAGE_SIZE`, weights :data:`SERVE_QUANT`, decode chunk
  :data:`SERVE_DECODE_CHUNK`) behind a ``FleetFrontend`` of
  :data:`SERVE_REPLICAS` replicas (admission bound
  :data:`SERVE_MAX_QUEUE`, None: 4x the slots), streamed over HTTP by
  urllib clients (the ``tiny`` config takes serve_bench's tiny shape: 4
  slots, prompts of 8, 16 new tokens). The weights are random from a
  seed. Metrics:
  ``serve_tokens_per_sec`` (the primary; one sample a round, a round
  being every stream's j-th request, so 4 samples and the compare
  gate's sample protection is live), ``serve_ttft_ms`` and
  ``serve_inter_token_ms`` (client-side, a sample a request or a gap),
  ``serve_goodput_rps``. The line carries the kernels' launch counts of
  the traffic (warm-up excluded) and the engines' decode steps and
  forwards over it, from which the counts follow.
- ``train``: phase 5's LoRA step (rank 16 on q and v, flash attention,
  bf16 base, AdamW on the adapters, batch 2 x 2048) with the fused
  chunked loss of :data:`LOSS_CHUNK` tokens a chunk, one warm-up step
  and 5 timed ones. Metric: ``train_step_ms`` (a sample a step).
- ``gbdt``: the JAX package's ``benchmarks/gbdt_bench.py`` on the port's
  ``XgboostClassifier`` (``sparkdl_tpu_torch.xgboost.DEVICE`` set to the
  trial's device): 100,000 x 32 float32 rows from a seed (4 informative
  features), a pandas frame, 20 trees of depth 5 with
  :data:`GBDT_MAX_BINS` bins; one warm fit, then 4 timed fits, each
  followed by a timed ``transform`` of the same frame (the ``tiny``
  config: 2,000 x 8, 3 trees of depth 3). Metrics:
  ``gbdt_fit_rows_per_sec`` (rows x trees over a fit's seconds, the
  primary) and ``gbdt_predict_rows_per_sec``, a sample a rep each.
"""

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# the trial settings that stand for the JAX package's serve_bench and
# bench.py knobs, read at call time (registered tunable in utils.knobs)
LOSS_CHUNK = 512           # SPARKDL_TPU_LOSS_CHUNK
SERVE_PAGE_SIZE = 64       # SPARKDL_TPU_KV_PAGE_SIZE (0: dense slots)
SERVE_DECODE_CHUNK = 16    # SPARKDL_TPU_SERVE_DECODE_CHUNK
SERVE_REPLICAS = 1         # SPARKDL_TPU_SERVE_REPLICAS
SERVE_MAX_QUEUE = None     # SPARKDL_TPU_SERVE_MAX_QUEUE (None: 4x slots)
SERVE_QUANT = "int8"       # SPARKDL_TPU_SERVE_QUANT ("" is bf16)
GBDT_MAX_BINS = 256        # SPARKDL_TPU_GBDT_MAX_BINS (the bench's only)

# the JAX serve traffic's full shape (serve_bench.py main())
STREAMS = 4
REQUESTS_PER_STREAM = 4
PROMPT_LEN = 64
MAX_NEW = 128
N_SLOTS = 8
TRAIN_BATCH = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 5
SEED = 0
REQUEST_TIMEOUT_S = 600.0
# gbdt_bench.py's shapes, (rows, features, trees, depth): full and tiny
GBDT_SHAPE = (100_000, 32, 20, 5)
GBDT_TINY_SHAPE = (2_000, 8, 3, 3)
GBDT_REPS = 4

def apply_settings(settings):
    """Set ``{"dotted.name": value}`` on their modules for the process's
    life; each must be a registered setting of the port."""
    from sparkdl_tpu_torch.utils import knobs

    for name, value in (settings or {}).items():
        kb = knobs.get(name)
        if kb is None:
            raise SystemExit(f"trial: {name!r} is not a registered setting")
        module, attr = name.rsplit(".", 1)
        setattr(knobs.owner(module), attr, value)


def _wrappers():
    from sparkdl_tpu_torch.ops import (
        flash_attention,
        paged_attention,
        quantized_matmul,
    )

    return {"paged_attention_decode": paged_attention.paged_attention_decode,
            "quantized_matmul": quantized_matmul.quantized_matmul,
            "quantized_matmul_int4": quantized_matmul.quantized_matmul_int4,
            "flash_fwd": flash_attention.flash_fwd,
            "flash_bwd_dq": flash_attention.flash_bwd_dq,
            "flash_bwd_dkv": flash_attention.flash_bwd_dkv}


def _zero_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _config(name, layers, **kw):
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    if name not in ("llama3_8b", "tiny"):
        raise SystemExit(f"trial: unknown --config {name!r}")
    if layers is not None:
        kw["n_layers"] = int(layers)
    return getattr(LlamaConfig, name)(**kw)


def _serve_shape(config):
    """(slots, prompt length, new tokens): the full shape, or the JAX
    serve_bench's tiny one (4 slots, prompts of 8, 16 new tokens) for
    the ``tiny`` config."""
    return (N_SLOTS, PROMPT_LEN, MAX_NEW) if config == "llama3_8b" \
        else (4, 8, 16)


def _device_kind(device):
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class _Request:
    def __init__(self):
        self.t0 = self.ttft = self.done_at = self.error = None
        self.gaps = []
        self.tokens = 0


def _stream_one(address, prompt, max_new, rec):
    """One SSE request, timed client-side (serve_bench's client): send
    -> first token (TTFT), token -> token (the gaps)."""
    req = urllib.request.Request(
        f"http://{address[0]}:{address[1]}/generate",
        data=json.dumps({"tokens": prompt, "max_new_tokens": max_new,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    rec.t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as r:
            last = None
            for line in r:
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[6:])
                now = time.perf_counter()
                if "token" in ev:
                    if last is None:
                        rec.ttft = now - rec.t0
                    else:
                        rec.gaps.append(now - last)
                    last = now
                    rec.tokens += 1
                elif "error" in ev:
                    rec.error = ev["error"]
                elif "done" in ev:
                    rec.done_at = now
    except urllib.error.HTTPError as e:
        rec.error = f"HTTP {e.code}: {e.reason}"
    except OSError as e:
        rec.error = str(e)


def _drive(address, vocab, prompt_len, max_new):
    """The closed-loop load: ``STREAMS`` clients, each sending its
    ``REQUESTS_PER_STREAM`` requests one after another. Returns the
    records, ``[stream][request]``, and the wall seconds."""
    rng = np.random.default_rng(SEED)
    prompts = [[rng.integers(1, vocab, (prompt_len,)).astype(int).tolist()
                for _ in range(REQUESTS_PER_STREAM)] for _ in range(STREAMS)]
    records = [[_Request() for _ in range(REQUESTS_PER_STREAM)]
               for _ in range(STREAMS)]

    def client(s):
        for j in range(REQUESTS_PER_STREAM):
            _stream_one(address, prompts[s][j], max_new, records[s][j])

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in range(STREAMS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(REQUEST_TIMEOUT_S * REQUESTS_PER_STREAM)
    return records, time.perf_counter() - t0


def _round_rates(records):
    """Tokens a second of each round (every stream's j-th request): its
    tokens over the span from its first send to its last token."""
    rates = []
    for j in range(REQUESTS_PER_STREAM):
        rnd = [records[s][j] for s in range(STREAMS)]
        span = max(r.done_at for r in rnd) - min(r.t0 for r in rnd)
        rates.append(sum(r.tokens for r in rnd) / span)
    return rates


def serve(device, config="llama3_8b", layers=None):
    """The serve trial (module docstring); returns the ledger metrics
    and the record's extra fields."""
    import torch

    from sparkdl_tpu_torch.models.fleet import FleetFrontend
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
    from sparkdl_tpu_torch.observe import perf

    quant = SERVE_QUANT or ""
    cfg = _config(config, layers)
    n_slots, prompt_len, max_new = _serve_shape(config)
    t = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    model = init_weights(Llama(cfg, device=device), gen)
    params = model.state_dict()
    build_s = time.perf_counter() - t

    engines = []

    def engine():
        engines.append(ContinuousBatchingEngine(
            model, params, n_slots=n_slots, chunk=SERVE_DECODE_CHUNK,
            page_size=SERVE_PAGE_SIZE, quant=quant, device=device))
        return engines[-1]

    def counts():
        """The engines' decode steps and forwards (steps and prefill
        segments) so far: what the traffic's launches follow from."""
        return (sum(e.stats["steps"] for e in engines),
                sum(e.stats["steps"] + e.stats["prefill_segments"]
                    for e in engines))

    max_queue = (SERVE_MAX_QUEUE if SERVE_MAX_QUEUE is not None
                 else 4 * n_slots * SERVE_REPLICAS)
    fe = FleetFrontend(engine, replicas=SERVE_REPLICAS, max_queue=max_queue)
    fe.start()
    try:
        # warm-up outside the window: one request a replica, at once
        warm = [_Request() for _ in range(SERVE_REPLICAS)]
        threads = [threading.Thread(
            target=_stream_one,
            args=(fe.address, [1] * prompt_len, max_new, w), daemon=True)
            for w in warm]
        for th in threads:
            th.start()
            time.sleep(0.05)  # the previous warm-up's depth lands first
        for th in threads:
            th.join(REQUEST_TIMEOUT_S)
        errors = [w.error for w in warm if w.error or w.done_at is None]
        if errors:
            raise RuntimeError(f"serve trial warm-up failed: {errors}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steps0, forwards0 = counts()
        _zero_launches()
        records, wall = _drive(fe.address, cfg.vocab_size, prompt_len,
                               max_new)
        launches = _read_launches()
        steps, forwards = counts()
    finally:
        fe.close()
    flat = [r for rows in records for r in rows]
    bad = [r.error or "no answer" for r in flat
           if r.error or r.done_at is None or r.tokens != max_new]
    if bad:
        raise RuntimeError(f"serve trial: {len(bad)} of {len(flat)} "
                           f"requests failed: {sorted(set(bad))[:3]}")
    metrics = {
        "serve_tokens_per_sec": perf.sample_metric(
            _round_rates(records), unit="tokens/sec",
            higher_is_better=True),
        "serve_ttft_ms": perf.sample_metric(
            [r.ttft * 1e3 for r in flat], unit="ms"),
        "serve_inter_token_ms": perf.sample_metric(
            [g * 1e3 for r in flat for g in r.gaps], unit="ms"),
        "serve_goodput_rps": perf.sample_metric(
            [len(flat) / wall], unit="req/sec", higher_is_better=True),
    }
    extra = {"launches": launches, "engine_steps": steps - steps0,
             "engine_forwards": forwards - forwards0,
             "wall_s": wall, "build_s": build_s,
             "tokens": sum(r.tokens for r in flat), "n_layers": cfg.n_layers,
             "streams": STREAMS, "requests_per_stream": REQUESTS_PER_STREAM,
             "prompt_len": prompt_len, "max_new": max_new,
             "n_slots": n_slots, "page_size": SERVE_PAGE_SIZE,
             "chunk": SERVE_DECODE_CHUNK, "replicas": SERVE_REPLICAS,
             "max_queue": max_queue, "quant": quant or "bf16"}
    return metrics, extra


def train(device, config="llama3_8b", layers=None):
    """The train trial (module docstring); returns the ledger metrics
    and the record's extra fields."""
    import torch

    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.observe import perf
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
    )

    cfg = _config(config, layers,
                  attention="flash" if device.type == "cuda"
                  else "reference",
                  lora_rank=16, lora_alpha=16.0,
                  lora_targets=("q_proj", "v_proj"))
    seq = TRAIN_SEQ if config == "llama3_8b" else 64
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    model = init_weights(Llama(cfg, device=device), gen)
    mask = lora_mask(model)
    lora = [p for n, p in model.named_parameters() if mask[n]]
    opt = torch.optim.AdamW(lora, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = make_train_step(
        make_lm_loss_fn(model, loss="fused", chunk=LOSS_CHUNK), opt,
        param_mask=mask, device=device)
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, seq)
    losses = [step(batch)["loss"].item()]  # warm-up
    _zero_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        losses.append(step(batch)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"train trial: losses {losses}")
    metrics = {"train_step_ms": perf.sample_metric(
        [s * 1e3 for s in times], unit="ms")}
    extra = {"launches": _read_launches(), "losses": losses,
             "n_layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": seq,
             "loss_chunk": LOSS_CHUNK}
    return metrics, extra


def gbdt(device, config="llama3_8b", layers=None):
    """The gbdt trial (module docstring); returns the ledger metrics and
    the record's extra fields."""
    import pandas as pd

    import sparkdl_tpu_torch.xgboost as xgb
    from sparkdl_tpu_torch.observe import perf

    if layers is not None:
        raise NotImplementedError("the gbdt trial takes no --layers")
    tiny = config == "tiny"
    n, f, trees, depth = GBDT_TINY_SHAPE if tiny else GBDT_SHAPE
    rng = np.random.RandomState(SEED)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, :4].sum(axis=1) + 0.1 * rng.randn(n) > 0).astype(np.float32)
    df = pd.DataFrame({"features": list(X), "label": y})
    xgb.DEVICE = device.type

    def one_fit():
        clf = xgb.XgboostClassifier(n_estimators=trees, max_depth=depth,
                                    max_bin=GBDT_MAX_BINS)
        t = time.perf_counter()
        model = clf.fit(df)
        return model, time.perf_counter() - t

    # the warm fit: first-call costs are not training throughput
    model, warm_fit_s = one_fit()
    fit_s, pred_s = [], []
    for _ in range(GBDT_REPS):
        model, dt = one_fit()
        fit_s.append(dt)
        t = time.perf_counter()
        out = model.transform(df)
        pred_s.append(time.perf_counter() - t)
    acc = float((out["prediction"] == df["label"]).mean())
    if acc < 0.6:
        raise RuntimeError(f"gbdt trial: train accuracy collapsed ({acc})")
    metrics = {
        "gbdt_fit_rows_per_sec": perf.sample_metric(
            [n * trees / s for s in fit_s], unit="rows*trees/sec",
            higher_is_better=True, digits=1),
        "gbdt_predict_rows_per_sec": perf.sample_metric(
            [n / s for s in pred_s], unit="rows/sec",
            higher_is_better=True, digits=1)}
    extra = {"rows": n, "features": f, "trees": trees, "max_depth": depth,
             "max_bins": GBDT_MAX_BINS, "tiny": tiny,
             "warm_fit_sec": warm_fit_s, "fit_sec": fit_s,
             "predict_sec": pred_s, "train_accuracy": acc}
    return metrics, extra


HARNESSES = {"serve": serve, "train": train, "gbdt": gbdt}
# the ledger tag of each harness's line (gbdt keeps the JAX bench's)
LEDGER_BENCH = {"serve": "trial:serve", "train": "trial:train",
                "gbdt": "gbdt_bench"}


def main(argv=None):
    import torch

    from sparkdl_tpu_torch.observe import perf
    from sparkdl_tpu_torch.ops._dispatch import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.perf.trial",
        description="One measured autotune trial; appends its ledger "
                    "line to --history.")
    ap.add_argument("bench", choices=sorted(HARNESSES))
    ap.add_argument("--settings", type=json.loads, default=None,
                    help='JSON {"dotted.name": value} set for the run')
    ap.add_argument("--history", required=True,
                    help="the ledger the trial's line is appended to")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card")
    ap.add_argument("--config", default="llama3_8b",
                    choices=("llama3_8b", "tiny"),
                    help="tiny: the small shapes (gbdt: the JAX bench's "
                         "smoke shape)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (the widths stay)")
    args = ap.parse_args(argv)
    apply_settings(args.settings)
    device = resolve_device(args.device)
    torch.manual_seed(SEED)
    metrics, extra = HARNESSES[args.bench](device, args.config, args.layers)
    extra["settings"] = args.settings or {}
    rec = perf.history_record(metrics, device_kind=_device_kind(device),
                              bench=LEDGER_BENCH[args.bench], extra=extra)
    if perf.append_history(rec, args.history) is None:
        raise SystemExit(f"trial: could not append to {args.history}")
    print(json.dumps({"bench": args.bench, "extra": extra,
                      "metrics": {k: v["value"] for k, v in
                                  metrics.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    # through the package's module, not __main__: the settings are that
    # module's, and the harnesses read them there
    from sparkdl_tpu_torch.perf import trial as _trial

    sys.exit(_trial.main())
