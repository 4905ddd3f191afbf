#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version at the main paths' shapes, serve
Llama-3-8B at full width (random int8 weights, paged KV cache) through
``ContinuousBatchingEngine``, serve it again over a dense slot cache
and through ``generate()``, by two replicas behind one
``FleetFrontend`` and tensor-parallel on two ranks, then in int4 behind
the HTTP
``ServingFrontend`` (chunked prefill, then
shared prefixes), then LoRA-fine-tune it at full width through
``make_train_step``, serve the fine-tune's base with 4 stacked adapters
and speculatively with its int8 weights as the draft, then as
HorovodRunner gangs (one resumed from a checkpoint after its worker is
killed), sequence-parallel over a ring of two ranks and as a two-stage
pipeline; then serve and LoRA-fine-tune a Mixtral-8x7B-width mixture of
experts (cut in depth) and run its expert layer expert-parallel over two
ranks; train Llama-3-8B tensor-parallel and ZeRO-3 (``fsdp``) and serve
it ZeRO-3 on two ranks sharing the card; run HorovodRunner on Spark;
train the model zoo (the MNIST CNN, ResNet-50 and BERT-base SQuAD) through
HorovodRunner and convert a HuggingFace Llama-3-8B state dict into the
int8 serving path; serve and fine-tune with the telemetry on and
diagnose a hung gang; serve through a fleet whose replica is a
tensor-parallel gang, and train BERT-base tensor-parallel and ZeRO-3;
tune the serving path's decode chunk with the autotuner and apply its
profile to a gang under the lock-order sanitizer; fit the GBDT
estimators; prefetch host batches onto the card and bind the tf.keras
and Keras 3 shims; serve Llama-3.1-8B past its 8192-token original
window; trace the fine-tune's step for the graph lints and refuse a
launch whose ranks diverge; and show every run went through its
kernels.

    python3 chip_smoke.py [--report PATH]

Needs one CUDA card (sm_90a) and ``nvcc``; exits nonzero without them
and on any failed check. Phases:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
1. build every ``sparkdl_tpu_torch/ops/csrc/*.cu`` (one nvcc each, all
   started together), and beside it ``nvcc -Xptxas -v`` on every
   source: the registers, spills, stack and shared memory of each
   kernel of PTXAS_KERNELS are printed once (``ptxas`` line);
2. the serving kernels against their plain versions on the card at the
   shapes one decode step (and a prefill) gives them, timed with CUDA
   events (L2 flushed between runs, median of 25) beside the bound
   computed from bytes or operations, their time before their Hopper
   redesign (``old_ms``, ``old_host_us``), and
   ``torch._weight_int8pack_mm`` timed beside the int8 matmul as its
   library yardstick; the int8 weights span -128..127 with one column
   all -128; the paged decode is also checked (not timed) at its split
   boundaries: one token (every later split empty), a length ending on
   a split boundary and one past it, full rows, an inactive row on the
   dump page, and every row at 2048; then both are checked (not
   timed) at the shapes a TP=2 rank of phase 13 gives them (the int8
   matmul's local slices and its vocab-split fp32 head, the paged
   decode on 16 q heads over 4 kv heads); and the paged decode, checked
   and timed beside its bound and its plain version, at phase 31a's
   step: a 16,000-token row and three short ones in tables of 256
   pages;
2c. the int4 matmul against its plain version at the same decode-step
   shapes and a prefill chunk (M = 256), group 64, timed beside its
   bound, ``torch._weight_int4pack_mm`` (checked against the plain
   version first) and its time before the tensor-core redesign
   (``old_ms``);
3. serving at full width: 16 requests (prompts 64-1024 tokens, budgets
   32-128, greedy) through 8 slots, pages of 64; every request must end
   on its full budget, and the launch counters, zeroed just before the
   run, must equal what the engine's own step and prefill counts
   predict;
4. the kernel path against the plain path at model level: the same
   weights at depth 2 (full width), one prefill and 4 decode steps;
10. the dense slot cache: phase 3's 16 requests through the same int8
   model with ``page_size=0``, every request on its budget and the int8
   launches, zeroed before the run, equal to (7 x layers + 1) x (the
   engine's steps + one prefill a request); the share of tokens that
   agree with phase 3's paged run; then ``generate()`` on 2 x 128
   prompt tokens for 32 new ones (its launches: 32 forwards); then, at
   depth 2, kernels against plain over the dense cache (phase 4's
   tolerance);
14. the fleet: int8 paged engines at phase 3's settings behind one
   ``FleetFrontend`` (max_queue 12), sharing phase 3's weights on the
   card: 16 concurrent urllib clients (odd ones streamed, budgets of
   16-32), some refused with 503 and ``Retry-After``, first at one
   replica and then at 2
   (tokens/s, time to first token and each engine's decode ms a step
   beside the one replica's); then 4 while replica 0's engine raises
   SystemExit inside ``run()`` after 3 decode chunks (its requests get
   500, the replica is replaced) and 4 after the respawn; every 200 on
   its budget, ``server_requests_total`` accounting for every request,
   one restart, and the launches, zeroed before each fleet's first
   burst, equal to what the engines' counts predict; requests/s and tokens/s beside
   phase 3's, the streamed clients' time to first token, requests a
   replica, the seconds from the fault to a live replacement and peak
   memory; then the serving model is freed;
13. tensor-parallel serving, run as the first burst of phase 27b's
   fleet (so that the 8B TP engine starts once): two ranks on the one
   card (gloo), each ``make_mesh(MeshSpec(model=2))`` and an int8 model
   of ``TP_SERVE_DEPTH`` layers drawn from phase 3's seed (its layers
   phase 3's first, its head drawn after them); at depth 2 the TP=2
   logits of one prefill and two decode steps through the kernels
   against the same TP layers through the plain versions and against
   one card's through the kernels and through the plain versions
   (phase 4's tolerance); then an int8 paged engine with ``mesh=`` (4
   kv heads a rank, the paged decode through
   ``paged_attention_decode_sharded``) serves phase 3's first 8
   requests, each rank recording its launches, collectives, clocks and
   results to a file this process reads; each rank's launches equal
   its engine's counts (a paged decode a layer a step, 7 int8 matmuls a
   layer and the head's a forward), its collectives 2 all-reduces a
   layer, 2 all-gathers and 1 token broadcast a forward, both ranks
   return the same tokens, logprobs,
   stats and finish reasons, every request ends on its budget; decode
   ms a step and tokens/s beside phase 3's, each collective's ms at the
   decode step's shapes, peak memory a rank and the share of tokens
   that agree with phase 3;
27b. a tensor-parallel replica behind ``FleetFrontend``, right after
   phase 25b: one replica spelled ``GangReplica(tp_rank_engine,
   np=-2)``, whose ranks build phase 13's engine; phase 13's 8
   requests through HTTP, the odd ones streamed: every client's tokens
   the ranks' own (phase 13's) exactly; then ``N_TP_FAULT_REQUESTS``
   long requests in flight, rank 1 SIGKILLed at the streamed one's
   first token: each ends in 500, the replica is respawned as a new
   gang, and phase 13's first ``N_TP_FAULT_REQUESTS`` requests (budgets
   cut to ``TP_AFTER_BUDGET``) give the first burst's tokens again,
   with the launches their engines' counts predict; no rank process
   outlives ``close()``. It prints tokens/s and streamed TTFT p50 /
   p95 beside phase 13's, the seconds from the kill to the new gang
   serving and the new gang's start;
7. int4 serving at full width behind the HTTP ``ServingFrontend``
   (random normal(0.02) weights quantized to int4, group 64, 8 slots,
   pages of 64, chunk 16, ``prefill_chunk=256``): 16 concurrent HTTP
   clients, half of them streamed, prompts of 64-1024 tokens, budgets
   of 32-128; every response on its full budget, ``/metrics`` counting
   16, and the launch counters, zeroed before the run, equal to what
   the engine's step and prefill-segment counts predict (int8: 0);
7b. prefix sharing: one 512-token prefix registered, 8 requests that
   extend it; the prefix tokens not prefilled again and the pool's
   pages counted; then, at depth 2, a prefix request's first-token
   logits against the same prompt prefilled whole;
8. the int4 kernel path against the plain path at model level (depth
   2, as phase 4); then the int4 model is freed;
2b. the three flash-attention kernels (forward, dq, dk/dv) against
   their plain versions at the training shape (B 2, S 2048, H 32,
   D 128, causal), at a ragged S of 1000 (causal and not, D 128 and
   64), at phase 15's ring hops (B 1, S 4096, H 32, D 128: the
   diagonal hop causal, an earlier rank's block not) and at phase 16's
   stage blocks (B 1, S 2048, H 32, D 128, causal), timed at the
   training shape beside their bounds and beside
   ``scaled_dot_product_attention`` (forward, and its backward against
   dq + dk/dv), with TFLOP/s, and each kernel's time before its Hopper
   redesign (``old_ms``) beside it;
5. LoRA fine-tuning at full width (Llama-3-8B, rank 16 on q and v,
   flash attention, random bf16 weights): batch 2 x 2048, AdamW on the
   adapters, one warm-up step and 5 timed ones; the loss must fall, the
   adapters move, a frozen matrix stay bit-identical, and each flash
   counter, zeroed after the warm-up, read 32 x 5; then one more step
   under ``torch.profiler`` (device time by kernel, idle share);
11. multi-LoRA serving on phase 5's bf16 base, paged (pages of 64):
   4 adapters of rank 16 on q and v stacked with
   ``stack_lora_adapters`` (adapter 0 phase 5's trained ones, 1-3
   seeded with non-zero ``lora_b``), phase 3's 16 requests, 4 an
   adapter; every request on its budget, the paged decode launches
   equal to layers x the engine's steps; decode tokens/s and ms a step
   beside phase 3's; at depth 2, each adapter's prefill and first decode
   logits against a single-adapter model carrying it (phase 4's
   tolerance);
12. speculative serving: the same bf16 base as a paged target, its int8
   weights as the draft, k = 4, greedy, phase 3's first 4 requests,
   then the plain paged engine on the same target and requests; every
   request on its budget, the int8 launches equal to (7 x layers + 1)
   x the draft's forwards (k + 1 a round, one prefill a request), no
   paged decode in the speculative run (the verify takes k + 1 tokens);
   rounds, proposed, accepted, the acceptance rate, decode tokens/s and
   ms a round beside the plain engine's, the share of tokens that agree
   with it, and peak memory; then phase 5's model is freed;
6. the kernel path against the plain path for one training step at
   depth 2 (full width, batch 1 x 2048): loss and every adapter
   gradient;
6b. the peak memory of one train step at depth 2 (batch 2 x 2048)
   without remat, with the step's ``remat=True`` and with
   ``cfg.remat``; the three losses must be bit-identical; then every
   model of the driver is freed;
9a. ``HorovodRunner(np=1)``: one gang worker on the card (a NCCL group
   of one) runs phase 5's configuration at full width through
   ``hvd.broadcast_parameters`` (``replicate``), ``shard_batch`` and
   AdamW wrapped in ``hvd.DistributedOptimizer`` (the ~27 MB of fp32
   adapter gradients reduced over NCCL at every step): one warm-up step
   and 3 timed ones; the loss must fall, each flash counter, zeroed
   after the warm-up, read 32 x 3, the worker's ``log_to_driver`` line
   reach the driver's stdout and its result the driver, a battery of
   collectives on CUDA tensors (over NCCL at world size 1) return their
   inputs' values, and ``observe.mem.device_peak_bytes()`` in the rank
   equal ``torch.cuda.max_memory_allocated`` of the card ``hvd.init()``
   bound; ms a step
   beside phase 5's, the gang's start seconds and the adapter
   reduction's ms;
9b. ``HorovodRunner(np=-2)``: two ranks on the one card (so gloo), depth
   4 at full width, the global batch 2 x 2048 one row a rank, 3 steps:
   ``hvd.check_synchronized`` on the adapters in both ranks, a battery
   of collectives on CUDA tensors against their expected values, each
   flash counter at 4 x 3 a rank, and rank 0's adapters and the losses
   against a single-process run of the same 3 steps on the whole
   global batch in the driver (same weights, microbatches of one row);
9c. a supervised ``HorovodRunner(np=1)`` at 9a's configuration
   (``supervisor.policy`` set to one retry, restored afterwards): 4
   steps in all, each followed by an async ``TrainCheckpointer`` save of
   the adapters and the AdamW state (~82 MB), its write joined, then a
   barrier; after step 1's save the worker SIGKILLs itself, the
   supervisor relaunches the gang once, and the new worker restores step
   1 onto the card and runs steps 2-3; the run must show one relaunch
   from step 1, the moments on the card, each flash counter at 32 x 2,
   and steps 2-3's losses and the final adapters' sha256 equal to 9a's
   bit for bit; it prints the snapshot and write ms of every save, the
   checkpoint's bytes, the restore ms, the seconds from the kill to the
   first resumed step, and the run's wall seconds beside 9a's;
15. sequence-parallel LoRA fine-tuning: ``HorovodRunner(np=-2)``, two
   ranks on the one card (gloo), ``make_mesh(MeshSpec(seq=2))``, phase
   5's configuration at depth 2 (``SEQ_DEPTH``) with ``attention_fn``
   the mesh's ``make_ring_attention`` (ring-flash on the card: B1-B3
   inside a two-ring backward), one sequence of 8192 tokens (4096 a rank at
   their global positions), the fused loss, 3 steps: step 0's loss
   (within 1e-2) and adapter gradients (within 2^-5 of each norm)
   against one process running the whole sequence through
   ``flash_attention``; step 0 under ``overlap=True`` and ``False``
   bit-identical; the flash counters at one call a live hop a layer a
   step (rank 0 one, rank 1 two: the later block is masked and launches
   nothing); the hops a tensor (a forward n - 1 of K/V, a step n - 1 more
   of K/V and n of the fp32 dk/dv accumulators, a layer); the adapters
   the same on both ranks; ms a step, tokens/s, each hop's ms alone,
   the hops' exposed ms inside the timed steps and their share of the
   step, peak memory a rank;
16. the GPipe pipeline: ``HorovodRunner(np=-2)``, a ``stage`` mesh of
   the two ranks (``make_named_mesh``), the stage function two
   Llama-3-8B-width decoder blocks (bf16, flash attention, every weight
   trainable), 8 microbatches of 1 x 2048: the outputs (within one bf16
   ulp) and every stage weight's gradient of sum(out^2) (within 2^-5 of
   its norm) against the four blocks in order in one process; both
   schedules bit-identical in outputs and gradients, 10 and 9 ticks, the
   flash counters at two calls a tick (forward, dq, dk/dv); ms a
   pipeline step under each schedule, the bubble share and the hop's ms;
17. MoE serving: Mixtral-8x7B's widths (MIXTRAL: 8 experts, top-2,
   vocab 32000, every layer MoE) at depth 16, int8 attention and head,
   bf16 experts, fp32 routers, through
   phase 3's paged engine on phase 3's requests; every request on its
   budget, the paged decode at 16 and the int8 matmul at 65 launches a
   decode step (and 65 a prefill), counted against the engine's counts;
   decode ms a step beside the experts' byte bound, prefill ms,
   tokens/s, peak; the depth-2 logits through the kernels against the
   plain versions (phase 4's tolerance); phase 2 also times the int8
   matmul at the head's N = 32000 on fp32 x (M 8 and 512);
18. MoE LoRA training: the same widths at depth 8, LoRA rank 16 on q
   and v, flash attention, batch 1 x 2048, CE + 0.01 x ``moe_aux_loss``,
   AdamW on the adapters, a warm-up and 3 timed steps and one profiled:
   the losses finite, each layer's load-balance loss in [top_k,
   E x top_k], each flash counter at 8 x 3; ms a step, tokens/s, peak;
   the depth-2 loss and adapter gradients through the kernels against
   the plain versions (phase 6's tolerance);
19. expert parallelism: ``HorovodRunner(np=-2)``, two ranks on the one
   card (gloo), ``make_named_mesh("expert")``, one MoE layer at
   Mixtral's width, 4 experts a rank; the psum form on 2 x 2048
   replicated tokens and the all-to-all form on 2048 a rank, at no-drop
   capacity (E / top_k) and at 1.25, forward and backward: outputs and
   every rank's gradients against the single-process layer on the same
   tokens within bf16 tolerance (at 1.25 the rows whose experts all won
   a slot); ms a call by form and the collectives' host ms inside it;
20. tensor-parallel LoRA training: ``HorovodRunner(np=-2)``, two ranks on
   the one card (gloo), ``make_mesh(MeshSpec(model=2))``, phase 5's
   configuration (rank 16 on q and v, flash, bf16 base) at depth 4, each
   rank 16 query heads and 4 kv heads and half the vocabulary 128256,
   every rank's weights from one seed (every ``lora_b`` non-zero), batch
   1 x 2048, the vocabulary-parallel fused loss, AdamW on the adapters
   with no ``DistributedOptimizer``, 3 steps; then a
   ``TrainCheckpointer.save`` of the adapters with its sharding sidecar
   (every rank), restored by ``restore(target_mesh=...)`` onto a
   one-rank mesh in the launching process, into a whole single-card
   model of the same depth. Gates: step 0's loss within phase 6's tolerance of a
   single-process run of the same weights and batch, and its adapter
   gradients (gathered with ``full_host_value``) no farther from the
   fp32 gradients of the same weights than twice that run's; the
   adapters after step 1 within 2^-5 of their norms of that run's;
   both ranks' whole adapters identical; the collectives of a forward
   and of a backward, and 4 x 3 launches of each flash kernel a rank,
   as the model predicts; the restored adapters bit-identical to the
   gathered ones, and the single-card model's loss with them the TP
   model's at the saved step (phase 6's tolerance). It prints ms a step,
   tokens/s, the collectives' host ms a step and their share of the
   step, peak memory a rank, save ms and sidecar bytes, the resharded
   restore's ms and bytes moved. It bypasses NCCL: the collectives are
   gloo's host staging;
21. ZeRO-3 (``fsdp``), run last, two ranks on the one card over gloo
   (``HorovodRunner(np=-2)``, ``make_mesh(MeshSpec(fsdp=2))``), each
   rank storing half of every weight the rules split over ``fsdp`` and
   gathering each decoder block whole before its forward and again in
   its backward. 21a, LoRA training: phase 20's model at depth 2, a
   global batch of 2 x 2048 (one row a rank through ``shard_batch``),
   the fused loss, AdamW, 1 untimed and 3 timed steps; gates: each
   rank's losses within phase 6's tolerance of one process running the
   same weights on the same 2 rows, both ranks' losses equal, step 0's
   averaged adapter gradients and the update of steps 0-1 held against
   an fp32 twin as phase 20 holds them, both ranks' adapters identical,
   each rank's resident parameter bytes what ``param_sharding`` gives,
   the gathers, reduce-scatters and all-reduces a step as
   ``PERF.md`` predicts, and 2 x 3 launches of each flash kernel a
   rank; it prints ms a step, tokens/s, the gathers' host ms inside the
   timed steps and their share, peak memory a rank beside the whole
   model's weight bytes. 21b, int8 serving: phase 3's weights rebuilt
   by each rank from the shared seed at depth 2, phase 3's first 4
   requests with budgets of 16; gates: both ranks' tokens identical and
   equal to a single-rank engine's on the same weights in the launching
   process, the B4 and B5 launches and the collectives as the engine's
   counts predict; it prints ms a decode step, prefill ms and the
   gathers' share of a decode step;
22. HorovodRunner on Spark, run last, through the repo's pyspark double
   (``tests/minispark/shim``: the card machine has no pyspark; it runs
   real executor processes and a real barrier, and bypasses real
   Spark's scheduler) with a session of one slot active. 22a:
   ``HorovodRunner(np=1)`` runs phase 9a's configuration as a barrier
   job (one executor process, a NCCL group of one on ``cuda:0``); gates:
   9a's rank checks (losses falling, 32 x 3 launches of each flash
   kernel, adapters synchronized, the collective battery, the
   ``log_to_driver`` line on this stdout) and the losses within phase
   6's tolerance of 9a's; it prints whether they are bit-identical, ms a
   step and ``ready_s`` beside 9a's, peak memory and the run's wall
   seconds. 22b: ``np=2`` on the one-slot session raises
   ``SlotExhaustionError`` before any barrier job starts. 22c: this
   process claims the host's card slots, a timer releases them after
   3 s, and a local ``HorovodRunner(np=1)`` meanwhile runs one
   ``hvd.allreduce_`` of a CUDA tensor and one flash forward against its
   plain version (B 1, S 256, H 8, D 128, causal); gates: its slot
   claim waited at least 3 s, the results are right. 22d: the same main
   as one rank on ``fakeremote.invalid`` through a fake remote shell
   that records its argv and runs the rest here; gates: the rank read
   its secret from standard input, the argv holds neither the secret
   nor the payload, the rank's backend is ``cpu:gloo,cuda:nccl``, the
   flash forward matches its plain version. This machine has no
   network, so phase 22 resolves no name: the routable address is
   loopback and ``.invalid`` names are remote.
23. the model zoo, BASELINE.json configs 1-3 at full width, run last,
   each trained through ``HorovodRunner`` on seed-made data with
   seed-made weights (flax's initialisers). 23a: ``MnistCNN`` (fp32),
   ``np=-1`` (in-process on the card), batch 64, Adam 1e-3, a warm-up
   and 20 timed steps; gate: the losses finite and falling. 23b:
   ``ResNet50()`` (bf16 convolutions through cuDNN, fp32 batch norms,
   1000 classes), ``np=1`` (a NCCL group of one) with
   ``hvd.DistributedOptimizer`` over SGD 0.1, momentum 0.9, 128 x 224 x
   224 x 3 NHWC images, 2 warm-up and 5 timed steps. 23c:
   ``BertForQuestionAnswering(BertConfig.base())`` (bf16, vocab
   30522), ``np=1``, AdamW 3e-5 with weight decay 1e-4 (optax's
   default, set explicitly), 32 x 384 tokens with padding masks of
   lengths 128-384 (the masked attention path), start CE + end CE, as
   23b's steps. Gates of 23b and 23c: the gang's losses within 2^-10 of
   the same steps run in this process; every running statistic moved
   (23b); the bf16 logits of 4 samples within ZOO_BF16_TOL of an fp32
   twin of the same weights (the largest error over the largest
   logit; TF32 off). Each prints ms a step, samples/s, model TFLOP/s
   (``benchmarks/model_bench.py``'s counts), peak memory, and one more
   step of the in-process run under ``torch.profiler``. 23d: an HF
   ``LlamaForCausalLM`` state dict at Llama-3-8B's widths and depth
   (bf16 on the card, normal(0.02), norms 1 + normal(0.02), its own
   ``lm_head.weight``; the config a plain object with HF's attribute
   names: the card machine has no ``transformers``) through
   ``params_from_hf``, the port's ``Llama`` and ``params_to_hf``:
   bit-identical to the input; then ``quantize_llama_params`` to int8
   and phase 3's first 4 requests through the paged engine; gates:
   every request on its budget, the B4 and B5 launches, zeroed just
   before the run, what the engine's counts predict. It prints the
   conversion's seconds each way and the peak memory.
24. gang and serving telemetry, the port's module settings switched on
   (``observe.TELEMETRY_DIR`` a temporary root; no environment
   variable). 24c, right after phase 14 on phase 3's int8 model: phase
   3's engine behind the HTTP ``ServingFrontend``, phase 3's first 8
   requests from 8 urllib clients started together (odd ones streamed;
   the engine's first burst waits for all 8, so its steps depend on the
   requests alone), first with the switch off, then on; gates: every
   request's ``request`` span and its instants ``submit <= admit <=
   first_token <= done`` on its own track, ``server_ttft_seconds``
   counting 8, ``engine_decode_chunks_total`` equal to the chunks the
   engine ran, ``mem`` category ``kv_pages`` equal to the pools' bytes,
   a flight-recorder ring in the run dir, and the B4 and B5 launches
   (zeroed before each run) equal on and off. 24a, after 23d: 9a's
   fine-tune (``np=1``, NCCL group of one) with its step in
   ``instrument_step`` (phase 5's FLOPs a step registered), heartbeat
   ``TELEMETRY_HEARTBEAT_S``, 2 warm-up and 5 timed steps, a
   ``TrainCheckpointer`` save after step 2; gates: the run dir's
   ``timeline.json`` (1 compile and 6 execute ``train_step`` spans,
   ``checkpoint.save``, ``worker.start`` and ``worker.exit`` on rank 0's
   lane, ``gang.attempt`` on the driver's), ``metrics.prom``,
   ``metrics.json`` and ``perf.json`` (each step's components summing
   to its span), ``train_step_total{phase="execute"}`` 6, the MFU gauge
   in (0, 1.05] against the H100's peak, ``mem_bytes`` of ``params`` and
   ``opt_state`` equal to the tensors' bytes, ``device_hbm_bytes``
   ``limit`` the card's memory, a heartbeat received, no stall, and
   each flash kernel's launches a layer a step. 24b: the same model at
   depth 2 under one retry (heartbeat 0.5 s, stall window 5 s);
   attempt 0 takes a step and wedges inside an allreduce that no peer
   joins; gates: one hang verdict, a stack dump naming the wedged
   frame, the ``hang`` failure classified transient, one restart,
   attempt 1's two steps, both attempts' lanes and attempt 0's step in
   the recovered flight-recorder tail. Each prints its numbers on a
   line of its own.
25. the live tier and the readers. 25b, right after 24c on phase 3's
   int8 model: phase 14's ``FleetFrontend`` at one replica, registered
   with a ``StatuszServer`` of this process, serves phase 3's first 8
   requests at once; gates: ``/statusz`` scraped during the burst shows
   the one replica's row and the queue depth, the B4 and B5 launches
   (zeroed before) what the engine's counts predict, and the alert rule
   ``server_ttft`` fires once with ``alerts.TTFT_P99_S`` half the
   fleet's p99 bucket and not with it twice that. 25a, after 24b: 9a's
   fine-tune (``np=1``) with the telemetry, the alert engine, the perf
   forensics on alert and the status server (port 0) switched on
   (module settings: a ``ALERT_SETTINGS["alerts.WINDOW_S"]`` window, a
   factor of 2, 3 steps a window, a capture of 2 steps); 2 warm-up and
   ``ALERT_HEALTHY`` healthy steps, then ``ALERT_SLOWED`` slowed steps,
   each running the trainer's step ``ALERT_SLOW_FACTOR`` times inside
   one ``instrument_step`` span (real card work, about 3x); the driver
   scrapes ``/statusz`` and ``/metrics`` as it runs; gates: exactly one
   alert, ``step_time_regression`` on rank 0, after the first slowed
   step began; its PROFILE_REQ answered by PROFILE_DONE (no profiler
   error) before the gang ends; the ``torch.profiler`` trace of the 2
   captured steps naming ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` exactly as often as the launch counters rose over
   those steps (32 layers x 3 x 2 = 192 each); ``regression_report.json``
   naming compute as the component that grew over the window that fired,
   and the captured steps' compute at 2.5x the baseline's at least; the
   run dir's ``alerts.json`` and ``regression_report.json`` rendered by
   the port's doctor; a mid-run ``/statusz`` carrying rank 0's step, beat age and
   perf window, rendered by ``top``; ``/metrics`` parsing. It prints
   the seconds from the first slowed step to the alert and from the
   alert to PROFILE_DONE, the captured steps' ms beside the other slowed
   steps', the ``/statusz`` latency and the phase's wall seconds.
26. an elastic round trip, last: 9b's LoRA fine-tune (depth 4, two
   ranks sharing the card over gloo, ``data=2``, 9b's batch and seed) as
   one supervised ``HorovodRunner(np=-2)`` launch of ``ELASTIC_STEPS``
   steps, each saved with ``TrainCheckpointer.save(mesh=)`` under the
   policy's ``resume_dir``, the model's tree registered with
   ``analysis.register_gang_sharding`` on ``{"data": 2}``, the telemetry
   on. The fault injection kills rank 1 after step
   ``ELASTIC_KILL_AFTER``; the elastic controller (the file probe at 1)
   clamps the relaunch to one rank, which binds the card (NCCL, a world
   of one) and restores onto ``data=1``; once step
   ``ELASTIC_GROW_AFTER`` is committed the phase writes 2, and the
   controller plans a grow and recycles the gang at its next committed
   step; the two ranks restore onto ``data=2`` and train to the end.
   Gates: one kill, three attempts of worlds [2, 1, 2], restart contexts
   carrying ``{"data": 2}`` -> ``{"data": 1}`` and back, the restores
   resharding shrink then grow, each step's loss within 2^-10 of an
   in-process twin's at the same global batch (in as many microbatches
   as the world that committed the step had ranks) and each adapter's
   change
   within 2^-5 of the twin's (9b's tolerances), B1-B3 launched layers x
   steps on each rank of each attempt, the pre-flight's
   ``gang.reshard_preflight`` instants and ``elastic.json``'s decisions;
   the twin's last step runs under ``profiler.trace`` with
   ``annotate("phase26.step")``, whose Chrome trace must name the region
   and B1. It prints the seconds from the kill to the shrunken gang's
   first step, from the capacity's return to the grow decision and from
   the decision to the regrown gang's first step (each relaunch by
   stage: to the launch, to ``hvd.init``, the model built, restored,
   the first step), the ms a step at np 2, 1 and 2, and the phase's
   wall seconds.

27a. BERT on a mesh, last: phase 23c's BERT-base SQuAD (32 x 384,
   AdamW 3e-5, every weight trained) as ``HorovodRunner(np=-2)``, two
   ranks sharing the card over gloo, on ``MeshSpec(model=2)`` (6 heads
   a rank) and then ``MeshSpec(fsdp=2)`` (16 rows a rank, the 12
   blocks gathered by ZeRO-3), ``BERT_MESH_STEPS`` steps of
   ``make_train_step`` on each, every collective counted and timed;
   then the same steps in this process (the whole model, the whole
   batch): each mesh's losses within 2^-10 relative of these (phase
   20's rule), both ranks' alike. It prints ms a step beside 23c's,
   the collectives' host ms and their share of the step, and the peak
   a rank.

28. tuning and the runtime's own lints. 28a, right before 24a: the
   autotuner (``python -m sparkdl_tpu_torch.perf.autotune --bench
   serve``, its ``main`` in this process) over the decode chunk's
   default (16) and ``AUTOTUNE_VALUE``, ``--max-trials 4``; each trial
   a subprocess of ``perf.trial serve`` at Llama-3-8B width cut to
   ``AUTOTUNE_DEPTH`` layers, int8 weights, pages of 64, 8 slots, behind
   a one-replica ``FleetFrontend``, 4 streamed clients x 4 requests of
   64 prompt and 128 new tokens; the profile emitted under a temporary
   directory's ``h100`` key. When the search keeps the defaults (the
   value ties at this depth), its proof-or-degrade step
   (``autotune.verify_and_emit``) runs on the value all the same, so
   every run takes the 2 verification trials. Gates: one trial of the
   value, 4 ledger lines, every trial's
   ledger line with 4 rounds of tokens/s, its B4 and B5 launches over
   the traffic (counted in the trial's process, zeroed before it) what
   its engines' decode steps and forwards predict, none of another
   kernel, a ``verified`` or ``degraded`` profile with its evidence.
   28b and 28c ride 24a: ``perf.profile.PROFILE`` set to 28a's
   directory, the launcher's pre-flight applies the profile and the
   rank reports the serve settings in force (the profile's value or the
   default); ``locksan.ENABLED`` on the driver (the supervisor installs
   it) and the rank (its bootstrap does), no lock-order cycle or
   inversion in either report. 28d, right after 24a: with
   ``preflight.ENABLED``, ``HorovodRunner(np=1)`` over a ``main`` whose
   closure holds a CUDA tensor raises ``PreflightLintError`` with
   ``subprocess.Popen`` a tripwire that is never reached. It prints
   each trial's tokens/s, the decision and the profile's status, the
   pre-flight's times, the sanitizer's reports and, after 25a, its cost:
   24a's step under it beside 25a's healthy steps without it.
29. the GBDT estimators, last (no kernel of B1-B6 runs in them: their
   launch counts are zeroed before and read after, and must stay 0).
   29a: a binary:logistic fit of the shape of the UCI HIGGS dataset
   (11,000,000 rows x 28 float32 features, labels from a known signal
   of the seed), depth 8, 256 bins, learning rate 0.1, 20 rounds,
   through ``booster.train`` on the card, then ``Booster.predict_proba``
   on every row. Gates: the train logloss falls every round, the
   accuracy clears the floor the signal's Bayes accuracy gives, a fit of
   the first 100,000 rows on the card agrees with the port's CPU fit of
   them as the CPU tests hold two packages' forests (the same trees up
   to a split that is a near-tie, then the row-order tolerance), and the
   card's margins equal a host descent of the same trees bit for bit. It
   prints the host edges' and the card binning's times, the binned
   matrix's bytes, seconds a round, one tree's histogram, split, route
   and predict milliseconds (CUDA events around the stages that
   ``booster._build_tree`` calls) and the histogram's bytes and time
   beside HBM's rate. 29b: ``XgboostClassifier(num_workers=2,
   force_repartition=True)`` on a pandas frame of the first 500,000
   rows, 10 rounds: the estimator's ``launch_gang(per_rank_kwargs=)``
   gang of two ranks sharing the card over gloo, each rank's main
   wrapped by this script's own (its ``booster.train`` and
   ``hvd.allreduce`` observed: the ranks allgather their trees' digests,
   identical, and time each level's histogram all-reduce), then
   ``transform`` through the minispark double's ``mapInPandas``;
   accuracy within 0.5 points of one process's fit of the rows. 29c: one
   ``python -m sparkdl_tpu_torch.perf.trial gbdt`` subprocess at
   ``gbdt_bench.py``'s full shape; its ledger line's rows x trees a
   second and predict rows a second.
30. the frameworks, last, in this process (it starts no process; no
   kernel of B1-B6 runs in it: their counts are zeroed before and must
   stay 0). 30a: ``prefetch_to_device(device="cuda")`` over 16 batches
   at 23b's ResNet-50 input (128 x 224 x 224 x 3 fp32, 77 MB), cycled
   from 3 host batches made once, the producer sleeping PF_PRODUCE_S a
   batch, each batch fed to a card step of bf16 matmuls of about that
   time which compares it with its host batch on the card and reads a
   scalar; beside it the serial loop (a pageable copy a batch). Gates:
   every batch bit for bit; every copy, watched as it is issued
   (``Tensor.to``), from pinned memory and on a stream other than the
   step's; the prefetched loop under 2x the serial one. It prints host-to-card GB/s
   pinned and pageable, both loops' seconds, the mean ``data.wait``
   span a step, and its own time by part. 30b and 30c, under
   ``HorovodRunner(np=-1)``: ``from_numpy_like`` with a CUDA bf16
   template gives CUDA bf16, ``hvd.allreduce`` and
   ``hvd.grouped_allreduce`` of card tensors stay on the card with their
   dtypes; the ``frameworks`` line (tensorflow's and keras's versions,
   or null); ``horovod.tensorflow`` and ``horovod.keras`` through
   ``importlib`` raise an ImportError that names tensorflow or keras
   where it is absent; where keras imports, BASELINE config 1's MNIST
   CNN (``examples/tf_keras_mnist.py``'s layers, synthetic data, 2
   epochs) is fit on Keras's torch backend through
   ``horovod.keras.DistributedOptimizer``,
   ``BroadcastGlobalVariablesCallback`` and the Keras-3 ``LogCallback``:
   its variables on the card, its losses finite and falling, both
   epoch lines in the log, its ms a step printed.
31. Llama-3.1-8B past its 8192-token original window, right after 25b,
   in this process (it starts no process). 31a:
   ``LlamaConfig.llama31_8b(max_cache_len=16384, quant="int8")`` at
   full width, its engine's model on phase 3's int8 tensors (no copy):
   a paged engine (4 slots, pages of 64, chunk 16, ``prefill_chunk``
   512) serves a 16,000-token prompt (1.95x the window) for 64 new
   tokens beside phase 3's first 3 requests; every request on its
   budget, the launches, zeroed just before the run, as the engine's
   counts predict, and ``observe.mem.device_peak_bytes()`` equal to
   ``torch.cuda.max_memory_allocated()`` at the run's end. It prints
   the long prompt's prefill seconds, ms a decode step with the long
   request in the batch, decode tokens/s and the peak. 31b: the same
   tensors at depth 2, the long prompt in 512-token segments and 4
   decode steps through one 256-page table, through the kernels and
   through the plain versions (each its own cache), every call's logits
   at phase 4's tolerance.
32. the graph lints, right after phase 12, in this process (it starts
   no process), on phase 5's fine-tuned model. 32a:
   ``parallel.train.lower_train_step`` traces phase 5's LoRA step (a
   fresh AdamW over the adapters, batch 2 x 2048) on ``meta`` tensors,
   ``analysis.lint_lowered`` lints the trace, then one real step runs
   with the flash counts zeroed and the card's peak reset just before
   it. Gates: the trace's B1, B2 and B3 events equal the real step's
   launches (32 each); its FLOPs within 5 % of ``_lora_step_flops``; its
   static budget (inputs + outputs + peak temporaries) within 20 % of
   the real step's peak (``max_memory_allocated`` less what the process
   held before the step beyond the step's inputs); the trace adds under
   1 MiB of card memory (its own ``max_memory_allocated`` above what was
   held); the model's state is unchanged by the trace; no ERROR finding.
   It prints the trace's seconds, ops, kernel events, FLOPs, budget, the
   card memory it added and the findings. 32b: with
   ``preflight.ENABLED``, a 2-rank step in which rank 1 issues one extra
   ``hvd.allreduce`` registered with ``analysis.register_preflight``
   (``mesh={"data": 2}``): ``HorovodRunner(np=2).run`` raises
   ``PreflightLintError`` with ``collective-consistency``, and
   ``subprocess.Popen``, a tripwire, is never reached.
33. the fix engine and the port's own multichip program, right after
   phase 32, in this process. 33a: a functional step of SGD with
   momentum over every parameter of ``LlamaConfig.llama3_8b(n_layers=2,
   attention="flash")`` (random weights from the seed, bf16, 1 x 2048
   tokens; ``return p - lr * m2, m2, loss`` with ``lr`` a Python float)
   through ``analysis.fix_program`` (equivalence runs over the whole
   arguments): ``hoist-weak-scalar`` and ``donate-step-buffers``, each
   with its four proofs; then one original and one fixed step, each with
   the card's peak reset first. Gates: both fixes verified and applied,
   the measured peak drop within 10 % of the report's
   ``peak_hbm_bytes_saved``, the losses within phase 6's 2^-10, 12
   launches of each of B1-B3 (2 layers x 6 steps: 2 proof runs a fix,
   then the two). It prints the proofs, the predicted and measured
   drops, the traced budgets, the losses and the step times. 33b:
   ``analysis.__main__.main(["--graft", "8", "--comms", "--fix",
   "--dry-run", ...])``: ``graft_entry.build_multichip_step(8)`` (dp x
   tp x sp x pp x ep on a 2 x 2 x 2 mesh, tiny) traced as its 8 ranks on
   ``meta``. Gates: exit 0, the ranks' collective sequences equal, the
   ring's and the pipeline's hops and the data-parallel all-reduce
   there, no ERROR, a fixit report. It prints the findings by rule, the
   collectives by kind and axis, the fixit summary and the seconds.
   33c: ``graft_entry.dryrun_multichip(1)``: the graft program's step in
   local mode on the card (bf16, its ring of one through B1-B3): a
   finite loss, 2 launches of each.

Before it imports torch the script keeps Python's compiled bytecode in
``bytecode-cache/`` beside itself, for itself and every process it
starts (gang ranks, trials), whatever ``PYTHONDONTWRITEBYTECODE`` says:
where the installed packages hold no bytecode, each process would
otherwise compile torch and ``torch._dynamo`` from source. Each phase's
seconds are printed (``phase <name>: <s> s``) and kept in the report
(``phase_s``).

The last line is ``{"ok": true, "device": {...}}``; the lines before it
carry the kernels' record (``{"kernels": [...]}``) and the card.
"""

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the qmm shapes a TP=2 rank of phase 13 runs (its local slices: q
# 4096 -> 2048, k and v 4096 -> 512, gate and up 4096 -> 7168, o
# 2048 -> 4096, down 7168 -> 4096, the vocab-split head on fp32
# activations), then its prefill at a 512-token bucket; checked against
# the plain version, not timed
QMM_TP_SHAPES = [(8, 4096, 2048, "bf16"), (8, 4096, 512, "bf16"),
                 (8, 4096, 7168, "bf16"), (8, 2048, 4096, "bf16"),
                 (8, 7168, 4096, "bf16"), (8, 4096, 64128, "fp32"),
                 (512, 4096, 7168, "bf16"), (512, 7168, 4096, "bf16")]
# the qmm shapes phase 17 adds: Mixtral's head (4096 -> 32000) on fp32
# activations at a decode step (8 slots) and a 512-token prefill
QMM_MOE_SHAPES = [(8, 4096, 32000, "fp32"), (512, 4096, 32000, "fp32")]
# the paged decode's heads (q, kv) on phase 3's path and on a TP=2 rank
PAGED_HEADS = [(32, 8), (16, 4)]
# phase 31: Llama-3.1-8B past its 8192-token original window, a prompt
# of LONG_PROMPT tokens (1.95x the window) with LONG_NEW new ones beside
# phase 3's first LONG_COMPANIONS requests, in a cache of LONG_CACHE_LEN
# positions (tables of 256 pages of 64), prefilled LONG_PREFILL_CHUNK
# tokens a segment, LONG_SLOTS slots; phase 2 holds the paged decode at
# that step's lengths
LONG_PROMPT, LONG_NEW, LONG_COMPANIONS = 16000, 64, 3
LONG_CACHE_LEN, LONG_PREFILL_CHUNK, LONG_SLOTS = 16384, 512, 4
PAGED_LONG_LENS = (LONG_PROMPT, 777, 300, 64)

# int4 (B6) shapes: the decode step's projections and head as above, at
# group 64, then one prefill segment (prefill_chunk = 256 tokens)
Q4_GROUP = 64
PREFILL_CHUNK = 256
Q4_SHAPES = QMM_SHAPES[:5] + [(PREFILL_CHUNK, 4096, 14336, "bf16", 0,
                               False)]
# phase 7b: one shared prefix, the requests that extend it
PREFIX_LEN, N_PREFIX_REQUESTS = 512, 8
# phase 11: adapters stacked on phase 5's base; phase 12: the draft
# length and the requests served (phase 3's first; 8 until phase 27
# pushed the script toward 1100 s)
MULTI_LORA = 4
SPEC_K, N_SPEC_REQUESTS = 4, 4
# phase 13: the requests the tensor-parallel ranks serve (phase 3's
# first), which phase 27b's fleet serves; 27b's requests in flight when
# a rank is killed, sent again after the respawn with their budgets cut
# to TP_AFTER_BUDGET; phase 14: the fleet's replicas, its admission
# bound, the clients of its burst, of the burst at a faulting replica
# (which dies after that many decode chunks) and of the burst after its
# respawn (24, 32 and 8 until phase 27 pushed the script toward 1100 s)
N_TP_REQUESTS, N_TP_FAULT_REQUESTS, TP_AFTER_BUDGET = 8, 4, 16
# phases 13 and 27b: the TP engine's depth (32 until phase 27 pushed the
# script past 1100 s, 16 until phase 29 did, 8 until phase 33 did: two
# ranks share the card over gloo); phase 14's burst budgets (32-128 until
# phase 29 pushed the script past 1100 s, 32-64 until phase 33 did: two
# replicas in one process share its host)
TP_SERVE_DEPTH = 4
FLEET_REPLICAS, FLEET_MAX_QUEUE, N_FLEET_REQUESTS = 2, 12, 16
FLEET_BUDGETS = (16, 32)
N_FAULT_REQUESTS, FAULT_AFTER_CHUNKS = 4, 3

# flash shapes (B, S, H, D, causal): the training step's (one layer's
# call; 32 a step), then ragged S (no tile divides 1000), both head dims,
# then phase 15's ring hops (a rank's 4096 tokens against its own block,
# causal, and against an earlier rank's, not; kv heads repeated to 32),
# then phase 16's stage blocks (one microbatch of 2048, causal), then a
# TP=2 rank of phase 20 (its 16 local heads, kv heads repeated to them)
FLASH_SHAPES = [(2, 2048, 32, 128, True),
                (1, 1000, 4, 128, True),
                (1, 1000, 4, 128, False),
                (1, 1000, 4, 64, True),
                (1, 4096, 32, 128, True),
                (1, 4096, 32, 128, False),
                (1, 2048, 32, 128, True),
                (1, 2048, 16, 128, True)]

# the flash kernels' device ms a call at FLASH_SHAPES[0] before their
# Hopper redesign: the mma.sync kernels, timed by this script's phase 2b
# on one H100 80GB HBM3 at 700 W (PERF.md section 6, the B1, B2 and B3
# rows)
FLASH_OLD_MS = {"fwd": 0.674, "dq": 0.652, "dkv": 0.911}
# the int4 matmul's device ms a call at each Q4_SHAPES row before its
# tensor-core redesign (CUDA-core FMAs for every x), timed by this
# script's phase 2c on the same card (PERF.md section 6, the B6 row)
Q4_OLD_MS = [0.031, 0.016, 0.071, 0.070, 0.438, 1.421]
# the int8 matmul's device ms a call at each QMM_SHAPES row, and the
# paged decode's at phase 2's lengths, before their Hopper redesign
# (CUDA-core FMAs; one block a (row, kv head), pages in order), timed by
# this script's phase 2 on the same card (PERF.md section 6, the B5 and
# B4 rows), with their wrappers' host µs a call from the same run
QMM_OLD_MS = [0.0309, 0.0167, 0.0645, 0.0660, 0.386, 2.463]
QMM_OLD_HOST_US = [44.75, 57.70, 55.47, 59.00, 62.97, 47.31]
PAGED_OLD_MS, PAGED_OLD_HOST_US = 0.245, 47.84
# the kernels whose ptxas resources phase 1 prints, by source
PTXAS_KERNELS = {"flash_attention": ("flash_fwd_kernel",
                                     "flash_bwd_dq_kernel",
                                     "flash_bwd_dkv_kernel"),
                 "quantized_matmul_int4": ("q4mm_gemv_kernel",
                                           "q4mm_gemm_kernel",
                                           "q4mm_kernel"),
                 "quantized_matmul": ("qmm_gemv_kernel", "qmm_gemm_kernel",
                                      "qmm_kernel"),
                 "paged_attention": ("paged_split_kernel",
                                     "paged_merge_kernel",
                                     "paged_decode_kernel")}

# the training phase: batch x seq tokens a step, warm-up + timed steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 5

# phases 9a-9c: the np each HorovodRunner takes (a CPU rehearsal runs
# them in-process with -1), 9a's and 9b's timed steps, and 9b's depth
# (two copies of the model share the card)
GANG_NP = {"9a": 1, "9b": -2, "9c": 1, "13": -2, "15": -2, "16": -2,
           "19": -2, "20": -2, "21a": -2, "21b": -2, "22a": 1, "24a": 1,
           "24b": 1, "25a": 1, "26": -2, "27a": -2}
GANG_STEPS = 3
GANG_SHARED_DEPTH = 4
# phase 9c: the step after whose committed save the first attempt's rank
# is killed
RESUME_KILL_AFTER = 1
# phase 15: one sequence of Llama-3-8B's published context over the
# ranks' seq axis, its steps (3 until phase 27 pushed the script past
# 1100 s) and its depth (9b's 4 until phase 26 pushed the script past
# 1000 s); phase 16: the microbatches (1 x PIPE_SEQ
# tokens each) and the decoder blocks split over the stages
SEQ_TOKENS, SEQ_STEPS, SEQ_DEPTH = 8192, 2, 2
PIPE_MICROBATCHES, PIPE_SEQ, PIPE_BLOCKS = 8, 2048, 4
# phases 17-19: Mixtral-8x7B's published widths
# (mistralai/Mixtral-8x7B-v0.1 config.json; arXiv:2401.04088 Table 1),
# every layer MoE; 32 layers of bf16 experts (91.5 GB) exceed the card,
# so phase 17 serves 16 layers and phase 18 trains 8; phase 18's batch
# and steps; phase 19's tokens a rank (the
# psum form takes every rank's), its tight capacity factor and timed
# runs a form
MIXTRAL = dict(vocab_size=32000, d_model=4096, n_heads=32, n_kv_heads=8,
               d_ff=14336, rope_theta=1e6, rms_eps=1e-5, n_experts=8,
               moe_top_k=2, moe_every=1)
MOE_SERVE_DEPTH, MOE_TRAIN_DEPTH = 16, 8
MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2048, 3
EP_TOKENS, EP_CAPACITY, EP_RUNS = 2048, 1.25, 3
# phase 20: tensor-parallel LoRA training at Llama-3-8B width, depth cut
# to 2 (two ranks share the card, and every layer costs four host-staged
# 16 MiB all-reduces a step; 8 until phase 26 pushed the script past
# 1000 s, 4 until phase 27 pushed it past 1100 s), one row of 2048
# tokens, its steps
TP_TRAIN_DEPTH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 2, 2048, 3
# phase 21: ZeRO-3 on two ranks sharing the card, depth cut to 2 (21a:
# every block is gathered twice a step over gloo's host staging; 4 until
# phase 26 pushed the script past 1000 s) and to 2 (21b, int8 serving);
# 21a's global batch of 2 x 2048, one row a rank, and its timed steps (3
# until phase 27 pushed the script toward 1100 s); 21b's requests (phase
# 3's first) and their budget (16 until phase 27)
FSDP_TRAIN_DEPTH, FSDP_TRAIN_ROWS, FSDP_TRAIN_SEQ = 2, 2, 2048
FSDP_TRAIN_STEPS = 2
FSDP_SERVE_DEPTH, FSDP_SERVE_REQUESTS, FSDP_SERVE_BUDGET = 2, 4, 8
# phase 22: how long 22c's competing claim holds the card's slots, and
# the flash forward that 22c's and 22d's rank holds against its plain
# version (B, S, H, D, causal)
SLOT_HOLD_S = 3.0
SLOT_FLASH_SHAPE = (1, 256, 8, 128, True)
# phase 23: BASELINE.json configs 1-3 at full width: 23a the MNIST CNN
# (batch 64, a warm-up and 20 timed Adam steps), 23b ResNet-50 (128 x 224 x 224 x 3), 23c
# BERT-base SQuAD (32 x 384, padded lengths from BERT_MIN_LEN); the
# warm-up and timed steps of 23b and 23c; the np of each; and the
# tolerance of 23b's and 23c's bf16 logits against an fp32 twin, over
# the largest fp32 logit: the CPU tests saw 2.9e-3 (ResNet18Thin) and
# up to 8.8e-3 (tiny BERT) between each package's bf16 and fp32 models,
# and full depth compounds the rounding, so 2^-4. 23d: the requests
# (phase 3's first) the HF-converted int8 engine serves
MNIST_BATCH, MNIST_STEPS = 64, 20
RESNET_BATCH, RESNET_IMAGE = 128, 224
BERT_BATCH, BERT_SEQ, BERT_MIN_LEN = 32, 384, 128
ZOO_WARMUP, ZOO_STEPS = 2, 5
ZOO_NP = {"23a": -1, "23b": 1, "23c": 1}
ZOO_BF16_TOL = 2.0 ** -4
# phase 27a: 23c's model and batch on model=2 and then fsdp=2 (two ranks
# sharing the card), the steps on each (each mesh's steps are 94-96 %
# gloo's host-staged collectives)
BERT_MESH_STEPS = 2
HF_REQUESTS = 4
# phase 24: 24a's warm-up and timed steps (9a's model and batch), the
# step after which it saves, its heartbeat; 24b's depth, heartbeat and
# stall window (the hang's verdict comes a window after the wedge);
# 24c's requests (phase 3's first)
TELEMETRY_WARMUP, TELEMETRY_STEPS, TELEMETRY_SAVE_AFTER = 2, 5, 2
TELEMETRY_HEARTBEAT_S = 1.0
HANG_DEPTH, HANG_HEARTBEAT_S, HANG_STALL_S = 2, 0.5, 5.0
TELEMETRY_REQUESTS = 8
# phase 25: 25a's warm-up, healthy and slowed steps (9a's model and
# batch) and the trainer steps a slowed step runs in one span; the
# driver's settings (a window of ~10 healthy steps, which 3 slowed ones
# fill) and the ranks' (flushes fast enough for that window, a capture
# of 2 steps); 25b's requests (phase 3's first)
ALERT_WARMUP, ALERT_HEALTHY, ALERT_SLOWED, ALERT_SLOW_FACTOR = 2, 6, 12, 3
ALERT_SETTINGS = {"alerts.ENABLED": True, "alerts.WINDOW_S": 5.0,
                  "alerts.CHECK_S": 0.25, "alerts.MIN_STEPS": 3,
                  "alerts.STEP_FACTOR": 2.0, "forensics.ON_ALERT": True,
                  "statusz.PORT": 0}
ALERT_RANK_SETTINGS = {"observe.FLUSH_S": 0.5, "health.HEARTBEAT_S": 1.0,
                       "capture.STEPS": 2}
FLEET_STATUSZ_REQUESTS = 8
# phase 26: 9b's fine-tune (depth 4, two ranks sharing the card, 9b's
# batch and seed) through an elastic round trip: the steps in all, the
# step after which rank 1 is killed, the committed step after which the
# capacity file says 2 again, the pause after each committed step (the
# controller's polls need a step or two of the shrunken gang), and the
# elastic controller's settings (the file probe: the devices probe
# counts one card, which clamps two ranks a card at once)
ELASTIC_STEPS, ELASTIC_KILL_AFTER, ELASTIC_GROW_AFTER = 8, 1, 3
ELASTIC_PACE_S = 0.5
ELASTIC_SETTINGS = {"PROBE": "file", "CHECK_S": 0.2, "DEBOUNCE_S": 1.0,
                    "CKPT_WAIT_S": 60.0}
# Meta's Llama-3-8B config.json values under HF's attribute names (no
# transformers on the card machine: a plain object carries them)
# phase 28a: the autotuner's serve trials (perf/trial.py's traffic) at
# Llama-3-8B width, depth cut to 4 (8 until phase 33 pushed the script
# toward 1200 s), over one setting and one value other than its default
AUTOTUNE_DEPTH = 4
AUTOTUNE_KNOB = "sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK"
AUTOTUNE_VALUE = 8
AUTOTUNE_MAX_TRIALS = 4
AUTOTUNE_TRIAL_TIMEOUT_S = 300.0
# phase 29: the GBDT estimators. 29a at the UCI HIGGS dataset's shape
# (11M x 28 float32; rounds cut to 20 for the time limit), XGBoost
# hist's default 256 bins, depth 8; the labels' signal: a linear term in
# features 0-5 and a product of 6 and 7, with unit Gaussian noise
HIGGS_ROWS = 11_000_000
HIGGS_FEATURES = 28
GBDT_SIGNAL_W = (1.0, -0.8, 0.6, 0.5, -0.4, 0.3)
GBDT_PARAMS = dict(objective="binary:logistic", n_estimators=20,
                   max_depth=8, max_bin=256, learning_rate=0.1)
# the floor: 90 % of the way from chance to the signal's Bayes accuracy
GBDT_FLOOR_FRACTION = 0.9
# 29a's fit on the card and the CPU (200,000 rows until phase 33 pushed
# the script toward 1200 s: the CPU fit's 18 s)
GBDT_CPU_ROWS = 100_000
# tests/test_torch_booster.py's tolerances (_forest_agreement): the
# card's forest has the CPU's structure up to a near-tie, and after it
# (ORDER_TOL: another order of the float sums, as the card's atomic adds
# give) the class of 99.5 % of the rows and the train logloss within 1e-3
# relative
GBDT_ORDER_TOL = {"same_class": 0.995, "metric_rel": 1e-3}
# 29b: the first 500,000 rows (a gang start, each level's histogram
# staged through the host by gloo; 1M until phase 33 pushed the script
# toward 1200 s), 10 rounds, within 0.5 accuracy points
GBDT_GANG_ROWS = 500_000
GBDT_GANG_ROUNDS = 10
GBDT_GANG_POINTS = 0.5
# phase 30: the frameworks. 30a: prefetch_to_device over 16 batches at
# ResNet-50's input (23b's 128 x 224 x 224 x 3 fp32, 77 MB), cycled from
# a pool of 3 host batches made once, a host producer that takes
# PF_PRODUCE_S a batch and a card step of about as long; 30c: BASELINE
# config 1's MNIST CNN (examples/tf_keras_mnist.py: synthetic 28 x 28 x 1
# images, batch 64, 2 epochs) on Keras's torch backend, where keras imports
PF_BATCHES, PF_POOL = 16, 3
PF_SHAPE = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
PF_PRODUCE_S = 0.02
KERAS_ROWS, KERAS_BATCH, KERAS_EPOCHS = 2048, 64, 2
HF_LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, intermediate_size=14336,
                    rope_theta=500000.0, rms_norm_eps=1e-5,
                    max_position_embeddings=8192, rope_scaling=None)


class CheckFailed(RuntimeError):
    pass


def _require(ok, what):
    if not ok:
        raise CheckFailed(what)


def _log(msg):
    print(msg, flush=True)


def use_bytecode_cache():
    """Write and read compiled bytecode under ``bytecode-cache/`` beside
    this script, in this process and (through the environment) every
    process it starts. A process that imports torch without bytecode
    compiles it and ``torch._dynamo`` (a process's first optimizer
    imports it) from source: seconds of every rank's start, a gang's
    ``ready_s`` and ``opt_s`` (PERF.md)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bytecode-cache")
    os.makedirs(path, exist_ok=True)
    sys.pycache_prefix = path
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = path
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return path


PHASE_S = {}


def _timed(phase, fn, /, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds printed and kept under
    ``phase`` in :data:`PHASE_S`."""
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[phase] = time.perf_counter() - t
    _log(f"phase {phase}: {PHASE_S[phase]:.1f} s")
    return out


def _card_line(torch):
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def start_ptxas_report():
    """Start ``nvcc -Xptxas -v`` on each source of PTXAS_KERNELS (device
    code only, the library's own flags), beside the build; read by
    :func:`finish_ptxas_report`."""
    from sparkdl_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    started = []
    for src in PTXAS_KERNELS:
        out = os.path.join(_build.BUILD_DIR,
                           f"ptxas-{src}-{os.getpid()}.cubin")
        cmd = [_build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o",
               out, os.path.join(_build.CSRC, f"{src}.cu")]
        started.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), out))
    return started


def _ptxas_label(fn):
    """A readable name for a mangled kernel of PTXAS_KERNELS, or None:
    ``flash_fwd_kernel<128>``, ``q4mm_gemv_kernel<group 64>``,
    ``q4mm_kernel<fp32>``, ``paged_split_kernel<128>`` (D), and
    ``qmm_gemv_kernel<>`` for a kernel that is no template."""
    import re

    names = [n for ns in PTXAS_KERNELS.values() for n in ns]
    m = re.search(r"(" + "|".join(names) + r")(I?)(\w*)", fn)
    if m is None:
        return None
    name, template, rest = m.groups()
    if not template:
        return f"{name}<>"
    d = re.match(r"Li(\d+)E", rest)
    if name.startswith(("flash", "paged_split")) and d:
        return f"{name}<{d.group(1)}>"
    if name.startswith("q4mm_gem") and d:  # <k16 steps a scale group>
        return f"{name}<group {16 * int(d.group(1))}>"
    if name in ("q4mm_kernel", "qmm_kernel", "paged_decode_kernel"):
        return f"{name}<{'bf16' if 'bfloat16' in rest[:20] else 'fp32'}>"
    return f"{name}<{rest[:40]}>"


def finish_ptxas_report(started):
    """Registers, spills, stack and static shared memory of each
    instantiation of PTXAS_KERNELS, from ptxas's own report."""
    import re

    rows, current = {}, None
    for proc, out in started:
        text, _ = proc.communicate(timeout=600)
        if os.path.exists(out):
            os.remove(out)
        _require(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{text}")
        for line in text.splitlines():
            # ptxas's warnings, and its notes of wgmma serialisation
            if (("warning" in line or "Performance Loss" in line)
                    and current is not None):
                rows[current].setdefault("warnings", []).append(
                    line.strip())
            m = re.search(r"(?:Compiling entry function|Function properties"
                          r" for) '?(\w+)", line)
            if m:
                current = _ptxas_label(m.group(1))
                if current is not None:
                    rows.setdefault(current, {"static_smem_bytes": 0})
                continue
            if current is None:
                continue
            row = rows[current]
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    row[key] = int(m.group(1))
    want = [n for ns in PTXAS_KERNELS.values() for n in ns]
    _require(all(any(r.startswith(k + "<") for r in rows) for k in want),
             f"no ptxas report for every kernel of {want}: {sorted(rows)}")
    return rows


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


def _qmm_case(torch, qmm, gen, m, k, n, xname):
    """One int8 matmul case: inputs drawn at (M, K, N) with x in
    ``xname``, the kernel against its plain version. Returns the inputs
    and the error record."""
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    x = torch.randn((m, k), generator=gen, device=DEVICE).to(dtypes[xname])
    # every int8 value, -128 too (the kernel's contract takes any int8,
    # though quantize_int8 stops at -127), and one column all -128
    w_q = torch.randint(-128, 128, (k, n), generator=gen, device=DEVICE,
                        dtype=torch.int8)
    w_q[:, 1] = -128
    scales = torch.rand((n,), generator=gen, device=DEVICE) * 1e-2 + 1e-4
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
             f"quantized_matmul ({m}, {k}, {n}) {xname}: {bad} elements "
             f"beyond tolerance, max err {err.max().item()}")
    return x, w_q, scales, {"shape": [m, k, n], "x": xname,
                            "max_abs_err": err.max().item(),
                            "worst_err_over_tol": (err / tol).max().item()}


def check_quantized_matmul(torch, timer, gen):
    """Phase 2: the int8 kernel against its plain version at QMM_SHAPES,
    timed beside its bound, the plain version and the library call; then
    checked (not timed) at a TP rank's QMM_TP_SHAPES. Returns the timed
    rows and the TP rows."""
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    rows = []
    for (m, k, n, xname, calls, per_layer), old_ms, old_host_us in zip(
            QMM_SHAPES, QMM_OLD_MS, QMM_OLD_HOST_US):
        row = _qmm_timed_row(torch, timer, qmm, gen, m, k, n, xname)
        row.update({"calls_per_decode_step": calls, "per_layer": per_layer,
                    "old_ms": old_ms, "old_host_us": old_host_us})
        _log("qmm " + json.dumps(row))
        rows.append(row)
    # a generator of their own: the draws after phase 2 stay as they were
    tp_gen = _seeded(torch, SEED + 3)
    tp_rows = [_qmm_case(torch, qmm, tp_gen, *shape)[3]
               for shape in QMM_TP_SHAPES]
    _log("qmm_tp " + json.dumps(tp_rows))
    moe_gen = _seeded(torch, SEED + 17)
    moe_rows = [_qmm_timed_row(torch, timer, qmm, moe_gen, *shape)
                for shape in QMM_MOE_SHAPES]
    _log("qmm_moe " + json.dumps(moe_rows))
    return rows, tp_rows, moe_rows


def _qmm_timed_row(torch, timer, qmm, gen, m, k, n, xname):
    """One int8 matmul case (:func:`_qmm_case`) timed beside its bound,
    its plain version and the library call."""
    x, w_q, scales, checked = _qmm_case(torch, qmm, gen, m, k, n, xname)
    xb = x.element_size()
    nbytes = k * n + 4 * n + m * k * xb + m * n * xb
    flops = 2 * m * k * n
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[xname])
    row = {
        **checked,
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
    return row


def int4pack_ms(torch, timer, x, packed, scales, ref, mag):
    """The library yardstick of the int4 matmul: one
    ``torch._weight_int4pack_mm`` call on the same weights (x in bf16,
    scales bf16 with zero offsets: the scales are drawn bf16-exact, so
    ``(q + 8 - 8) * s`` is our weight), checked against the plain
    version's ``ref`` (to 2^-7 of the sum of |terms| ``mag``, for its
    bf16 arithmetic) and then timed; (None, reason) where the call is
    missing, refuses the shape or disagrees. It is never on the port's
    path."""
    from sparkdl_tpu_torch.ops.quantized_matmul import unpack_int4

    xb = x.bfloat16()
    group = x.shape[1] // scales.shape[0]
    # (N, K) unsigned nibbles q + 8, even k in the high nibble
    q = (unpack_int4(packed).t().to(torch.int32) + 8).to(torch.uint8)
    sz = torch.stack([scales, torch.zeros_like(scales)], 2).bfloat16() \
        .contiguous()
    try:
        w = torch._convert_weight_to_int4pack(
            ((q[:, 0::2] << 4) | q[:, 1::2]).contiguous(), 8)
        del q
        out = torch._weight_int4pack_mm(xb, w, group, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    err = (out.float() - ref.float()).abs()
    tol = 2.0 ** -7 * mag + _bf16_ulp(torch, ref.float())
    if bool((err > tol).any()):
        return None, (f"disagrees with the plain version: max err "
                      f"{err.max().item()}")
    return timer.ms(lambda: torch._weight_int4pack_mm(xb, w, group, sz)), ""


def check_quantized_matmul_int4(torch, timer, gen):
    """Phase 2c: the int4 kernel against its plain version at Q4_SHAPES,
    timed beside its bound, the plain version and the library call."""
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    rows = []
    for (m, k, n, xname, calls, per_layer), old_ms in zip(Q4_SHAPES,
                                                          Q4_OLD_MS):
        x = torch.randn((m, k), generator=gen, device=DEVICE).to(
            dtypes[xname])
        # every nibble value -8..7; scales bf16-exact (see int4pack_ms)
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen,
                               device=DEVICE, dtype=torch.int8)
        scales = (torch.rand((k // Q4_GROUP, n), generator=gen,
                             device=DEVICE) * 1e-2 + 1e-4).bfloat16().float()
        out = qmm.quantized_matmul_int4(x, packed, scales, group=Q4_GROUP)
        ref = qmm.quantized_matmul_int4_reference(x, packed, scales,
                                                  Q4_GROUP)
        torch.cuda.synchronize()
        # tolerance: the int8 check's. Both sum the same exact fp32
        # products in another order: the plain version x (q s), the
        # tensor cores s (sum of q x over a group) and the CUDA cores
        # x (q s) (at most 1e-5 of the sum of |terms|), and a bf16
        # output may land one ulp apart
        mag = x.float().abs() @ qmm._dequant_int4(packed, scales,
                                                  Q4_GROUP).abs()
        err = (out.float() - ref.float()).abs()
        tol = 1e-5 * mag + (_bf16_ulp(torch, ref.float())
                            if xname == "bf16" else 1e-6 * ref.abs())
        bad = int((err > tol).sum())
        _require(bad == 0 and bool(torch.isfinite(out).all()),
                 f"quantized_matmul_int4 ({m}, {k}, {n}) {xname}: {bad} "
                 f"elements beyond tolerance, max err {err.max().item()}")
        xb = x.element_size()
        nbytes = (k * n // 2 + 4 * n * (k // Q4_GROUP) + m * k * xb
                  + m * n * xb)
        flops = 2 * m * k * n
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[xname])
        row = {
            "shape": [m, k, n], "x": xname, "group": Q4_GROUP,
            "calls_per_decode_step": calls, "per_layer": per_layer,
            "max_abs_err": err.max().item(),
            "worst_err_over_tol": (err / tol).max().item(),
            "ms": timer.ms(lambda: qmm.quantized_matmul_int4(
                x, packed, scales, group=Q4_GROUP)),
            "plain_ms": timer.ms(lambda: qmm.quantized_matmul_int4_reference(
                x, packed, scales, Q4_GROUP)),
            "old_ms": old_ms,
            "host_us": timer.host_us(lambda: qmm.quantized_matmul_int4(
                x, packed, scales, group=Q4_GROUP)),
            "bound_ms": bound * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_FLOPS[xname] else "operations"),
            # the library call takes bf16 x: the fp32 head's x is cast,
            # as the int8 yardstick does
            "library_x": "bf16",
        }
        row["library_ms"], row["library_missing"] = int4pack_ms(
            torch, timer, x, packed, scales, ref, mag)
        _log("q4mm " + json.dumps(row))
        rows.append(row)
        del x, packed, scales, out, ref, mag, err, tol
    return rows


def _paged_case(torch, pa, q, k_pool, v_pool, lens_h, inactive, page,
                max_pages, perm):
    """One phase-2 paged case: each row's pages drawn from ``perm`` (the
    rows in ``inactive`` keep every entry on the dump page 0), the
    kernel against its plain version. Returns the inputs and the error
    record."""
    b = len(lens_h)
    tables_h = np.zeros((b, max_pages), np.int32)
    for i in range(b):
        if i not in inactive:
            used = -(-int(lens_h[i]) // page)
            tables_h[i, :used] = perm[i * max_pages:i * max_pages + used]
    tables = torch.as_tensor(tables_h, device=DEVICE)
    lens = torch.as_tensor(np.asarray(lens_h, np.int32), device=DEVICE)
    out = pa.paged_attention_decode(q, k_pool, v_pool, tables, lens)
    ref = pa.paged_attention_decode_reference(q, k_pool, v_pool, tables,
                                              lens)
    # both round each probability to bf16 before the PV product, the
    # kernel relative to its split's max and the plain version relative
    # to the row's (relative error <= 2^-9 a side, allowed 2^-8 of the
    # probability-weighted |v|), and both round the output to bf16 (one
    # ulp)
    weighted_abs = pa.paged_attention_decode_reference(
        q.float(), k_pool.float(), v_pool.float().abs(), tables, lens)
    err = (out.float() - ref.float()).abs()
    tol = 2.0 ** -8 * weighted_abs + _bf16_ulp(torch, ref.float()) + 1e-5
    bad = int((err > tol).sum())
    _require(bad == 0 and bool(torch.isfinite(out).all()),
             f"paged_attention_decode, lens {list(lens_h)}: {bad} elements "
             f"beyond tolerance, max err {err.max().item()}")
    return tables, lens, {"lens": [int(n) for n in lens_h],
                          "max_abs_err": err.max().item(),
                          "worst_err_over_tol": (err / tol).max().item()}


def check_paged_attention(torch, timer, gen):
    from sparkdl_tpu_torch.ops import paged_attention as pa

    b, d, page, max_len = 8, 128, 64, 2048
    max_pages = max_len // page
    n_pages = b * max_pages + 1
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    # the timed case: one token, a page boundary, one past it, mid,
    # full, ...; the last row is an inactive slot: every entry on the
    # dump page 0
    lens_h = np.array([1, 64, 65, 300, 1000, 2048, 777, 5], np.int32)
    checks = []
    # phase 3's heads (timed below), then a TP=2 rank's (check only;
    # another split plan; drawn from a generator of their own)
    for (h, hkv), heads_gen in zip(PAGED_HEADS,
                                   (gen, _seeded(torch, SEED + 2))):
        inputs = [torch.randn(shape, generator=heads_gen, device=DEVICE)
                  .bfloat16() for shape in ((b, h, d),
                                            (n_pages, page, hkv, d),
                                            (n_pages, page, hkv, d))]
        tables, lens, first = _paged_case(torch, pa, *inputs, lens_h,
                                          {b - 1}, page, max_pages, perm)
        # check-only cases at the split kernel's boundaries (its tokens a
        # split from the wrapper's plan): one token (every later split
        # empty), a length ending on a split boundary, one past it, two
        # splits, a split boundary past the first, full rows and an
        # inactive row; then every row at 2048
        plan = pa._split_plan(inputs[0], inputs[1], tables)
        span = max(plan[1], 1) * page
        edge = [1, span, span + 1, 2 * span, 2 * span + 1, max_len,
                max_len - 1, 7]
        cases = [_paged_case(torch, pa, *inputs, lens_h_, inactive, page,
                             max_pages, perm)[2]
                 for lens_h_, inactive in ((edge, {b - 1}),
                                           ([max_len] * b, set()))]
        if (h, hkv) == PAGED_HEADS[0]:
            q, k_pool, v_pool = inputs
            timed, (splits, per) = first, plan
        else:
            cases.append(first)
        checks += [dict(c, H=h, Hkv=hkv, splits=plan[0],
                        pages_per_split=plan[1]) for c in cases]
    # tables and lens depend on the lengths alone: the same for both
    h, hkv = PAGED_HEADS[0]
    bound_ms, bound_by = _paged_bound(lens_h, q, k_pool, tables)
    long = _paged_long(torch, timer, pa)
    row = {
        "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "page": page,
                  "lens": lens_h.tolist()},
        "splits": splits, "pages_per_split": per,
        "calls_per_decode_step": 1, "per_layer": True,
        "max_abs_err": max([timed["max_abs_err"], long["max_abs_err"]]
                           + [c["max_abs_err"] for c in checks]),
        "worst_err_over_tol": timed["worst_err_over_tol"],
        "boundary_checks": checks,
        "ms": timer.ms(lambda: pa.paged_attention_decode(
            q, k_pool, v_pool, tables, lens)),
        "plain_ms": timer.ms(lambda: pa.paged_attention_decode_reference(
            q, k_pool, v_pool, tables, lens)),
        "old_ms": PAGED_OLD_MS,
        "host_us": timer.host_us(lambda: pa.paged_attention_decode(
            q, k_pool, v_pool, tables, lens)),
        "old_host_us": PAGED_OLD_HOST_US,
        "bound_ms": bound_ms, "bound_by": bound_by, "long": long,
    }
    _log("paged " + json.dumps(row))
    return row


def _paged_bound(lens_h, q, k_pool, tables):
    """(ms, "bytes" or "operations") the card needs at least for one
    paged decode call: each visible K and V row, q, the output, the
    tables and lens moved once, or QK and PV at the bf16 peak."""
    _, h, d = q.shape
    hkv = k_pool.shape[2]
    visible = int(np.sum(lens_h))
    nbytes = (visible * hkv * d * 2 * 2 + 2 * q.numel() * 2
              + tables.numel() * 4 + len(lens_h) * 4)
    flops = visible * h * d * 2 * 2
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _paged_long(torch, timer, pa):
    """Phase 2's long shape: phase 31a's decode step (the 16,000-token
    request beside three short ones, tables of 256 pages of 64, bf16
    pools, phase 3's heads), the kernel against its plain version, timed
    beside its bound."""
    h, hkv = PAGED_HEADS[0]
    lens_h = np.array(PAGED_LONG_LENS, np.int32)
    b, d, page = len(lens_h), 128, 64
    max_pages = LONG_CACHE_LEN // page
    n_pages = b * max_pages + 1
    perm = np.random.default_rng(SEED + 31).permutation(np.arange(1, n_pages))
    gen = _seeded(torch, SEED + 31)
    q, k_pool, v_pool = [
        torch.randn(shape, generator=gen, device=DEVICE).bfloat16()
        for shape in ((b, h, d), (n_pages, page, hkv, d),
                      (n_pages, page, hkv, d))]
    tables, lens, check = _paged_case(torch, pa, q, k_pool, v_pool, lens_h,
                                      set(), page, max_pages, perm)
    splits, per = pa._split_plan(q, k_pool, tables)
    bound_ms, bound_by = _paged_bound(lens_h, q, k_pool, tables)
    row = {
        "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "page": page,
                  "max_pages": max_pages, "lens": lens_h.tolist()},
        "splits": splits, "pages_per_split": per,
        "max_abs_err": check["max_abs_err"],
        "worst_err_over_tol": check["worst_err_over_tol"],
        "ms": timer.ms(lambda: pa.paged_attention_decode(
            q, k_pool, v_pool, tables, lens)),
        "plain_ms": timer.ms(lambda: pa.paged_attention_decode_reference(
            q, k_pool, v_pool, tables, lens)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    row["ms_over_bound"] = row["ms"] / bound_ms
    return row


def _seeded(torch, seed, device=None):
    """A generator on ``device`` (default the card) seeded with ``seed``."""
    gen = torch.Generator(device=device or DEVICE)
    gen.manual_seed(seed)
    return gen


def random_quant_llama(torch, cfg, gen, device=None):
    """Llama at ``cfg`` with weights drawn on ``device`` (default the
    card), normal with std 0.02, each projection quantized to int8
    (``cfg.quant="int8"``) or to int4 at ``cfg.quant_group``
    (``"int4"``) as it is drawn, one matrix at a time; an MoE model's
    stacked experts (normal, std 0.02) stay bf16 and its routers
    (normal 0.02, bias zero) fp32. The same
    generator state on the same card type draws the same weights (phase
    13's ranks rebuild phase 3's)."""
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.ops.quantized_matmul import (
        quantize_int4,
        quantize_int8,
    )

    model = Llama(cfg, device=device or DEVICE)
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
            elif leaf == "kernel_q4":
                w = torch.randn((2 * p.shape[0], p.shape[1]),
                                generator=gen, device=p.device) * 0.02
                w_q, s = quantize_int4(w, group=cfg.quant_group)
                p.copy_(w_q)
                modules[owner].kernel_scale4.copy_(s)
                del w, w_q, s
            elif leaf in ("w_gate", "w_up", "w_down"):
                p.normal_(0.0, 0.02, generator=gen)
            elif owner.endswith("router") and leaf == "kernel":
                p.normal_(0.0, 0.02, generator=gen)
            elif owner.endswith("router") and leaf == "bias":
                p.zero_()
            elif leaf not in ("kernel_scale", "kernel_scale4"):
                raise CheckFailed(f"unexpected weight {name}")
    return model


def _requests(cfg, n=N_REQUESTS):
    """Phase 3's requests (prompts of 64-1024 tokens, budgets of
    32-128), which phases 10-12 serve again: the first ``n``."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (int(k),)).astype(np.int32)
               for k in rng.integers(64, 1025, N_REQUESTS)]
    budgets = [int(k) for k in rng.integers(32, 129, N_REQUESTS)]
    return prompts[:n], budgets[:n]


def _agreement(tokens, ref):
    """How far two runs of the same requests agree: the share of
    generated tokens equal to ``ref``'s at the same position of the same
    request, and the share that lies before a request's first
    disagreement (greedy decoding follows its own earlier tokens, so
    one near-tie decided otherwise changes the rest of the request)."""
    same = prefix = 0
    for a, b in zip(tokens, ref):
        eq = np.asarray(a) == np.asarray(b)
        same += int(eq.sum())
        prefix += len(eq) if eq.all() else int(np.argmin(eq))
    total = sum(len(b) for b in ref)
    return {"tokens": same / total, "before_first_difference":
            prefix / total}


def _zero_launches():
    from sparkdl_tpu_torch.ops import paged_attention as pa
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    qmm.quantized_matmul.launches = 0
    qmm.quantized_matmul_int4.launches = 0
    pa.paged_attention_decode.launches = 0


def _read_launches():
    from sparkdl_tpu_torch.ops import paged_attention as pa
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    return {"quantized_matmul": qmm.quantized_matmul.launches,
            "quantized_matmul_int4": qmm.quantized_matmul_int4.launches,
            "paged_attention_decode": pa.paged_attention_decode.launches}


def _flash_launches():
    from sparkdl_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _zero_flash():
    from sparkdl_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def serve(torch, model):
    """Phase 3: the main path, counters zeroed just before the run;
    returns the report and each request's tokens."""
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = model.cfg
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, device=DEVICE)
    prompts, budgets = _requests(cfg)
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]

    spent = _time_engine(torch, engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _require(launches.pop("quantized_matmul_int4") == 0,
             "the int8 run launched the int4 matmul")

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
    return report, [results[r] for r in rids]


def _depth2(model, device=DEVICE, llama_kw=None, **cfg_kw):
    """The first 2 layers of ``model`` (the same tensors), its config
    replaced by ``cfg_kw``, on ``device``; ``llama_kw`` (a mesh, a paged
    binding) goes to ``Llama.from_params``."""
    from sparkdl_tpu_torch.models.llama import Llama

    cfg = dataclasses.replace(model.cfg, n_layers=2, **cfg_kw)
    params = {k: v for k, v in model.state_dict().items()
              if not k.startswith("layers.") or k.split(".")[1] in ("0", "1")}
    return Llama.from_params(cfg, params, device=device, **(llama_kw or {}))


def _depth2_logits(torch, small, device, n_decode, seed):
    """The paged depth-2 check's run: one prefill of 100 tokens in two
    rows (pages 1, 2 and 4, 3) and ``n_decode`` decode steps through
    ``small`` on a fresh cache, the tokens drawn from ``seed``; each
    call's logits in fp32."""
    rng = np.random.default_rng(seed)
    vocab = small.cfg.vocab_size
    prompt = torch.as_tensor(rng.integers(0, vocab, (2, 100)), device=device)
    steps = torch.as_tensor(rng.integers(0, vocab, (n_decode, 2, 1)),
                            device=device)
    tables = torch.as_tensor([[1, 2, 0], [4, 3, 0]], dtype=torch.int32,
                             device=device)
    cache = small.init_cache()
    outs = [small(prompt, torch.arange(100, device=device)[None], tables,
                  cache)]
    for i in range(n_decode):
        pos = torch.full((2, 1), 100 + i, device=device)
        outs.append(small(steps[i], pos, tables, cache))
    return [o.float() for o in outs]


def _call_name(i):
    return "prefill" if i == 0 else f"decode {i}"


@contextlib.contextmanager
def plain_ops():
    """Route the models' kernel calls to their plain versions (the
    comparisons of phases 4, 6, 8, 10 and 13 only; the package has no
    such switch)."""
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import paged_attention as pa
    from sparkdl_tpu_torch.ops import quantized_matmul as qmm

    saved = (pa.paged_attention_decode, qmm.quantized_matmul,
             qmm.quantized_matmul_int4, fa.flash_fwd, fa.flash_bwd_dq,
             fa.flash_bwd_dkv)
    pa.paged_attention_decode = pa.paged_attention_decode_reference
    qmm.quantized_matmul = qmm.quantized_matmul_reference
    qmm.quantized_matmul_int4 = qmm.quantized_matmul_int4_reference
    fa.flash_fwd = fa.flash_attention_reference
    fa.flash_bwd_dq = fa.flash_bwd_dq_reference
    fa.flash_bwd_dkv = fa.flash_bwd_dkv_reference
    try:
        yield
    finally:
        (pa.paged_attention_decode, qmm.quantized_matmul,
         qmm.quantized_matmul_int4, fa.flash_fwd, fa.flash_bwd_dq,
         fa.flash_bwd_dkv) = saved


def kernel_vs_plain_model(torch, model, name="model"):
    """Phase 4 (int8) and 8 (int4): depth 2 of the same weights, one
    prefill of 100 tokens in two rows and 4 decode steps, through the
    kernels and through the plain versions; logits compared."""
    small = _depth2(model, decode=True, page_size=64, n_pages=8)
    with torch.no_grad():
        got = _depth2_logits(torch, small, DEVICE, 4, SEED + 1)
        with plain_ops():
            ref = _depth2_logits(torch, small, DEVICE, 4, SEED + 1)
    report = [_logits_row(torch, g, r, f"{name} {_call_name(i)}")
              for i, (g, r) in enumerate(zip(got, ref))]
    _log(f"{name} " + json.dumps(report))
    return report


def _check_budgets(engine, results, rids, budgets, vocab, phase):
    """Every request ended on its full budget with in-vocabulary tokens
    and finite logprobs <= 0."""
    for rid, budget in zip(rids, budgets):
        toks = results.get(rid)
        _require(toks is not None and len(toks) == budget
                 and engine.finish_reasons[rid] == "length",
                 f"phase {phase} request {rid}: "
                 f"{None if toks is None else len(toks)} tokens, budget "
                 f"{budget}, finished on {engine.finish_reasons.get(rid)}")
        _require(bool(((toks >= 0) & (toks < vocab)).all()),
                 f"phase {phase} request {rid}: token outside the "
                 "vocabulary")
        lps = engine.logprobs[rid]
        _require(bool(np.isfinite(lps).all() and (lps <= 1e-6).all()),
                 f"phase {phase} request {rid}: logprobs not finite and "
                 "<= 0")


def _logits_cmp(torch, got, ref, what):
    """One pair of logits compared: errors, scale, argmax agreement and
    whether ``got`` is finite."""
    err = (got - ref).abs()
    return {"call": what, "max_abs_err": err.max().item(),
            "logit_scale": ref.abs().max().item(),
            "mean_abs_err": err.mean().item(),
            "argmax_agree": float((got.argmax(-1) == ref.argmax(-1))
                                  .float().mean()),
            "finite": bool(torch.isfinite(got).all())}


def _require_logits(row):
    """Phase 4's tolerance on one compared pair: the max error within
    2^-4 and the mean within 2^-8 of the logits' scale (bf16 activations
    round at different points in the two paths, one ulp here and there,
    2^-8 relative; after two layers and the head the logits may move by
    a few of those ulps of their scale)."""
    scale = row["logit_scale"]
    _require(row["finite"] and row["max_abs_err"] <= 2.0 ** -4 * scale
             and row["mean_abs_err"] <= 2.0 ** -8 * scale,
             f"{row['call']} logits: {row}")
    return row


def _logits_row(torch, got, ref, what):
    """:func:`_logits_cmp` held to phase 4's tolerance."""
    return _require_logits(_logits_cmp(torch, got, ref, what))


def serve_dense(torch, model, phase3_tokens):
    """Phase 10: the int8 model over the dense slot cache: phase 3's 16
    requests through ``ContinuousBatchingEngine(page_size=0)``, then
    ``generate()`` on 2 x 128 prompt tokens for 32 new ones, each with
    the counters zeroed just before it; then, at depth 2, the kernel
    path against the plain path over the dense cache."""
    from sparkdl_tpu_torch.models.generate import generate
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = model.cfg
    per_forward = 7 * cfg.n_layers + 1
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=0, device=DEVICE)
    prompts, budgets = _requests(cfg)
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    spent = _time_engine(torch, engine, prefill="_admit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    stats = dict(engine.stats)
    _check_budgets(engine, results, rids, budgets, cfg.vocab_size, 10)
    # one prefill a request (none finishes at admission), then the steps
    want = per_forward * (stats["steps"] + len(rids))
    _require(launches["quantized_matmul"] == want,
             f"phase 10: {launches['quantized_matmul']} int8 launches, the "
             f"engine's {stats['steps']} steps and {len(rids)} prefills "
             f"predict {want}")
    _require(launches["paged_attention_decode"] == 0
             and launches["quantized_matmul_int4"] == 0,
             f"phase 10 launched another kernel: {launches}")
    tokens = [results[r] for r in rids]
    decoded = sum(budgets) - len(rids)

    rng = np.random.default_rng(SEED + 6)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 128)),
                             device=DEVICE)
    generate(model, None, prompt[:, :8], max_new_tokens=2, device=DEVICE)
    torch.cuda.synchronize()
    _zero_launches()
    t = time.perf_counter()
    out, lps = generate(model, None, prompt, max_new_tokens=32,
                        return_logprobs=True, device=DEVICE)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    gen_launches = _read_launches()
    _require(tuple(out.shape) == (2, 160)
             and bool(torch.equal(out[:, :128].long(), prompt))
             and bool(torch.isfinite(lps).all()),
             f"generate(): shape {tuple(out.shape)}")
    _require(gen_launches["quantized_matmul"] == per_forward * 32,
             f"generate(): {gen_launches['quantized_matmul']} int8 launches,"
             f" want {per_forward * 32} (a prefill and 31 steps)")

    small = _depth2(model, decode=True, page_size=0, n_pages=0)
    steps = torch.as_tensor(rng.integers(0, small.cfg.vocab_size, (4, 2, 1)),
                            device=DEVICE)

    def run():
        cache = small.init_cache(batch=2)
        outs = [small(prompt[:, :100], cache=cache)]
        outs += [small(steps[i], cache=cache) for i in range(4)]
        return [o.float() for o in outs]

    with torch.no_grad():
        got = run()
        with plain_ops():
            ref = run()
    logits = [_logits_row(torch, g, r, "dense prefill" if i == 0
                          else f"dense decode {i}")
              for i, (g, r) in enumerate(zip(got, ref))]
    del small
    report = {
        "requests": len(rids), "n_slots": 8, "page_size": 0, "chunk": 16,
        "n_layers": cfg.n_layers, "wall_s": wall,
        "decode_s": spent["decode"],
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "decode_tokens_per_s": decoded / spent["decode"],
        "prefill_s": sum(spent["prefill"]),
        "prefill_ms_mean": 1e3 * statistics.mean(spent["prefill"]),
        "peak_mem_gb": peak / 1e9,
        "agree_with_phase3": _agreement(tokens, phase3_tokens),
        "stats": stats, "launches": launches,
        "generate": {"batch": 2, "prompt": 128, "new_tokens": 32,
                     "s": gen_s, "tokens_per_s": 2 * 32 / gen_s,
                     "ms_per_step": 1e3 * gen_s / 32,
                     "launches": gen_launches},
        "logits": logits,
    }
    _log("dense " + json.dumps(report))
    return report


def _engine(model, **kw):
    """The int4 phases' engine: 8 slots, pages of 64, chunk 16,
    ``prefill_chunk`` 256, over ``model``'s own (quantized) weights."""
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    return ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                    chunk=16, page_size=64,
                                    prefill_chunk=PREFILL_CHUNK,
                                    device=DEVICE, **kw)


def _time_engine(torch, engine, prefill="_prefill_segment",
                 decode="_decode_chunk"):
    """Host clocks around the engine's own prefill and decode calls (by
    default its prefill segments and decode chunks; a dense engine
    prefills in ``_admit``, a speculative one decodes in ``_round``;
    each ends in a host copy or a synchronize, so the device is done);
    returns the dict they fill."""
    spent = {"prefill": [], "decode": 0.0}
    prefill_fn, decode_fn = getattr(engine, prefill), getattr(engine, decode)

    def timed_prefill(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill_fn(*a, **k)
        torch.cuda.synchronize()
        spent["prefill"].append(time.perf_counter() - t)

    def timed_decode(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_fn(*a, **k)
        spent["decode"] += time.perf_counter() - t
        return out

    setattr(engine, prefill, timed_prefill)
    setattr(engine, decode, timed_decode)
    return spent


def _http(fe, path, payload=None):
    """One request to the frontend (600 s timeout): the parsed JSON body,
    the SSE events with their arrival times, or the text."""
    import urllib.request

    url = f"http://{fe.address[0]}:{fe.address[1]}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=600) as r:
        if payload is None:
            return r.read().decode()
        if not payload.get("stream"):
            return json.loads(r.read())
        events = []
        for line in r:
            if line.startswith(b"data: "):
                events.append((time.perf_counter(),
                               json.loads(line[6:].strip())))
        return events


def serve_http(torch, model):
    """Phase 7: int4 serving behind the HTTP frontend, 16 concurrent
    clients (odd ones streamed), counters zeroed just before the run."""
    import threading

    from sparkdl_tpu_torch.models.server import ServingFrontend

    cfg = model.cfg
    engine = _engine(model)
    spent = _time_engine(torch, engine)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).tolist()
               for n in rng.integers(64, 1025, N_REQUESTS)]
    budgets = [int(n) for n in rng.integers(32, 129, N_REQUESTS)]
    fe = ServingFrontend(engine).start()
    replies = [None] * N_REQUESTS
    errors = []

    def client(i):
        payload = {"tokens": prompts[i], "max_new_tokens": budgets[i],
                   "stream": bool(i % 2)}
        t = time.perf_counter()
        try:
            replies[i] = (t, _http(fe, "/generate", payload),
                          time.perf_counter())
        except Exception as e:  # reported below as a failed request
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = _read_launches()
        metrics = _http(fe, "/metrics")
    finally:
        fe.close()
    _require(not errors and all(r is not None for r in replies),
             f"HTTP requests failed: {errors}")
    stats = dict(engine.stats)
    ttft, latency = [], []
    for i, (t_sent, reply, t_done) in enumerate(replies):
        latency.append(t_done - t_sent)
        if i % 2:
            toks = [e["token"] for _, e in reply[:-1]]
            _require(reply[-1][1] == {"done": "length"}
                     and all("token" in e for _, e in reply[:-1]),
                     f"streamed request {i} ended on {reply[-1][1]}")
            ttft.append(reply[0][0] - t_sent)
        else:
            toks = reply["tokens"]
            _require(reply["finish_reason"] == "length",
                     f"request {i} finished on {reply['finish_reason']}")
            _require(len(reply["logprobs"]) == budgets[i]
                     and all(np.isfinite(reply["logprobs"])),
                     f"request {i}: logprobs not finite")
        _require(len(toks) == budgets[i],
                 f"request {i} returned {len(toks)} tokens, budget "
                 f"{budgets[i]}")
        _require(all(0 <= t < cfg.vocab_size for t in toks),
                 f"request {i}: token outside the vocabulary")
    _require(f'server_requests_total{{code="200"}} {N_REQUESTS}' in metrics,
             "/metrics does not count 16 answered requests")
    want = {"quantized_matmul_int4": (7 * cfg.n_layers + 1)
            * (stats["steps"] + stats["prefill_segments"]),
            "paged_attention_decode": cfg.n_layers * stats["steps"]}
    for name, n in want.items():
        _require(n > 0 and launches[name] == n,
                 f"{name}: {launches[name]} launches on the main path, "
                 f"engine counts predict {n}")
    _require(launches["quantized_matmul"] == 0,
             f"the int4 run launched the int8 matmul "
             f"{launches['quantized_matmul']} times")
    decoded = sum(budgets) - N_REQUESTS
    report = {
        "requests": N_REQUESTS, "streamed": N_REQUESTS // 2, "n_slots": 8,
        "page_size": 64, "chunk": 16, "prefill_chunk": PREFILL_CHUNK,
        "quant": "int4", "group": cfg.quant_group, "n_layers": cfg.n_layers,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": int(sum(budgets)),
        "wall_s": wall,
        "decode_s": spent["decode"],
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "decode_tokens_per_s": decoded / spent["decode"],
        "prefill_s": sum(spent["prefill"]),
        "prefill_segment_ms_mean": 1e3 * statistics.mean(spent["prefill"]),
        "prefill_segment_ms_max": 1e3 * max(spent["prefill"]),
        "ttft_streamed_s": {"min": min(ttft),
                            "median": statistics.median(ttft),
                            "max": max(ttft)},
        "request_s": {"min": min(latency),
                      "median": statistics.median(latency),
                      "max": max(latency)},
        # the blocking clients alone: each is answered when its request
        # ends, not when the burst drains
        "request_s_blocking": {"min": min(latency[0::2]),
                               "median": statistics.median(latency[0::2]),
                               "max": max(latency[0::2])},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stats": stats, "launches": launches,
    }
    _log("http " + json.dumps(report))
    return report


def prefix_sharing(torch, model):
    """Phase 7b: one PREFIX_LEN-token prefix registered, then
    N_PREFIX_REQUESTS requests that extend it by 16-128 tokens."""
    cfg = model.cfg
    engine = _engine(model)
    spent = _time_engine(torch, engine)
    rng = np.random.default_rng(SEED + 4)
    prefix = rng.integers(0, cfg.vocab_size, (PREFIX_LEN,))
    t = time.perf_counter()
    pid = engine.register_prefix(prefix)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t
    free_before = len(engine._free_pages)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in rng.integers(16, 129, N_PREFIX_REQUESTS)]
    budgets = [int(n) for n in rng.integers(16, 65, N_PREFIX_REQUESTS)]
    rids = [engine.submit(p, b, prefix_id=pid)
            for p, b in zip(prompts, budgets)]
    t = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t
    stats = dict(engine.stats)
    for rid, budget in zip(rids, budgets):
        toks = results.get(rid)
        _require(toks is not None and len(toks) == budget
                 and engine.finish_reasons[rid] == "length",
                 f"prefix request {rid}: not on its budget {budget}")
    _require(stats["prefill_tokens_saved"] == N_PREFIX_REQUESTS * PREFIX_LEN,
             f"prefill_tokens_saved {stats['prefill_tokens_saved']}, want "
             f"{N_PREFIX_REQUESTS * PREFIX_LEN}")
    _require(len(engine._free_pages) == free_before,
             f"{free_before - len(engine._free_pages)} pool pages not "
             "returned")
    report = {"prefix_len": PREFIX_LEN, "requests": N_PREFIX_REQUESTS,
              "suffix_tokens": int(sum(len(p) for p in prompts))
              - N_PREFIX_REQUESTS * PREFIX_LEN,
              "register_s": register_s, "wall_s": wall,
              "prefill_s": sum(spent["prefill"]),
              "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
              "free_pages": free_before, "stats": stats}
    _log("prefix " + json.dumps(report))
    return report


def prefix_logits(torch, model):
    """Phase 7b at depth 2: the first-token logits of a request that
    extends a registered prefix against the same prompt prefilled whole
    (in prefill_chunk segments). The prefix is 500 tokens, so its
    boundary page (52 of 64 rows) is copied into the slot's own page."""
    small = _depth2(model)
    rng = np.random.default_rng(SEED + 5)
    prompt = rng.integers(0, small.cfg.vocab_size, (612,))
    got = []
    for use_prefix in (True, False):
        engine = _engine(small)
        sample = engine._sample
        engine._sample = lambda logits: (got.append(logits.float().clone()),
                                         sample(logits))[1]
        pid = engine.register_prefix(prompt[:500]) if use_prefix else None
        engine.submit(prompt, 1, prefix_id=pid)
        engine.run()
        _require(engine.stats["prefill_tokens_saved"]
                 == (500 if use_prefix else 0), "prefix not used")
        del engine
    g, r = got
    err = (g - r).abs()
    scale = r.abs().max().item()
    # both sides run the kernels; the prefix's K/V come from a prefill
    # of another length, so the matmuls tile (and split K) otherwise and
    # bf16 activations may round an ulp apart: phase 4's tolerance
    row = {"max_abs_err": err.max().item(), "logit_scale": scale,
           "mean_abs_err": err.mean().item(),
           "argmax_agree": bool(g.argmax() == r.argmax())}
    _require(bool(torch.isfinite(g).all())
             and row["max_abs_err"] <= 2.0 ** -4 * scale
             and row["mean_abs_err"] <= 2.0 ** -8 * scale,
             f"prefix vs whole-prompt first-token logits: {row}")
    _log("prefix_logits " + json.dumps(row))
    return row


def _flash_bound(kind, b, s, h, d, causal):
    """(bound ms, bound_by) of one flash call: bf16 tensors (B, S, H, D)
    read or written once, fp32 (B, H, S) vectors, and the operations of
    ``ops.flash_attention.flash_flops``."""
    from sparkdl_tpu_torch.ops.flash_attention import flash_flops

    tensors, vectors = {"fwd": (4, 1), "dq": (5, 2), "dkv": (6, 2)}[kind]
    nbytes = tensors * b * s * h * d * 2 + vectors * b * h * s * 4
    flops = flash_flops(kind, b, s, h, d, causal)
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
                row[kind]["tflops"] = (fa.flash_flops(kind, b, s, h, d,
                                                      causal)
                                       / row[kind]["ms"] / 1e9)
                if kind in FLASH_OLD_MS:
                    row[kind]["old_ms"] = FLASH_OLD_MS[kind]
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


def profile_step(torch, step, batch, step_ms, ops=()):
    """One more training step under ``torch.profiler`` (outside the
    counted window): device time by kernel name and their sum (one
    stream, so the device's busy time), with the idle share of an
    unprofiled step of ``step_ms`` (the profiled step's own wall time
    carries the profiler's cost); and the device ms of the kernels that
    each operator named in ``ops`` launched (its calls in the forward
    and the backward)."""
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
    by_op = {e.key: e for e in prof.key_averages() if e.key in ops}
    summary = {"profiled_wall_ms": wall_ms, "step_ms": step_ms,
               "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
               "ops_device_ms": {
                   k: getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0)) / 1e3
                   for k, e in by_op.items()},
               "kernels": [{"name": k[:160], "ms": ms, "count": n}
                           for k, (ms, n) in top]}
    _log("profile " + json.dumps({**summary,
                                  "kernels": summary["kernels"][:12]}))
    return summary


def train(torch, gen):
    """Phase 5: the training main path, counters zeroed after the
    warm-up step, then one more step profiled; returns the report and
    the trained model (phases 11 and 12 serve its weights)."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
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
    _zero_flash()
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
    launches = _flash_launches()
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
    return report, model


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


def _first_layers(params, n=2):
    """A state dict's entries of the first ``n`` layers and the rest."""
    return {k: v for k, v in params.items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}


def serve_multi_lora(torch, model, gen, phase3):
    """Phase 11: multi-LoRA serving on the bf16 base of phase 5's model,
    paged (pages of 64): adapter 0 is phase 5's trained adapters,
    adapters 1-3 seeded (normal 0.02, lora_b too), stacked with
    ``stack_lora_adapters``; phase 3's 16 requests, adapter i % 4 for
    request i, the counters zeroed just before the run; then, at depth
    2, each adapter's prefill and first decode logits against a
    single-adapter model carrying that adapter."""
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import stack_lora_adapters
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    trained = {k: v.detach() for k, v in model.state_dict().items()}
    adapters = [trained]
    for _ in range(1, MULTI_LORA):
        d = dict(trained)
        for name, t in trained.items():
            if name.endswith(("lora_a", "lora_b")):
                d[name] = torch.randn(t.shape, generator=gen,
                                      device=t.device) * 0.02
        adapters.append(d)
    stacked = stack_lora_adapters(adapters)
    del adapters
    cfg = dataclasses.replace(model.cfg, multi_lora=MULTI_LORA)
    engine = ContinuousBatchingEngine(Llama(cfg, device="meta"), stacked,
                                      n_slots=8, chunk=16, page_size=64,
                                      device=DEVICE)
    prompts, budgets = _requests(cfg)
    ids = [i % MULTI_LORA for i in range(len(prompts))]
    rids = [engine.submit(p, b, adapter_id=a)
            for p, b, a in zip(prompts, budgets, ids)]
    spent = _time_engine(torch, engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    stats = dict(engine.stats)
    _check_budgets(engine, results, rids, budgets, cfg.vocab_size, 11)
    want = cfg.n_layers * stats["steps"]
    _require(launches["paged_attention_decode"] == want,
             f"phase 11: {launches['paged_attention_decode']} paged decode "
             f"launches, the engine's {stats['steps']} steps predict {want}")
    del engine

    small_cfg = dataclasses.replace(cfg, n_layers=2, decode=True,
                                    page_size=64, n_pages=8)
    small_params = _first_layers(stacked)
    multi = Llama.from_params(small_cfg, small_params, device=DEVICE)
    rng = np.random.default_rng(SEED + 7)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 100)),
                             device=DEVICE)
    step = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)),
                           device=DEVICE)
    tables = torch.as_tensor([[1, 2, 0], [4, 3, 0]], dtype=torch.int32,
                             device=DEVICE)

    def run(m, ids=None):
        cache = m.init_cache()
        outs = [m(prompt, torch.arange(100, device=DEVICE)[None], tables,
                  cache, adapter_ids=ids)[:, -1]]
        outs.append(m(step, torch.full((2, 1), 100, device=DEVICE), tables,
                      cache, adapter_ids=ids)[:, -1])
        return [o.float() for o in outs]

    logits = []
    with torch.no_grad():
        for a in range(MULTI_LORA):
            got = run(multi, torch.full((2,), a, device=DEVICE))
            single = Llama.from_params(
                dataclasses.replace(small_cfg, multi_lora=0),
                {k: (v[a] if k.endswith(("lora_a", "lora_b")) else v)
                 for k, v in small_params.items()}, device=DEVICE)
            ref = run(single)
            logits += [_logits_row(torch, g, r, f"adapter {a} {what}")
                       for g, r, what in zip(got, ref,
                                             ("prefill", "decode 1"))]
            del single
    del multi, small_params, stacked
    decoded = sum(budgets) - len(rids)
    report = {
        "requests": len(rids), "adapters": MULTI_LORA,
        "lora_rank": cfg.lora_rank, "n_slots": 8, "page_size": 64,
        "chunk": 16, "n_layers": cfg.n_layers, "dtype": "bf16",
        "wall_s": wall, "decode_s": spent["decode"],
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "decode_tokens_per_s": decoded / spent["decode"],
        "phase3_decode_ms_per_step": phase3["decode_ms_per_step"],
        "phase3_decode_tokens_per_s": phase3["decode_tokens_per_s"],
        "prefill_s": sum(spent["prefill"]),
        "peak_mem_gb": peak / 1e9, "stats": stats, "launches": launches,
        "logits": logits,
    }
    _log("multi_lora " + json.dumps(report))
    return report


def serve_speculative(torch, model):
    """Phase 12: speculative serving at full width: the bf16 base of
    phase 5's model as a paged target (pages of 64), its int8 weights as
    the draft, k = SPEC_K, greedy, phase 3's first N_SPEC_REQUESTS
    requests; then the plain paged engine on the same target and
    requests. Counters zeroed just before each run."""
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.quant import quantize_llama_params
    from sparkdl_tpu_torch.models.serving import (
        ContinuousBatchingEngine,
        SpeculativeBatchingEngine,
    )

    base = {k: v.detach() for k, v in model.state_dict().items()
            if not k.endswith(("lora_a", "lora_b"))}
    cfg = dataclasses.replace(model.cfg, lora_rank=0)
    draft_cfg = dataclasses.replace(cfg, quant="int8")
    per_forward = 7 * cfg.n_layers + 1
    t = time.perf_counter()
    draft = quantize_llama_params(base, bits=8, device=DEVICE)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    prompts, budgets = _requests(cfg, N_SPEC_REQUESTS)
    torch.cuda.reset_peak_memory_stats()
    engine = SpeculativeBatchingEngine(
        Llama(cfg, device="meta"), base, draft,
        draft_model=Llama(draft_cfg, device="meta"), n_slots=8, k=SPEC_K,
        page_size=64, device=DEVICE)
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    spent = _time_engine(torch, engine, decode="_round")
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    stats = dict(engine.stats)
    _check_budgets(engine, results, rids, budgets, cfg.vocab_size, 12)
    # a draft forward a proposal and one to write the last, a round;
    # one draft prefill a request
    draft_forwards = stats["rounds"] * (SPEC_K + 1) + len(rids)
    _require(launches["quantized_matmul"] == per_forward * draft_forwards,
             f"phase 12: {launches['quantized_matmul']} int8 launches, "
             f"{draft_forwards} draft forwards predict "
             f"{per_forward * draft_forwards}")
    _require(launches["paged_attention_decode"] == 0,
             f"phase 12: the verify launched the paged decode "
             f"{launches['paged_attention_decode']} times")
    tokens = [results[r] for r in rids]
    del engine, draft

    plain = ContinuousBatchingEngine(Llama(cfg, device="meta"), base,
                                     n_slots=8, chunk=16, page_size=64,
                                     device=DEVICE)
    prids = [plain.submit(p, b) for p, b in zip(prompts, budgets)]
    plain_spent = _time_engine(torch, plain)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    presults = plain.run()
    plain_wall = time.perf_counter() - t0
    plain_launches = _read_launches()
    pstats = dict(plain.stats)
    _check_budgets(plain, presults, prids, budgets, cfg.vocab_size, 12)
    want = cfg.n_layers * pstats["steps"]
    _require(plain_launches["paged_attention_decode"] == want,
             f"phase 12 plain engine: {plain_launches} launches, its "
             f"{pstats['steps']} steps predict {want} paged decodes")
    plain_tokens = [presults[r] for r in prids]
    del plain
    decoded = sum(budgets) - len(rids)
    report = {
        "requests": len(rids), "k": SPEC_K, "n_slots": 8, "page_size": 64,
        "n_layers": cfg.n_layers, "target": "bf16", "draft": "int8",
        "rounds": stats["rounds"], "proposed": stats["proposed"],
        "accepted": stats["accepted"],
        "acceptance_rate": stats["acceptance_rate"],
        "draft_forwards": draft_forwards, "wall_s": wall,
        "decode_s": spent["decode"],
        "ms_per_round": 1e3 * spent["decode"] / stats["rounds"],
        "decode_tokens_per_s": decoded / spent["decode"],
        "prefill_s": sum(spent["prefill"]), "quantize_s": quantize_s,
        "plain": {"wall_s": plain_wall, "decode_s": plain_spent["decode"],
                  "decode_ms_per_step": 1e3 * plain_spent["decode"]
                  / pstats["steps"],
                  "decode_tokens_per_s": decoded / plain_spent["decode"],
                  "steps": pstats["steps"], "launches": plain_launches},
        "agree_with_plain": _agreement(tokens, plain_tokens),
        "peak_mem_gb": peak / 1e9, "stats": stats, "launches": launches,
    }
    _log("speculative " + json.dumps(report))
    return report


def _fleet_post(fleet, payload):
    """One client of phase 14: (HTTP code, the reply, its first token's
    arrival or None, the 503's Retry-After or None, the seconds sent)."""
    import urllib.error

    t = time.perf_counter()
    try:
        reply = _http(fleet, "/generate", payload)
    except urllib.error.HTTPError as e:
        return e.code, str(e.reason), None, e.headers.get("Retry-After"), t
    except OSError as e:  # no HTTP answer at all: reported as a failure
        return f"{type(e).__name__}: {e}", None, None, None, t
    if payload.get("stream"):
        first = reply[0][0] if reply and "token" in reply[0][1] else None
        code = 500 if "error" in reply[-1][1] else 200
        return code, reply, first, None, t
    return 200, reply, None, None, t


def _fleet_burst(fleet, payloads):
    """Every payload from its own client thread, released together;
    returns their :func:`_fleet_post` results and the burst's wall
    seconds."""
    import threading

    out = [None] * len(payloads)
    gate = threading.Barrier(len(payloads))

    def client(i):
        gate.wait()
        out[i] = _fleet_post(fleet, payloads[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out, time.perf_counter() - t0


def _fleet_tokens(code, reply, payload):
    """The tokens and finish reason of an answered request."""
    if payload.get("stream"):
        return ([e["token"] for _, e in reply[:-1]],
                reply[-1][1].get("done"))
    return reply["tokens"], reply["finish_reason"]


def _burst_summary(results, payloads, wall, vocab, what):
    """One burst's answers checked (every 200 on its full budget with
    in-vocabulary tokens, every 503 with Retry-After 1) and summed up:
    codes, requests and tokens a second over the burst's wall, and the
    streamed clients' time to first token."""
    codes = [None if r is None else r[0] for r in results]
    _require(all(isinstance(c, int) for c in codes),
             f"{what}: clients without an HTTP answer: {codes}")
    ttft, generated = [], 0
    for (code, reply, first, retry, t_sent), payload in zip(results,
                                                            payloads):
        if code == 503:
            _require(retry == "1", f"{what}: a 503 without Retry-After 1 "
                     f"({retry})")
        if code != 200:
            continue
        toks, reason = _fleet_tokens(code, reply, payload)
        _require(len(toks) == payload["max_new_tokens"]
                 and reason == "length"
                 and all(0 <= t < vocab for t in toks),
                 f"{what}: {len(toks)} tokens finished on {reason}, "
                 f"budget {payload['max_new_tokens']}")
        generated += len(toks)
        if first is not None:
            ttft.append(first - t_sent)
    ttft.sort()
    answered = codes.count(200)
    return {"codes": codes, "answered": answered, "503": codes.count(503),
            "wall_s": wall, "requests_per_s": answered / wall,
            "generated_tokens": generated, "tokens_per_s": generated / wall,
            "ttft_streamed_s": {
                "p50": ttft[len(ttft) // 2] if ttft else None,
                "p95": (ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))]
                        if ttft else None)}}


def _engines_launches(cfg, engines):
    """The kernel launches the int8 paged ``engines``' counts predict."""
    steps = sum(e.stats["steps"] for e in engines)
    forwards = sum(e.stats["steps"] + e.stats["prefill_segments"]
                   for e in engines)
    return {"paged_attention_decode": cfg.n_layers * steps,
            "quantized_matmul": (7 * cfg.n_layers + 1) * forwards,
            "quantized_matmul_int4": 0}


def _chunk_clock(engine):
    """Host seconds inside ``engine``'s decode chunks, with no
    synchronize (each chunk ends in a host copy of its tokens), so that
    replicas sharing the card are not serialized by the clock."""
    spent = [0.0]
    decode = engine._decode_chunk

    def clocked(*a, **k):
        t = time.perf_counter()
        try:
            return decode(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t

    engine._decode_chunk = clocked
    return spent


def serve_fleet(torch, model, phase3):
    """Phase 14: int8 paged engines at phase 3's settings behind one
    FleetFrontend (max_queue FLEET_MAX_QUEUE), sharing ``model``'s
    weights on the card. First one replica serves (a), N_FLEET_REQUESTS
    clients at once, odd ones streamed; then FLEET_REPLICAS replicas
    serve (a) again, (b) N_FAULT_REQUESTS more while replica 0's engine
    raises SystemExit inside run() after FAULT_AFTER_CHUNKS decode
    chunks, and (c) as many again after its respawn. Counters zeroed
    just before each fleet's (a)."""
    from sparkdl_tpu_torch.models.fleet import FleetFrontend
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = model.cfg
    params = model.state_dict()

    def fleet_of(replicas, engines):
        def factory():
            engine = ContinuousBatchingEngine(model, params, n_slots=8,
                                              chunk=16, page_size=64,
                                              device=DEVICE)
            engines.append((engine, _chunk_clock(engine)))
            return engine

        return FleetFrontend(factory, replicas=replicas,
                             max_queue=FLEET_MAX_QUEUE).start()

    def decode_ms(engines):
        return [1e3 * spent[0] / max(e.stats["steps"], 1)
                for e, spent in engines]

    rng = np.random.default_rng(SEED + 14)

    def payloads(n, low, high, stream):
        return [{"tokens": rng.integers(0, cfg.vocab_size,
                                        (int(k),)).tolist(),
                 "max_new_tokens": int(b), "stream": stream and bool(i % 2)}
                for i, (k, b) in enumerate(zip(
                    rng.integers(64, 1025, n), rng.integers(low, high, n)))]

    burst = payloads(N_FLEET_REQUESTS, FLEET_BUDGETS[0],
                     FLEET_BUDGETS[1] + 1, True)
    # (b) and (c): budgets past FAULT_AFTER_CHUNKS chunks of 16
    fault_burst = payloads(N_FAULT_REQUESTS, 64, 129, False)
    after_burst = payloads(N_FAULT_REQUESTS, 32, 65, False)

    # the same burst at one replica: what the second one adds
    single = []
    fleet = fleet_of(1, single)
    try:
        _zero_launches()
        got, wall = _fleet_burst(fleet, burst)
        launches = _read_launches()
    finally:
        fleet.close()
    want = _engines_launches(cfg, [e for e, _ in single])
    _require(launches == want, f"phase 14, one replica: launches "
             f"{launches}, the engine's counts predict {want}")
    one = _burst_summary(got, burst, wall, cfg.vocab_size,
                         "phase 14, one replica")
    one.update(launches=launches, decode_ms_per_step=decode_ms(single),
               stats=dict(single[0][0].stats))
    del single
    gc.collect()
    torch.cuda.empty_cache()

    engines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet = fleet_of(FLEET_REPLICAS, engines)
    fault = {}
    try:
        _require(all(e._model.lm_head.kernel_q.data_ptr()
                     == params["lm_head.kernel_q"].data_ptr()
                     for e, _ in engines), "phase 14: a replica copied the "
                 "weights")
        _zero_launches()
        got, wall = _fleet_burst(fleet, burst)
        burst_ms = decode_ms(engines)

        doomed = fleet._workers[0].engine
        decode = doomed._decode_chunk
        chunks = [0]

        def faulting(*a, **k):
            chunks[0] += 1
            if chunks[0] > FAULT_AFTER_CHUNKS:
                fault["at"] = time.perf_counter()
                raise SystemExit("phase 14: injected replica fault")
            return decode(*a, **k)

        doomed._decode_chunk = faulting
        got_fault, _ = _fleet_burst(fleet, fault_burst)
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            states = fleet.replica_states()
            if fleet._restarts == 1 and all(s["alive"] for s in states):
                fault["replaced"] = time.perf_counter()
                break
            time.sleep(0.01)
        _require("replaced" in fault, "phase 14: replica 0 was not "
                 f"replaced within 120 s ({fleet.replica_states()})")
        got_after, _ = _fleet_burst(fleet, after_burst)
        launches = _read_launches()
        metrics = _http(fleet, "/metrics")
        restarts = fleet.metrics.counter("server_replica_restarts_total",
                                         cause="death").value
        # a handler accounts its response just after writing it
        deadline = time.perf_counter() + 30
        while True:
            codes_seen = {}
            for (name, labels), c in list(fleet.metrics._metrics.items()):
                if name == "server_requests_total":
                    codes_seen[dict(labels)["code"]] = int(c.value)
            if (sum(codes_seen.values()) >= N_FLEET_REQUESTS
                    + 2 * N_FAULT_REQUESTS
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.05)
    finally:
        fleet.close()
    peak = torch.cuda.max_memory_allocated()

    two = _burst_summary(got, burst, wall, cfg.vocab_size, "phase 14")
    faulted = _burst_summary(got_fault, fault_burst, 1.0, cfg.vocab_size,
                             "phase 14 at the faulting replica")
    after = _burst_summary(got_after, after_burst, 1.0, cfg.vocab_size,
                           "phase 14 after the respawn")
    for what, summary in (("", two), (", one replica", one)):
        _require(summary["503"] >= 1 and summary["answered"]
                 == N_FLEET_REQUESTS - summary["503"],
                 f"phase 14{what}: burst codes {summary['codes']}")
    fault_codes = faulted["codes"]
    _require(fault_codes.count(500) >= 1
             and set(fault_codes) <= {200, 500},
             f"phase 14: codes at the faulting replica {fault_codes}")
    _require(after["answered"] == N_FAULT_REQUESTS,
             f"phase 14: codes after the respawn {after['codes']}")
    codes = two["codes"] + fault_codes + after["codes"]
    want_codes = {str(c): codes.count(c) for c in set(codes)}
    _require(codes_seen == want_codes
             and sum(codes_seen.values()) == len(codes),
             f"phase 14: server_requests_total {codes_seen}, clients saw "
             f"{want_codes}")
    _require(restarts == 1, f"phase 14: {restarts} replica restarts")
    _require(len(engines) == FLEET_REPLICAS + 1,
             f"phase 14: {len(engines)} engines built")
    served = [e._next_id for e, _ in engines]
    _require(served[-1] >= 1 and served[1] >= 1,
             f"phase 14: after the respawn, requests a replica {served}")
    want = _engines_launches(cfg, [e for e, _ in engines])
    _require(launches == want, f"phase 14: launches {launches}, the "
             f"engines' counts predict {want}")
    _require(f'server_replica_restarts_total{{cause="death"}} 1'
             in metrics, "phase 14: /metrics lacks the restart")
    report = {
        "replicas": FLEET_REPLICAS, "max_queue": FLEET_MAX_QUEUE,
        "n_layers": cfg.n_layers, "burst_requests": N_FLEET_REQUESTS,
        "burst_answered": two["answered"], "burst_503": two["503"],
        "burst_wall_s": wall, "requests_per_s": two["requests_per_s"],
        "tokens_per_s": two["tokens_per_s"],
        "ttft_streamed_s": two["ttft_streamed_s"],
        "burst_decode_ms_per_step": burst_ms,
        "one_replica": {k: v for k, v in one.items() if k != "codes"},
        "tokens_per_s_over_one_replica": (two["tokens_per_s"]
                                          / one["tokens_per_s"]),
        "phase3_tokens_per_s": phase3["generated_tokens"]
        / phase3["wall_s"],
        "phase3_decode_tokens_per_s": phase3["decode_tokens_per_s"],
        "fault_codes": fault_codes,
        "fault_to_replacement_s": fault["replaced"] - fault["at"],
        "requests_per_replica": served, "codes": want_codes,
        "restarts": restarts,
        "decoded_tokens": sum(x["generated_tokens"] - x["answered"]
                              for x in (two, faulted, after)),
        "peak_mem_gb": peak / 1e9, "launches": launches,
        "stats": [dict(e.stats) for e, _ in engines]}
    _log("fleet " + json.dumps(report))
    return report


class _StdoutCopy:
    """Keep a copy of what this process prints (the control plane's
    threads included) while still printing it."""

    def __init__(self):
        self.text = []

    def write(self, s):
        self.text.append(s)
        return self._out.write(s)

    def flush(self):
        self._out.flush()

    def __enter__(self):
        self._out, sys.stdout = sys.stdout, self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._out
        return False

    def seen(self):
        return "".join(self.text)


def _battery_inputs(torch, rank, size, device):
    """The gang phases' collective inputs on ``rank``: small exact values
    (negative integers, so the integer average truncates toward zero)."""
    base = torch.arange(12, device=device).reshape(4, 3)
    splits = [j + rank + 1 for j in range(size)]
    return {
        "f32": (base * (rank + 1) - 5.5 * rank).float(),
        "i32": ((base - 3) * (2 * rank - 1) + rank).int(),
        "ragged": torch.full((rank + 1, 3), float(rank), device=device),
        "a2a": torch.arange(sum(splits), device=device).float() + 100 * rank,
        "splits": splits,
        "rs": torch.arange(6 * size, device=device).reshape(2 * size, 3)
        .float() * (rank + 1),
    }


def _battery(hvd, torch, device):
    """The collectives of phases 9a and 9b on this rank's CUDA tensors;
    returns
    {name: (result on the CPU, the device type it came back on)}."""
    rank, size = hvd.rank(), hvd.size()
    x = _battery_inputs(torch, rank, size, device)
    out = {}
    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max):
        out[f"f32_{op}"] = hvd.allreduce(x["f32"], op=op)
        out[f"i32_{op}"] = hvd.allreduce(x["i32"], op=op)
    out["allgather_ragged"] = hvd.allgather(x["ragged"])
    out["alltoall_splits"] = hvd.alltoall(x["a2a"], splits=x["splits"])
    out["reducescatter_sum"] = hvd.reducescatter(x["rs"], op=hvd.Sum)
    result = {k: (v.cpu(), v.device.type) for k, v in out.items()}
    result["broadcast_object"] = (hvd.broadcast_object(
        {"root": rank, "pad": "p" * 1000 * rank}, root_rank=size - 1), None)
    return result


def _battery_expected(torch, rank, size):
    """What :func:`_battery` must return on ``rank``, from every rank's
    inputs (the JAX engine's semantics: a float average in fp32, an
    integer one truncated from float64)."""
    xs = [_battery_inputs(torch, r, size, "cpu") for r in range(size)]
    want = {}
    for k in ("f32", "i32"):
        stack = torch.stack([x[k] for x in xs])
        total = stack.sum(0).to(stack.dtype)
        want[f"{k}_sum"] = total
        want[f"{k}_min"] = stack.min(0).values
        want[f"{k}_max"] = stack.max(0).values
        want[f"{k}_average"] = ((total / size) if k == "f32" else
                                (total.double() / size).to(torch.int32))
    want["allgather_ragged"] = torch.cat([x["ragged"] for x in xs])
    parts = []
    for x in xs:
        start = sum(x["splits"][:rank])
        parts.append(x["a2a"][start:start + x["splits"][rank]])
    want["alltoall_splits"] = torch.cat(parts)
    rows = xs[0]["rs"].shape[0] // size
    want["reducescatter_sum"] = sum(x["rs"] for x in xs)[
        rank * rows:(rank + 1) * rows]
    want["broadcast_object"] = {"root": size - 1,
                                "pad": "p" * 1000 * (size - 1)}
    return want


def _gang_trainer(cfg, batch, seed, device):
    """A gang rank's trainer, as phases 9a-9c build it: bind the card
    (``hvd.init``), build the LoRA Llama of ``cfg`` from ``seed + rank``
    and take rank 0's weights (``replicate``), AdamW on the adapters
    wrapped in ``hvd.DistributedOptimizer``; returns a namespace with
    the model's adapters (``named``), ``opt``, ``step``, this rank's rows
    of ``batch`` (``mine``), ``device``, ``sync``, ``init_s`` (the model
    built and replicated), ``opt_s`` (the wrapped optimizer built), and
    ``ready_at`` and ``built_at`` (the wall clock past ``hvd.init`` and
    at the end)."""
    import types

    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        replicate,
        shard_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    ready_at = time.time()
    rank = hvd.rank()
    st = _state.state()
    if device == "cuda":
        device = st.device
        _require(device is not None and device.type == "cuda",
                 f"gang rank {rank} bound no card ({device})")
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + rank)  # only replicate() can make them agree
    model = init_weights(Llama(cfg, device=device), gen)
    replicate(model)
    sync()
    init_s = time.perf_counter() - t
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    t = time.perf_counter()  # a process's first optimizer imports dynamo
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-4,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    opt_s = time.perf_counter() - t
    hvd.broadcast_optimizer_state(opt)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device=device)
    return types.SimpleNamespace(
        model=model, named=named, opt=opt, step=step,
        mine=shard_batch(batch),
        device=device, on_card=on_card, sync=sync, init_s=init_s,
        opt_s=opt_s, ready_at=ready_at, built_at=time.time(),
        backend=st.backend)


def _adapter_digest(named):
    """sha256 of the adapters' names and fp32 bytes, in model order."""
    import hashlib

    h = hashlib.sha256()
    for name, p in named:
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gang_main(cfg, batch, steps, warmup, seed, device, adapters, started):
    """Every rank of phases 9a and 9b (:func:`_gang_trainer`): train on
    this rank's rows of ``batch``, ``warmup`` steps and then ``steps``
    timed ones (flash counters zeroed between), then run the collective
    battery on this rank's device. Rank 0 returns every rank's report
    (``allgather_object``), its adapters' digest among them."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import log_to_driver
    from sparkdl_tpu_torch.observe import health, mem

    tr = _gang_trainer(cfg, batch, seed, device)
    ready_s = tr.ready_at - started
    rank, size = hvd.rank(), hvd.size()
    named, opt, step, mine = tr.named, tr.opt, tr.step, tr.mine
    device, on_card, sync = tr.device, tr.on_card, tr.sync
    losses = [step(mine)["loss"].item() for _ in range(warmup)]
    _zero_flash()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(steps):
        sync()
        t = time.perf_counter()
        losses.append(step(mine)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
    launches = _flash_launches()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the same peak as a benchmark reads it: of the card hvd.init() bound
    reported = mem.device_peak_bytes() if on_card else None
    bound = health.bound_card()

    # what the wrapped optimizer adds a step: the fused reduction of the
    # adapter gradients (cat, allreduce in place, copy back), then the
    # allreduce alone on a buffer of the same size
    numel = sum(p.grad.numel() for _, p in named)
    flat = torch.zeros(numel, device=device)
    sync_ms = _host_ms(torch, opt.synchronize, device, warmup=0)
    allreduce_ms = _host_ms(torch, lambda: hvd.allreduce_(flat), device,
                            warmup=0)
    synchronized = hvd.check_synchronized([p for _, p in named],
                                          name="adapters")
    report = {
        "rank": rank, "size": size, "backend": tr.backend,
        "device": str(device), "ready_s": ready_s, "init_s": tr.init_s,
        "opt_s": tr.opt_s,
        "losses": losses, "step_ms": [1e3 * x for x in times],
        "step_ms_median": 1e3 * statistics.median(times),
        "rows": int(mine["inputs"].shape[0]),
        "peak_mem_gb": peak / 1e9, "peak_bytes": peak,
        "device_peak_bytes": reported,
        "bound_card": None if bound is None else str(bound),
        "launches": launches,
        "adapter_values": numel, "adapter_mb": 4 * numel / 1e6,
        "sync_ms": sync_ms, "allreduce_ms": allreduce_ms,
        "synchronized": synchronized,
        "battery": _battery(hvd, torch, device),
        "adapters": ({n: p.detach().cpu() for n, p in named}
                     if adapters and rank == 0 else None),
        "adapter_sha256": _adapter_digest(named) if rank == 0 else None,
    }
    log_to_driver(f"gang rank {rank} of {size} ({tr.backend} on {device}): "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"{report['step_ms_median']:.1f} ms a step")
    return hvd.allgather_object(report)


def _gang_run(np_arg, cfg, batch, **kw):
    """One HorovodRunner run of :func:`gang_main`, this process's stdout
    copied; returns (every rank's report, the run's wall seconds, the
    stdout text)."""
    from sparkdl_tpu_torch import HorovodRunner

    with _StdoutCopy() as out:
        t = time.perf_counter()
        ranks = HorovodRunner(np=np_arg).run(
            gang_main, cfg=cfg, batch=batch, device=DEVICE,
            started=time.time(), **kw)
        wall_s = time.perf_counter() - t
    return ranks, wall_s, out.seen()


def _check_gang_ranks(torch, ranks, cfg, steps, seen, phase):
    """The checks 9a and 9b share: each rank's losses finite and falling
    over the run, its flash counters at a call a layer a step, its
    adapters synchronized, its collective battery as expected (on the
    card: over NCCL at 9a's world size 1, through gloo at 9b's), its
    log_to_driver line on this stdout."""
    for r in ranks:
        want = _battery_expected(torch, r["rank"], len(ranks))
        for name, expected in want.items():
            got, where = r["battery"][name]
            ok = (got == expected if name == "broadcast_object" else
                  got.dtype == expected.dtype and torch.equal(got, expected)
                  and where == torch.device(DEVICE).type)
            _require(ok, f"phase {phase} rank {r['rank']}: {name} gave "
                     f"{got} on {where}, want {expected}")
        losses = r["losses"]
        _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                 f"phase {phase} rank {r['rank']}: losses {losses}")
        want = cfg.n_layers * steps
        for name, n in r["launches"].items():
            _require(n == want, f"phase {phase} rank {r['rank']}: {name} "
                     f"{n} launches in {steps} steps, want {want}")
        _require(r["synchronized"] is True,
                 f"phase {phase} rank {r['rank']}: adapters not synchronized")
        line = f"gang rank {r['rank']} of {r['size']} ("
        _require(line in seen, f"phase {phase}: the driver's stdout lacks "
                 f"rank {r['rank']}'s log_to_driver line")


def gang_train(torch, phase5):
    """Phase 9a: HorovodRunner(np=1) at phase 5's configuration."""
    from sparkdl_tpu_torch.parallel.train import global_batch

    cfg = _train_cfg()
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    ranks, wall_s, seen = _gang_run(
        GANG_NP["9a"], cfg, batch, steps=GANG_STEPS, warmup=1, seed=SEED,
        adapters=False)
    _check_gang_ranks(torch, ranks, cfg, GANG_STEPS, seen, "9a")
    r0 = ranks[0]
    _require(len(ranks) == max(GANG_NP["9a"], 1) and r0["rank"] == 0,
             f"phase 9a: rank 0's result did not reach the driver: {ranks}")
    if GANG_NP["9a"] >= 1:
        _require(r0["backend"] == "cpu:gloo,cuda:nccl",
                 f"phase 9a: backend {r0['backend']}, want NCCL for CUDA")
        _require(r0["bound_card"] == r0["device"]
                 and r0["device_peak_bytes"] == r0["peak_bytes"],
                 f"phase 9a: device_peak_bytes() {r0['device_peak_bytes']} "
                 f"of the bound card {r0['bound_card']}, "
                 f"max_memory_allocated({r0['device']}) {r0['peak_bytes']}")
    report = {k: v for k, v in r0.items() if k not in ("battery",
                                                       "adapters")}
    report.update({
        "np": GANG_NP["9a"], "n_layers": cfg.n_layers, "run_wall_s": wall_s,
        "tokens_per_s": GANG_STEPS * TRAIN_BATCH * TRAIN_SEQ
        / (sum(r0["step_ms"]) / 1e3),
        "phase5_step_ms_median": phase5["step_ms_median"],
        "step_ms_over_phase5": r0["step_ms_median"]
        / phase5["step_ms_median"]})
    _log("gang " + json.dumps(report))
    return report


def gang_shared_card(torch):
    """Phase 9b: HorovodRunner(np=-2), two ranks sharing the card, against
    a single-process run of the same steps in the driver."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
    )

    cfg = _train_cfg(n_layers=GANG_SHARED_DEPTH)
    batch = global_batch(np.random.default_rng(SEED + 4), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    ranks, wall_s, seen = _gang_run(
        GANG_NP["9b"], cfg, batch, steps=GANG_STEPS, warmup=0, seed=SEED,
        adapters=True)
    size = len(ranks)
    _check_gang_ranks(torch, ranks, cfg, GANG_STEPS, seen, "9b")
    _require([r["rows"] for r in ranks] == [TRAIN_BATCH // size] * size,
             f"phase 9b: rows a rank {[r['rows'] for r in ranks]}")
    if GANG_NP["9b"] <= -2 and DEVICE == "cuda":
        _require(all(r["backend"] == "gloo" for r in ranks),
                 f"phase 9b: backends {[r['backend'] for r in ranks]}, "
                 "want gloo for ranks sharing a card")

    # the same steps in one process: rank 0's weights, the whole global
    # batch in microbatches of one rank's rows (its gradient is the
    # mean of theirs, as the gang's averaged gradient is)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    model = init_weights(Llama(cfg, device=DEVICE), gen)
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    start = {n: p.detach().clone() for n, p in named}
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           grad_accum=size, device=DEVICE)
    ref_losses = [step(batch)["loss"].item() for _ in range(GANG_STEPS)]
    gang_losses = np.mean([r["losses"] for r in ranks], axis=0).tolist()
    # Tolerance on phase 6's footing: the loss within 2^-10 relative, and
    # each adapter's change over the 3 steps within 2^-5 of its norm. The
    # two runs do the same per-row products on the same card; they differ
    # in where the rows' gradients are summed (gloo on the host against
    # autograd's accumulation) and in the fp32 mean of the losses.
    report = {"np": GANG_NP["9b"], "n_layers": cfg.n_layers, "size": size,
              "run_wall_s": wall_s, "losses": gang_losses,
              "single_process_losses": ref_losses, "adapters": {}}
    for got_l, ref_l in zip(gang_losses, ref_losses):
        _require(abs(got_l - ref_l) <= 2.0 ** -10 * abs(ref_l),
                 f"phase 9b losses {gang_losses} vs one process "
                 f"{ref_losses}")
    got = ranks[0]["adapters"]
    for name, p in named:
        ref_delta = (p.detach() - start[name]).cpu()
        delta = got[name] - start[name].cpu()
        rel = ((delta - ref_delta).norm() / ref_delta.norm()).item()
        report["adapters"][name] = {
            "rel_change_err": rel,
            "max_abs_err": (got[name] - p.detach().cpu()).abs().max().item()}
        _require(ref_delta.norm() > 0 and rel <= 2.0 ** -5,
                 f"phase 9b {name}: gang vs one process, relative error "
                 f"of the change {rel}")
    report["worst_rel_change_err"] = max(
        a["rel_change_err"] for a in report["adapters"].values())
    report["max_abs_err"] = max(
        a["max_abs_err"] for a in report["adapters"].values())
    report["ranks"] = [{k: v for k, v in r.items()
                        if k not in ("battery", "adapters")} for r in ranks]
    _log("gang_shared " + json.dumps(
        {k: v for k, v in report.items() if k != "adapters"}))
    return report


def _preempt(marker, saves):
    """Phase 9c's preemption of this rank: on rank 0, the kill's wall
    clock and this attempt's saves go to ``marker``; then SIGKILL. In the
    CPU rehearsal in one process (no control plane: ``GANG_NP["9c"] ==
    -1``) it raises what the launcher raises for a rank killed so."""
    import signal

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod.control_plane import get_worker_client

    if hvd.rank() == 0:
        with open(marker, "w") as f:
            json.dump({"killed_at": time.time(), "saves": saves}, f)
    if get_worker_client() is None:
        from sparkdl_tpu_torch.horovod.supervisor import GangFailure

        raise GangFailure("rank 0 preempted (in-process rehearsal)",
                          kind="worker_death", exit_codes=[-signal.SIGKILL])
    os.kill(os.getpid(), signal.SIGKILL)


def resume_main(cfg, batch, steps, seed, device, ckpt_dir, kill_after,
                marker):
    """Every rank of phase 9c (:func:`_gang_trainer`, the configuration of
    9a): ``steps`` steps in all, each followed by an async
    ``TrainCheckpointer`` save of the adapters and the optimizer state,
    its write joined, then a barrier. The first attempt preempts itself
    after step ``kill_after`` (:func:`_preempt`); a relaunch restores the
    step its restart context names onto the card and runs the rest, its
    flash counters zeroed first. Rank 0 returns every rank's report."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import restart_context
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    tr = _gang_trainer(cfg, batch, seed, device)
    ctx = restart_context()
    ckpt = TrainCheckpointer(ckpt_dir, async_save=True)
    start, restore_ms, restored_at, moments_on_card = 0, None, None, None
    if ctx.resume_step is not None:
        tr.sync()
        t = time.perf_counter()
        state = ckpt.restore(ctx.resume_step,
                             target={"adapters": dict(tr.named), "opt": None})
        with torch.no_grad():
            for name, p in tr.named:
                p.copy_(state["adapters"][name])
        tr.opt.load_state_dict(state["opt"])
        tr.sync()
        restore_ms = 1e3 * (time.perf_counter() - t)
        restored_at = time.time()
        moments_on_card = all(
            tr.opt.state[p][k].device == p.device
            for _, p in tr.named for k in ("exp_avg", "exp_avg_sq"))
        start = ckpt.last_restored_step + 1
    _zero_flash()
    losses, times, saves, first_step_at = [], [], [], None
    for s in range(start, steps):
        tr.sync()
        t = time.perf_counter()
        losses.append(tr.step(tr.mine)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
        if first_step_at is None:
            first_step_at = time.time()
        wrote = ckpt.save(s, {"adapters": dict(tr.named),
                              "opt": tr.opt.state_dict()})
        ckpt.wait_until_finished()
        hvd.barrier()  # rank 0's step committed before any rank dies
        if wrote:
            saves.append(dict(ckpt.last_save))
        if ctx.attempt == 0 and s == kill_after:
            _preempt(marker, saves)
    ckpt.close()
    report = {
        "rank": hvd.rank(), "size": hvd.size(), "attempt": ctx.attempt,
        "resume_step": ctx.resume_step, "restored_step":
        ckpt.last_restored_step, "start_step": start, "losses": losses,
        "step_ms": [1e3 * x for x in times], "restore_ms": restore_ms,
        "moments_on_card": moments_on_card, "init_s": tr.init_s,
        "opt_s": tr.opt_s,
        "ready_at": tr.ready_at, "built_at": tr.built_at,
        "restored_at": restored_at, "first_step_at": first_step_at,
        "saves": saves,
        "launches": _flash_launches(),
        "adapter_sha256": (_adapter_digest(tr.named) if hvd.rank() == 0
                           else None),
    }
    return hvd.allgather_object(report)


def _run_resumable(np_arg, **kw):
    """Phase 9c's supervised run of :func:`resume_main`: a HorovodRunner
    gang, or for ``np_arg == -1`` (the CPU rehearsal) ``supervise`` over
    ``resume_main`` in local mode in this process."""
    from sparkdl_tpu_torch import HorovodRunner, horovod
    from sparkdl_tpu_torch.horovod import supervisor
    from sparkdl_tpu_torch.hvd import _state

    if np_arg != -1:
        return HorovodRunner(np=np_arg).run(resume_main, **kw)

    def launch(ctx):
        horovod._set_restart_context(ctx)
        try:
            with _state.local_mode():
                return resume_main(**kw)
        finally:
            horovod._set_restart_context(horovod.RestartContext(0, None))

    return supervisor.supervise(launch, supervisor.policy)


def gang_resume(torch, gang):
    """Phase 9c: 9a's configuration under a supervisor policy of one
    retry; the gang's rank preempts itself after step 1's save, is
    relaunched and resumes from that checkpoint; the resumed steps'
    losses and the final adapters against 9a's."""
    import shutil
    import tempfile

    from sparkdl_tpu_torch.horovod import launcher, supervisor
    from sparkdl_tpu_torch.parallel.train import global_batch

    cfg = _train_cfg()
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    steps = 1 + GANG_STEPS  # 9a's warm-up and timed steps
    # each launch attempt's wall-clock start and end, for the relaunch's
    # breakdown
    launches = []
    launch_once = launcher._launch_gang_once

    def timed_launch(*args, **kw):
        t0 = time.time()
        try:
            return launch_once(*args, **kw)
        finally:
            launches.append((t0, time.time()))

    work = tempfile.mkdtemp(prefix="chip-smoke-9c-")
    ckpt_dir = os.path.join(work, "ckpt")
    marker = os.path.join(work, "preempted.json")
    before = supervisor.policy
    supervisor.policy = supervisor.RetryPolicy(
        max_retries=1, backoff_base=0.5, backoff_max=1.0, jitter=0.0,
        resume_dir=ckpt_dir)
    launcher._launch_gang_once = timed_launch
    try:
        t = time.perf_counter()
        ranks = _run_resumable(
            GANG_NP["9c"], cfg=cfg, batch=batch, steps=steps, seed=SEED,
            device=DEVICE, ckpt_dir=ckpt_dir, kill_after=RESUME_KILL_AFTER,
            marker=marker)
        wall_s = time.perf_counter() - t
        with open(marker) as f:
            preempted = json.load(f)
    finally:
        launcher._launch_gang_once = launch_once
        supervisor.policy = before
        shutil.rmtree(work, ignore_errors=True)
    r0 = ranks[0]
    resumed = steps - 1 - RESUME_KILL_AFTER
    _require(r0["attempt"] == 1 and r0["resume_step"] == RESUME_KILL_AFTER
             and r0["restored_step"] == RESUME_KILL_AFTER,
             f"phase 9c: attempt {r0['attempt']}, resume step "
             f"{r0['resume_step']}, restored {r0['restored_step']}; want "
             f"one relaunch from step {RESUME_KILL_AFTER}")
    _require(r0["moments_on_card"] is True,
             "phase 9c: the restored AdamW moments are not on the "
             "adapters' device")
    for r in ranks:
        for name, n in r["launches"].items():
            _require(n == cfg.n_layers * resumed,
                     f"phase 9c rank {r['rank']}: {name} {n} launches in "
                     f"{resumed} resumed steps, want {cfg.n_layers * resumed}")
    saves = preempted["saves"] + r0["saves"]
    _require([s["step"] for s in saves] == list(range(steps)),
             f"phase 9c: rank 0 saved steps {[s['step'] for s in saves]}")
    # bit for bit: the flash backward kernels own their rows (no atomics)
    # and NCCL at world size 1 copies, so the resumed steps are 9a's
    want_losses = gang["losses"][RESUME_KILL_AFTER + 1:]
    _require(r0["losses"] == want_losses,
             f"phase 9c losses {r0['losses']} vs 9a's {want_losses}")
    _require(r0["adapter_sha256"] == gang["adapter_sha256"],
             f"phase 9c adapters {r0['adapter_sha256']} vs 9a's "
             f"{gang['adapter_sha256']}")
    report = {
        "np": GANG_NP["9c"], "n_layers": cfg.n_layers, "steps": steps,
        "killed_after_step": RESUME_KILL_AFTER, "relaunches": r0["attempt"],
        "resume_step": r0["resume_step"], "losses": r0["losses"],
        "gang_9a_losses": want_losses, "adapter_sha256": r0["adapter_sha256"],
        "snapshot_ms": [1e3 * s["snapshot_s"] for s in saves],
        "write_ms": [1e3 * s["write_s"] for s in saves],
        "checkpoint_bytes": saves[-1]["bytes"], "restore_ms": r0["restore_ms"],
        "kill_to_first_resumed_step_s":
        r0["first_step_at"] - preempted["killed_at"],
        # kill -> launcher's failure -> backoff -> new worker past
        # hvd.init -> model built -> step restored -> first step done
        "relaunch_breakdown_s": None if len(launches) != 2 else {
            "kill_to_failure": launches[0][1] - preempted["killed_at"],
            "failure_to_relaunch": launches[1][0] - launches[0][1],
            "relaunch_to_ready": r0["ready_at"] - launches[1][0],
            "ready_to_built": r0["built_at"] - r0["ready_at"],
            "built_to_restored": r0["restored_at"] - r0["built_at"],
            "first_resumed_step": r0["first_step_at"] - r0["restored_at"]},
        "init_s": r0["init_s"], "opt_s": r0["opt_s"],
        "step_ms": r0["step_ms"],
        "launches": r0["launches"], "run_wall_s": wall_s,
        "gang_9a_run_wall_s": gang["run_wall_s"]}
    _log("gang_resume " + json.dumps(report))
    return report


def _gang_device(torch, mesh, device):
    """The card a gang rank bound (its mesh's), or the device named."""
    return mesh.device if mesh.device is not None else torch.device(device)


def _host_ms(torch, fn, device, runs=10, warmup=2):
    """Median host ms of ``fn`` between two synchronizes of ``device``,
    after ``warmup`` calls (every rank of a gang calls it together)."""
    spent = []
    for _ in range(runs + warmup):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        spent.append(1e3 * (time.perf_counter() - t))
    return statistics.median(spent[warmup:])


def _count_hops(torch, mesh, device):
    """Record each neighbour exchange the rings issue on ``mesh`` (its
    ``ppermute_start`` wrapped): its tensors' dtypes and the host ms
    spent in it, in the issue and in the wait. Returns the list of
    records. On the card each part starts and ends with a synchronize,
    so compute queued before it is not counted; a host-staged hop's
    copies to and from pageable host memory synchronize the stream
    anyway, so the step keeps its order. What is counted is the hop's
    exposed time: staging the blocks to the host, and what is left of
    the transfer once the compute between issue and wait is done."""
    calls = []
    issue = mesh.ppermute_start

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, 1e3 * (time.perf_counter() - t)

    def counted(tensors, axis):
        tensors = tuple(tensors)
        call = {"dtypes": [str(t.dtype) for t in tensors]}
        calls.append(call)
        pending, call["ms"] = timed(lambda: issue(tensors, axis))
        wait = pending.wait

        def timed_wait():
            out, ms = timed(wait)
            call["ms"] += ms
            return out

        pending.wait = timed_wait
        return pending

    mesh.ppermute_start = counted
    return calls


def _hops_a_tensor(calls):
    """Hops a tensor of the recorded exchanges: K/V (the activations'
    bf16) and the dk/dv accumulators (fp32), each exchanged in pairs."""
    flat = [d for call in calls for d in call["dtypes"]]
    return {"kv": flat.count("torch.bfloat16") / 2,
            "acc": flat.count("torch.float32") / 2}


def _hop_ms(calls):
    """Exposed host ms of the recorded exchanges: those of K/V alone,
    and those carrying the fp32 accumulators (with or without the next
    K/V pair)."""
    acc = [c["ms"] for c in calls if "torch.float32" in c["dtypes"]]
    return {"kv_only": sum(c["ms"] for c in calls) - sum(acc),
            "with_acc": sum(acc)}


def _seq_weights(torch, model, gen):
    """Phase 15's weights: ``init_weights`` from ``gen``, then every
    ``lora_b`` normal(0.02) from it too, so every adapter has a
    gradient at step 0."""
    from sparkdl_tpu_torch.models.llama import init_weights

    init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    return model


def seq_main(cfg, batch, steps, seed, device, started):
    """Every rank of phase 15: ``make_mesh(MeshSpec(seq=size))``, the LoRA
    Llama of ``cfg`` with ``attention_fn`` the mesh's ring attention
    (flash on the card), rank 0's weights replicated, AdamW on the
    adapters in ``hvd.DistributedOptimizer``, the fused loss, this rank's
    columns of ``batch`` and their positions. Step 0's loss and averaged
    adapter gradients under both hop schedules (no update); the hops of
    one forward; then ``steps`` steps, flash counters and hops recorded
    from zero; the K/V and accumulator hops timed at the ring's shapes.
    Rank 0 returns every rank's report (its gradients in rank 0's)."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.ring_attention import make_ring_attention
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        replicate,
        shard_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    mesh = make_mesh(MeshSpec(seq=size))
    dev = _gang_device(torch, mesh, device)
    on_card = dev.type == "cuda"
    rings = {ov: make_ring_attention(mesh, overlap=ov) for ov in (True, False)}
    schedule = {"overlap": True}
    model = Llama(cfg, device=dev, attention_fn=lambda q, k, v: rings[
        schedule["overlap"]](q, k, v))
    _seq_weights(torch, model, _seeded(torch, seed + rank, dev))
    replicate(model)  # rank 0's weights
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    loss_fn = make_lm_loss_fn(model, loss="fused")
    step = make_train_step(loss_fn, opt, param_mask=mask, device=dev)
    mine = shard_batch(batch, mesh, seq_axis=True)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in mine.items()}
    hops = _count_hops(torch, mesh, dev)

    # step 0 under both schedules: the loss and the averaged gradients
    step0 = {}
    for overlap in (True, False):
        schedule["overlap"] = overlap
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(on_dev)
        loss.backward()
        opt.synchronize()
        step0[overlap] = (loss.detach().clone(),
                          {n: p.grad.detach().clone() for n, p in named})
    schedule["overlap"] = True
    identical = bool(torch.equal(step0[True][0], step0[False][0])) and all(
        torch.equal(step0[True][1][n], step0[False][1][n]) for n, _ in named)
    opt.zero_grad(set_to_none=True)
    hops.clear()
    with torch.no_grad():
        loss_fn(on_dev)
    forward_hops = _hops_a_tensor(hops)

    hops.clear()
    _zero_flash()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(steps):
        if on_card:
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        losses.append(step(mine)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
    launches = _flash_launches()
    step_hops = _hops_a_tensor(hops)
    step_hop_ms = {k: ms / steps for k, ms in _hop_ms(hops).items()}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    synchronized = hvd.check_synchronized([p for _, p in named],
                                          name="adapters")

    # one hop of each kind at the ring's shapes: the K/V pair (repeated
    # to the query heads) and the fp32 dk/dv pair
    hd = cfg.d_model // cfg.n_heads
    kv = torch.zeros((1, on_dev["inputs"].shape[1], cfg.n_heads, hd),
                     dtype=cfg.dtype, device=dev)
    acc = kv.float()
    hop_ms = {"kv": _host_ms(torch, lambda: mesh.ppermute_start(
                  (kv, kv), "seq").wait(), dev),
              "acc": _host_ms(torch, lambda: mesh.ppermute_start(
                  (acc, acc), "seq").wait(), dev)}
    report = {
        "rank": rank, "size": size, "backend": _state.state().backend,
        "device": str(dev), "ready_s": ready_s,
        "tokens": int(on_dev["inputs"].numel()),
        "positions": [int(on_dev["positions"].min()),
                      int(on_dev["positions"].max())],
        "step0_loss": step0[True][0].item(),
        "schedules_bit_identical": identical,
        "forward_hops": forward_hops, "step_hops": step_hops,
        "losses": losses, "step_ms": [1e3 * x for x in times],
        "step_ms_median": 1e3 * statistics.median(times),
        "launches": launches, "peak_mem_gb": peak / 1e9,
        "synchronized": synchronized, "adapter_sha256": _adapter_digest(named),
        "hop_ms": hop_ms, "step_hop_ms": step_hop_ms,
        "step0_grads": ({n: g.cpu() for n, g in step0[True][1].items()}
                        if rank == 0 else None)}
    return hvd.allgather_object(report)


def _check_seq_ranks(ranks, cfg, steps):
    """Phase 15's per-rank checks: each rank's flash counters at one call
    a live hop a layer a step (rank r has r + 1 live hops: its own block
    and the earlier ranks'), the hops a tensor (a forward n - 1 of K/V; a
    step 2(n - 1) of K/V and n of the accumulators, a layer), both
    schedules bit-identical, finite falling losses, the adapters the same
    on every rank."""
    n = len(ranks)
    for r in ranks:
        live = cfg.n_layers * (r["rank"] + 1) * steps
        _require(r["launches"] == dict.fromkeys(r["launches"], live),
                 f"phase 15 rank {r['rank']}: launches {r['launches']}, want "
                 f"{live} of each ({r['rank'] + 1} live hops a layer)")
        want = {"kv": (n - 1) * cfg.n_layers, "acc": 0}
        _require(r["forward_hops"] == want,
                 f"phase 15 rank {r['rank']}: a forward's hops "
                 f"{r['forward_hops']}, want {want}")
        want = {"kv": 2 * (n - 1) * cfg.n_layers * steps,
                "acc": n * cfg.n_layers * steps}
        _require(r["step_hops"] == want,
                 f"phase 15 rank {r['rank']}: hops in {steps} steps "
                 f"{r['step_hops']}, want {want}")
        _require(r["schedules_bit_identical"],
                 f"phase 15 rank {r['rank']}: overlap=True and False differ")
        _require(all(np.isfinite(r["losses"]))
                 and r["losses"][-1] < r["losses"][0],
                 f"phase 15 rank {r['rank']}: losses {r['losses']}")
        _require(r["synchronized"] is True
                 and r["adapter_sha256"] == ranks[0]["adapter_sha256"],
                 f"phase 15 rank {r['rank']}: adapters differ across ranks")


def seq_parallel(torch):
    """Phase 15: HorovodRunner(np=GANG_NP["15"]) ranks of
    :func:`seq_main` sharing the card, one sequence of SEQ_TOKENS; step
    0's loss and adapter gradients against one process running the whole
    sequence through ``flash_attention`` (B1-B3) on the same weights."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import global_batch, make_lm_loss_fn

    cfg = _train_cfg(n_layers=SEQ_DEPTH)
    batch = global_batch(np.random.default_rng(SEED + 15), cfg.vocab_size, 1,
                         SEQ_TOKENS)
    t = time.perf_counter()
    ranks = HorovodRunner(np=GANG_NP["15"]).run(
        seq_main, cfg=cfg, batch=batch, steps=SEQ_STEPS, seed=SEED,
        device=DEVICE, started=time.time())
    run_wall_s = time.perf_counter() - t
    size = len(ranks)
    _require([r["rank"] for r in ranks] == list(range(size))
             and size == max(-GANG_NP["15"], 1),
             f"phase 15: ranks {[r['rank'] for r in ranks]}")
    _require([r["tokens"] for r in ranks] == [SEQ_TOKENS // size] * size,
             f"phase 15: tokens a rank {[r['tokens'] for r in ranks]}")
    if GANG_NP["15"] <= -2 and DEVICE == "cuda":
        _require(all(r["backend"] == "gloo" for r in ranks),
                 f"phase 15: backends {[r['backend'] for r in ranks]}, "
                 "want gloo for ranks sharing a card")
    _check_seq_ranks(ranks, cfg, SEQ_STEPS)

    # the whole sequence in one process, the kernels' attention
    model = _seq_weights(torch, Llama(cfg, device=DEVICE),
                         _seeded(torch, SEED))
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    loss = make_lm_loss_fn(model, loss="fused")(
        {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()})
    loss.backward()
    whole = loss.item()
    # the global loss is the mean of the ranks' (equal shards)
    ring = float(np.mean([r["step0_loss"] for r in ranks]))
    # Tolerances, stated before the first run: the loss within 1e-2
    # absolute, each adapter gradient within 2^-5 of its norm (phase 6's
    # footing). The ring rounds each hop's partial output to bf16 before
    # its fp32 merge, where the whole sequence rounds once.
    report = {"np": GANG_NP["15"], "n_layers": cfg.n_layers,
              "seq_tokens": SEQ_TOKENS, "size": size, "run_wall_s": run_wall_s,
              "step0_loss": ring, "whole_loss": whole,
              "loss_abs_err": abs(ring - whole), "loss_tol": 1e-2,
              "grads": {}}
    _require(np.isfinite(ring) and abs(ring - whole) <= 1e-2,
             f"phase 15: step 0's loss {ring} on the ring vs {whole} whole")
    got = ranks[0]["step0_grads"]
    for name, p in named:
        ref = p.grad.detach().cpu()
        rel = ((got[name] - ref).norm() / ref.norm()).item()
        report["grads"][name] = {"rel_norm_err": rel,
                                 "max_abs_err": (got[name] - ref).abs()
                                 .max().item()}
        _require(ref.norm() > 0 and rel <= 2.0 ** -5,
                 f"phase 15 {name}: ring vs whole, relative error {rel}")
    del model, named, loss
    report["worst_grad_rel_norm_err"] = max(
        g["rel_norm_err"] for g in report["grads"].values())
    step_s = statistics.median([x for r in ranks for x in r["step_ms"]]) / 1e3
    report.update({
        "step_ms_median": 1e3 * step_s,
        "tokens_per_s": SEQ_TOKENS / step_s,
        # one hop of a pair timed alone (both ranks hopping, nothing
        # else running)
        "hop_ms": ranks[0]["hop_ms"],
        # the hops' exposed ms inside the timed steps, a rank, and their
        # share of the rank's median step
        "step_hop_ms": [r["step_hop_ms"] for r in ranks],
        "hop_share_of_step": [sum(r["step_hop_ms"].values())
                              / r["step_ms_median"] for r in ranks],
        "launches": {k: sum(r["launches"][k] for r in ranks)
                     for k in ranks[0]["launches"]},
        "ranks": [{k: v for k, v in r.items() if k != "step0_grads"}
                  for r in ranks]})
    _log("seq_parallel " + json.dumps(
        {k: v for k, v in report.items() if k != "grads"}))
    return report


def _pipe_blocks(torch, cfg, n_blocks, gen, device):
    """``n_blocks`` decoder blocks of ``cfg`` drawn in order from ``gen``
    (norm scales ones, every other weight normal(0.02)), every weight
    trainable."""
    from sparkdl_tpu_torch.models.llama import Block

    blocks = []
    for _ in range(n_blocks):
        block = Block(cfg, device)
        with torch.no_grad():
            for name, p in block.named_parameters():
                if name.endswith("scale"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=gen)
                p.requires_grad_(True)
        blocks.append(block)
    return blocks


def pipe_main(cfg, n_micro, seq, n_blocks, seed, device, started):
    """Every rank of phase 16: a ``stage`` mesh over the gang, every
    block of the model drawn from the shared seed and this rank's stage
    kept (n_blocks / size blocks, the stage function applying them in
    order); the microbatches (n_micro, 1, seq, d_model) bf16 from the
    seed. First the blocks in order on each microbatch in this process
    (the reference: outputs and this stage's weight gradients of the
    loss sum(out^2)); then the pipeline under each schedule, counters
    zeroed just before and read just after; then both timed in turns
    (True, False, False, True) and one hop timed at the activation's
    shape. Rank 0 returns every rank's report."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.llama import rope_freqs
    from sparkdl_tpu_torch.parallel.mesh import make_named_mesh
    from sparkdl_tpu_torch.parallel.pipeline import make_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    mesh = make_named_mesh("stage")
    dev = _gang_device(torch, mesh, device)
    on_card = dev.type == "cuda"
    per = n_blocks // size
    blocks = _pipe_blocks(torch, cfg, n_blocks, _seeded(torch, seed, dev), dev)
    mine = blocks[rank * per:(rank + 1) * per]
    cos, sin = rope_freqs(cfg.d_model // cfg.n_heads, seq, cfg.rope_theta,
                          cfg.rope_scaling, device=dev)
    positions = torch.arange(seq, device=dev)[None]
    micro = torch.randn((n_micro, 1, seq, cfg.d_model),
                        generator=_seeded(torch, seed + 16, dev),
                        device=dev).to(cfg.dtype)
    ticks = [0]

    def stage_fn(stage, x):
        ticks[0] += 1
        for block in stage:
            x = block(x, cos, sin, positions)
        return x

    def weights():
        return [p for block in mine for p in block.parameters()]

    def run(fn):
        for block in blocks:
            block.zero_grad(set_to_none=True)
        out = fn()
        (out.float() ** 2).sum().backward()
        return out.detach(), [p.grad.detach().clone() for p in weights()]

    def sequential():
        outs = []
        for i in range(n_micro):
            x = micro[i]
            for block in blocks:
                x = block(x, cos, sin, positions)
            outs.append(x)
        return torch.stack(outs)

    ref_out, ref_grads = run(sequential)
    del blocks[:rank * per], blocks[per:]  # keep this stage's only
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    pipes = {ov: make_pipeline(mesh, stage_fn, overlap=ov)
             for ov in (True, False)}
    got, launches, n_ticks = {}, {}, {}
    for overlap in (True, False):
        _zero_flash()
        ticks[0] = 0
        got[overlap] = run(lambda: pipes[overlap](mine, micro))
        if on_card:
            torch.cuda.synchronize(dev)
        launches[str(overlap)] = _flash_launches()
        n_ticks[str(overlap)] = ticks[0]
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    identical = bool(torch.equal(got[True][0], got[False][0])) and all(
        torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))
    out, grads = got[True]
    # Tolerances, stated before the first run: the same kernels on the
    # same inputs in one process, so the outputs within one bf16 ulp;
    # each weight's gradient, a bf16 sum over the microbatches, within
    # 2^-5 of its norm.
    ulp = _bf16_ulp(torch, ref_out.float())
    out_err = (out.float() - ref_out.float()).abs()
    grad_err = [((g.float() - r.float()).norm()
                 / r.float().norm().clamp_min(1e-30)).item()
                for g, r in zip(grads, ref_grads)]
    step_ms = {"True": [], "False": []}
    for overlap in (True, False, False, True):
        step_ms[str(overlap)].append(_host_ms(
            torch, lambda: run(lambda: pipes[overlap](mine, micro)), dev,
            runs=1, warmup=0))
    hop = micro[0].clone()
    report = {
        "rank": rank, "size": size, "backend": _state.state().backend,
        "device": str(dev), "ready_s": ready_s, "ticks": n_ticks,
        "launches": launches, "schedules_bit_identical": identical,
        "out_max_abs_err": out_err.max().item(),
        "out_worst_err_over_ulp": (out_err / ulp).max().item(),
        "out_bit_identical": bool(torch.equal(out, ref_out)),
        "grad_rel_norm_err": max(grad_err),
        "grads_bit_identical": all(torch.equal(g, r)
                                   for g, r in zip(grads, ref_grads)),
        "grads_nonzero": all(bool(r.abs().sum() > 0) for r in ref_grads),
        "n_weights": len(grads), "step_ms": step_ms,
        "hop_ms": _host_ms(torch, lambda: mesh.ppermute(hop, "stage"), dev),
        "peak_mem_gb": peak / 1e9}
    return hvd.allgather_object(report)


def pipeline(torch):
    """Phase 16: HorovodRunner(np=GANG_NP["16"]) ranks of :func:`pipe_main`
    sharing the card; each rank's outputs and stage gradients against the
    blocks in order, both schedules bit-identical, the ticks and the
    flash launches as the schedules predict."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b(attention="flash")
    t = time.perf_counter()
    ranks = HorovodRunner(np=GANG_NP["16"]).run(
        pipe_main, cfg=cfg, n_micro=PIPE_MICROBATCHES, seq=PIPE_SEQ,
        n_blocks=PIPE_BLOCKS, seed=SEED, device=DEVICE, started=time.time())
    run_wall_s = time.perf_counter() - t
    n = len(ranks)
    _require([r["rank"] for r in ranks] == list(range(n))
             and n == max(-GANG_NP["16"], 1),
             f"phase 16: ranks {[r['rank'] for r in ranks]}")
    per = PIPE_BLOCKS // n
    m = PIPE_MICROBATCHES
    want_ticks = {"True": m + 2 * (n - 1), "False": m + n - 1}
    for r in ranks:
        who = f"phase 16 rank {r['rank']}"
        _require(r["ticks"] == want_ticks,
                 f"{who}: ticks {r['ticks']}, want {want_ticks}")
        for overlap, ticks in want_ticks.items():
            # every tick runs the stage's blocks forward and backward
            want = per * ticks
            _require(r["launches"][overlap] == dict.fromkeys(
                r["launches"][overlap], want),
                f"{who} overlap={overlap}: launches "
                f"{r['launches'][overlap]}, want {want} of each")
        _require(r["schedules_bit_identical"],
                 f"{who}: overlap=True and False differ")
        _require(r["out_worst_err_over_ulp"] <= 1.0,
                 f"{who}: outputs {r['out_worst_err_over_ulp']} bf16 ulps "
                 "from the blocks in order")
        _require(r["grads_nonzero"] and r["grad_rel_norm_err"] <= 2.0 ** -5,
                 f"{who}: stage gradients, relative error "
                 f"{r['grad_rel_norm_err']}")
    step_ms = {ov: statistics.median([x for r in ranks
                                      for x in r["step_ms"][ov]])
               for ov in ("True", "False")}
    report = {
        "np": GANG_NP["16"], "stages": n, "blocks_a_stage": per,
        "microbatches": m, "seq": PIPE_SEQ, "run_wall_s": run_wall_s,
        "step_ms_median": step_ms,
        "bubble_share": {ov: (t - m) / t for ov, t in want_ticks.items()},
        "hop_ms": statistics.median(r["hop_ms"] for r in ranks),
        "launches": {k: sum(r["launches"][ov][k] for r in ranks
                            for ov in ("True", "False"))
                     for k in ranks[0]["launches"]["True"]},
        "ranks": ranks}
    _log("pipeline " + json.dumps(report))
    return report


def _count_collectives(mesh):
    """Count the calls of ``mesh``'s collectives (its instance methods
    wrapped: the model and the engine call them through this mesh);
    returns the dict the counts land in."""
    counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
    for name in counts:
        fn = getattr(mesh, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(mesh, name, counted)
    return counts


def _time_collectives(torch, mesh, device, cfg, slots, runs=20):
    """Host ms of each collective of a tensor-parallel decode step at its
    shapes (all ranks call this together): the all-reduce of the hidden
    after o_proj and down_proj, the all-gathers of the embedding and of
    the head's logits, the broadcast of the sampled tokens; and their sum
    a step (2 x layers all-reduces)."""
    m = mesh.axis_size("model")
    cases = {
        "all_reduce": ("all_reduce", (slots, 1, cfg.d_model), cfg.dtype),
        "all_gather_embed": ("all_gather", (slots, 1, cfg.d_model // m),
                             cfg.dtype),
        "all_gather_logits": ("all_gather",
                              (slots, 1, cfg.vocab_size // m),
                              torch.float32),
        "broadcast_tokens": ("broadcast", (2, slots), torch.int32)}
    ms = {}
    for name, (op, shape, dtype) in cases.items():
        x = torch.zeros(shape, dtype=dtype, device=device)
        fn = getattr(mesh, op)
        for _ in range(3):
            fn(x, "model")
        spent = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(x, "model")
            torch.cuda.synchronize()
            spent.append(1e3 * (time.perf_counter() - t))
        ms[name] = statistics.median(spent)
    ms["per_decode_step"] = (2 * cfg.n_layers * ms["all_reduce"]
                             + ms["all_gather_embed"]
                             + ms["all_gather_logits"]
                             + ms["broadcast_tokens"])
    return ms


def _tp_depth2(torch, full, mesh, device, rank):
    """Phase 13's model-level check: the first 2 layers of ``full``
    tensor-parallel on ``mesh`` (the paged decode through its sharded
    binding), through the kernels, against the same TP layers through
    the plain versions (every rank), and against the same layers on one
    card through the kernels and through the plain versions (rank 0
    only): :func:`_depth2_logits` with 2 decode steps. Returns rank 0's
    compared logits (None elsewhere)."""
    from sparkdl_tpu_torch.ops.paged_attention import (
        paged_attention_decode_sharded,
    )

    cfg_kw = {"decode": True, "page_size": 64, "n_pages": 8}
    m = mesh.axis_size("model")
    tp = _depth2(full, device, llama_kw={
        "mesh": mesh, "paged_attention_fn": paged_attention_decode_sharded(
            mesh, n_heads=full.cfg.n_heads, n_kv_heads=full.cfg.n_kv_heads)},
        **cfg_kw)
    refs = {}
    with torch.no_grad():
        got = _depth2_logits(torch, tp, device, 2, SEED + 13)
        with plain_ops():
            refs["tp plain"] = _depth2_logits(torch, tp, device, 2,
                                              SEED + 13)
        del tp
        if rank:
            return None
        one = _depth2(full, device, **cfg_kw)
        refs["one card"] = _depth2_logits(torch, one, device, 2, SEED + 13)
        with plain_ops():
            refs["one card plain"] = _depth2_logits(torch, one, device, 2,
                                                    SEED + 13)
    return [_logits_cmp(torch, g, r, f"phase 13 tp={m} vs {against} "
                                     f"{_call_name(i)}")
            for against, ref in refs.items()
            for i, (g, r) in enumerate(zip(got, ref))]


def _json_safe(obj):
    """``obj`` with numpy scalars and arrays as plain numbers and lists
    (a rank's record goes through a JSON file)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return obj


def _write_json(path, obj):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(_json_safe(obj), f)
    os.replace(tmp, path)


def _recorded(torch, engine, path, base):
    """``engine`` recorded for phases 13 and 27b: from now on its
    launches (counters zeroed here), its mesh's collectives, its prefill
    and decode host clocks (:func:`_time_engine`), each request it is
    given (prompt, budget) and what it returns (tokens, finish reason,
    logprobs), and its decode steps and prefill segments, written to
    ``path`` with ``base`` after each of its runs."""
    counts = _count_collectives(engine.mesh)
    spent = _time_engine(torch, engine)
    stats0 = dict(engine.stats)
    requests, done = {}, {}
    submit, take, run = engine.submit, engine.take_finished, engine.run

    def keep(finished):
        for rid, (toks, reason, lps) in finished.items():
            done[rid] = (toks, reason, lps)
        return finished

    def recorded_submit(prompt, max_new_tokens, **kw):
        rid = submit(prompt, max_new_tokens, **kw)
        requests[rid] = (np.asarray(prompt).tolist(), int(max_new_tokens))
        return rid

    def recorded_run(*a, **k):
        out = run(*a, **k)
        keep({rid: (toks, engine.finish_reasons[rid], engine.logprobs[rid])
              for rid, toks in out.items()})
        torch.cuda.synchronize()
        rids = sorted(requests)
        _write_json(path, dict(
            base, launches=_read_launches(), collectives=dict(counts),
            stats={key: engine.stats[key] - stats0[key]
                   for key in ("steps", "prefill_segments")},
            decode_s=spent["decode"], prefill_s=spent["prefill"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            requests=[requests[r] for r in rids],
            results=[done.get(r) for r in rids]))
        return out

    engine.submit, engine.run = recorded_submit, recorded_run
    engine.take_finished = lambda: keep(take())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()


def tp_rank_engine(cfg, device, started, report_dir):
    """Every rank of phase 27b's gang replica (``rank_factory`` of its
    ``GangReplica``): a mesh over the gang's ranks on the ``model``
    axis; phase 3's weights rebuilt on this rank's card from the shared
    seed (int8, one matrix at a time); an int8 paged engine (8 slots,
    pages of 64, chunk 16) with ``mesh=``, which keeps this rank's
    slice, and the whole model freed; the engine recorded
    (:func:`_recorded`) into ``report_dir`` and handed to the fleet. On
    the replica's first gang, phase 13's model-level check
    (:func:`_tp_depth2`) runs before the engine and its collectives are
    timed at the decode step's shapes after it."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    first = not os.listdir(report_dir)
    hvd.barrier()  # every rank has looked before any writes
    mesh = make_mesh(MeshSpec(model=size))
    dev = _gang_device(torch, mesh, device)
    t = time.perf_counter()
    full = random_quant_llama(torch, cfg, _seeded(torch, SEED, dev), dev)
    depth2 = _tp_depth2(torch, full, mesh, dev, rank) if first else None
    engine = ContinuousBatchingEngine(full, full.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, mesh=mesh,
                                      device=dev)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    base = {"rank": rank, "size": size, "first": first,
            "backend": _state.state().backend, "device": str(dev),
            "ready_s": ready_s, "build_s": time.perf_counter() - t,
            "n_kv_heads_local": engine._model.n_kv_heads, "depth2": depth2,
            "collective_ms": (_time_collectives(torch, mesh, dev, cfg,
                                                engine.n_slots)
                              if first else None)}
    _recorded(torch, engine, os.path.join(
        report_dir, f"rank-{rank}-{os.getpid()}.json"), base)
    return engine


def _gang_records(report_dir, pids, n_requests, timeout=120.0):
    """The records (:func:`_recorded`) of the gang of ``pids``, once each
    rank's shows ``n_requests`` requests served."""
    deadline = time.monotonic() + timeout
    while True:
        recs = []
        for rank, pid in enumerate(pids):
            path = os.path.join(report_dir, f"rank-{rank}-{pid}.json")
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
        if len(recs) == len(pids) and all(
                len(r["requests"]) == n_requests
                and None not in r["results"] for r in recs):
            return recs
        _require(time.monotonic() < deadline,
                 f"phase 27b: the gang {pids} recorded "
                 f"{[len(r['requests']) for r in recs]} requests, not "
                 f"{n_requests} served")
        time.sleep(0.1)


def _in_order(rec, payloads):
    """A rank's record's results in the order of ``payloads`` (matched
    by prompt and budget): (tokens, finish reasons, logprobs)."""
    by = {(tuple(p), b): res for (p, b), res in zip(rec["requests"],
                                                   rec["results"])}
    rows = [by[(tuple(p["tokens"]), p["max_new_tokens"])]
            for p in payloads]
    return ([r[0] for r in rows], [r[1] for r in rows],
            [r[2] for r in rows])


def _check_launches(cfg, recs, what):
    """Each rank's launches held to its engine's counts (a paged decode a
    layer a decode step, 7 int8 matmuls a layer and the head's a
    forward); their sum."""
    for r in recs:
        forwards = r["stats"]["steps"] + r["stats"]["prefill_segments"]
        want = {"paged_attention_decode": cfg.n_layers * r["stats"]["steps"],
                "quantized_matmul": (7 * cfg.n_layers + 1) * forwards,
                "quantized_matmul_int4": 0}
        _require(r["launches"] == want,
                 f"{what} rank {r['rank']}: launches {r['launches']}, the "
                 f"engine's counts predict {want}")
    return {k: sum(r["launches"][k] for r in recs)
            for k in recs[0]["launches"]}


def _check_tp(cfg, recs, burst, phase3, phase3_tokens):
    """Phase 13's checks on its ranks' records of the fleet's first
    burst (phase 3's first ``N_TP_REQUESTS`` requests): the launches and
    collectives (2 all-reduces a layer, 2 all-gathers and 1 token
    broadcast a forward) its engines' counts predict, each rank's kv heads, the
    ranks' tokens, finish reasons, logprobs and stats identical, every
    request on its budget, the model-level logits to phase 4's
    tolerance; returns phase 13's record."""
    size = len(recs)
    _require([r["rank"] for r in recs] == list(range(size))
             and size == max(-GANG_NP["13"], 1) and recs[0]["first"],
             f"phase 13: ranks {[r['rank'] for r in recs]}")
    launches = _check_launches(cfg, recs, "phase 13")
    r0 = recs[0]
    toks, reasons, lps = _in_order(r0, burst)
    for r in recs:
        forwards = r["stats"]["steps"] + r["stats"]["prefill_segments"]
        tp = size > 1
        want = {"all_reduce": 2 * cfg.n_layers * forwards * tp,
                "all_gather": 2 * forwards * tp, "broadcast": forwards * tp}
        _require(r["collectives"] == want,
                 f"phase 13 rank {r['rank']}: collectives "
                 f"{r['collectives']}, want {want}")
        _require(r["n_kv_heads_local"] * size == cfg.n_kv_heads,
                 f"phase 13 rank {r['rank']}: {r['n_kv_heads_local']} kv "
                 "heads in its cache")
        _require(_in_order(r, burst) == (toks, reasons, lps)
                 and r["stats"] == r0["stats"],
                 f"phase 13: rank {r['rank']}'s tokens, logprobs or stats "
                 "differ from rank 0's")
    for i, (t, p, reason, lp) in enumerate(zip(toks, burst, reasons, lps)):
        _require(len(t) == p["max_new_tokens"] and reason == "length"
                 and all(0 <= x < cfg.vocab_size for x in t),
                 f"phase 13 request {i}: {len(t)} tokens on {reason}, "
                 f"budget {p['max_new_tokens']}")
        _require(bool(np.isfinite(lp).all() and (np.asarray(lp)
                                                 <= 1e-6).all()),
                 f"phase 13 request {i}: logprobs not finite and <= 0")
    for row in r0["depth2"]:
        _require_logits(row)
    stats = r0["stats"]
    decoded = sum(len(t) for t in toks) - len(toks)
    report = {k: r0[k] for k in ("rank", "size", "backend", "device",
                                 "ready_s", "build_s", "n_kv_heads_local",
                                 "depth2", "stats", "collectives",
                                 "collective_ms", "peak_mem_gb")}
    report.update({
        "np": GANG_NP["13"], "n_layers": cfg.n_layers,
        "requests": N_TP_REQUESTS, "tokens": toks, "launches": launches,
        "decode_s": r0["decode_s"],
        "decode_ms_per_step": 1e3 * r0["decode_s"] / stats["steps"],
        "decode_tokens_per_s": decoded / r0["decode_s"],
        "prefill_ms_mean": 1e3 * statistics.mean(r0["prefill_s"]),
        "ranks": [{k: r[k] for k in ("rank", "backend", "device",
                                      "peak_mem_gb", "launches",
                                      "collectives")} for r in recs],
        "collectives_per_forward": {
            k: v / (stats["steps"] + stats["prefill_segments"])
            for k, v in r0["collectives"].items()},
        "phase3_decode_ms_per_step": phase3["decode_ms_per_step"],
        "phase3_decode_tokens_per_s": phase3["decode_tokens_per_s"],
        "agree_with_phase3": _agreement(toks,
                                        phase3_tokens[:N_TP_REQUESTS])})
    return report


def serve_tp_fleet(torch, phase3, phase3_tokens):
    """Phases 13 and 27b: a ``FleetFrontend`` of one tensor-parallel
    replica, a gang of ``GangReplica(tp_rank_engine, np=GANG_NP["13"])``
    ranks sharing the card over gloo, so that the 8B TP engine starts
    once. Phase 13's 8 requests through HTTP, the odd ones streamed: the
    ranks' records of them are phase 13 (:func:`_check_tp`), and what
    the clients got is 27b's: every token the ranks' own, exactly, and
    the launches the engines' counts. Then ``N_TP_FAULT_REQUESTS`` long
    requests in flight and rank 1 SIGKILLed at the streamed one's first
    token: each gets 500 and the replica is respawned as a new gang;
    then the first ``N_TP_FAULT_REQUESTS`` requests again, their budgets
    cut to ``TP_AFTER_BUDGET``, give the first burst's tokens. No rank
    outlives ``close()``. Returns phase 13's record and 27b's."""
    import shutil
    import signal

    from sparkdl_tpu_torch.models.fleet import FleetFrontend, GangReplica
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b(n_layers=TP_SERVE_DEPTH, max_cache_len=2048,
                                quant="int8")
    report_dir = tempfile.mkdtemp(prefix="chip-smoke-27b-")
    prompts, budgets = _requests(cfg, N_TP_REQUESTS)
    burst = [{"tokens": p.tolist(), "max_new_tokens": b,
              "stream": bool(i % 2)}
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    again = [dict(p, max_new_tokens=TP_AFTER_BUDGET)
             for p in burst[:N_TP_FAULT_REQUESTS]]
    # long budgets: in flight when the streamed one's first token lands
    doomed = [dict(p, max_new_tokens=128) for p in again]
    fleet, pids, new_pids = None, [], []
    try:
        with _launcher_settings(ABORT_GRACE_S=5.0):
            t = time.perf_counter()
            fleet = FleetFrontend(
                GangReplica(functools.partial(
                    tp_rank_engine, cfg, DEVICE, time.time(), report_dir),
                    np=GANG_NP["13"]),
                replicas=1, max_queue=FLEET_MAX_QUEUE).start()
            start_s = time.perf_counter() - t
            first = fleet._workers[0]
            pids = list(first.pids)

            got, wall = _fleet_burst(fleet, burst)
            served = _burst_summary(got, burst, wall, cfg.vocab_size,
                                    "phase 27b")
            _require(served["answered"] == N_TP_REQUESTS,
                     f"phase 27b: codes {served['codes']}")
            recs = _gang_records(report_dir, pids, N_TP_REQUESTS)
            tp = _check_tp(cfg, recs, burst, phase3, phase3_tokens)
            tp.update(run_wall_s=start_s + wall, wall_s=wall)
            toks = [_fleet_tokens(*g[:2], p)[0] for g, p in zip(got, burst)]
            _require(toks == tp["tokens"],
                     f"phase 27b: tokens through the fleet "
                     f"{_agreement(toks, tp['tokens'])} of the ranks' own")

            killed = {}

            def kill_rank_1():
                if "at" not in killed:
                    killed["at"] = time.perf_counter()
                    os.kill(pids[1], signal.SIGKILL)

            out = [None] * len(doomed)

            def client(i):
                if i == 1:
                    out[i] = _stream_until_first(
                        fleet, dict(doomed[i], stream=True), kill_rank_1)
                else:
                    out[i] = _fleet_post(fleet, dict(doomed[i],
                                                     stream=False))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(doomed))]
            # the blocking ones in flight before the stream starts
            for i, th in enumerate(threads):
                if i != 1:
                    th.start()
            deadline = time.perf_counter() + 60
            while (fleet.replica_states()[0]["inflight"] < len(doomed) - 1
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
            threads[1].start()
            for th in threads:
                th.join(600)
            codes = [o[0] for o in out]
            _require("at" in killed and codes == [500] * len(doomed),
                     f"phase 27b: codes after rank 1's SIGKILL {codes}")
            deadline = time.perf_counter() + 300
            while True:
                w = fleet._workers[0]
                if w is not first and w.alive and w.pids:
                    replaced = time.perf_counter()
                    break
                _require(time.perf_counter() < deadline,
                         "phase 27b: no new gang within 300 s "
                         f"({fleet.replica_states()})")
                time.sleep(0.05)
            new_pids = list(w.pids)
            _require(not set(new_pids) & set(pids)
                     and all(_pid_gone(p) for p in pids),
                     f"phase 27b: old gang {pids}, new {new_pids}")
            got2, _ = _fleet_burst(fleet, again)
            after = _burst_summary(got2, again, 1.0, cfg.vocab_size,
                                   "phase 27b after the respawn")
            toks2 = [_fleet_tokens(*g[:2], p)[0] for g, p in zip(got2, again)]
            want2 = [t[:TP_AFTER_BUDGET] for t in toks[:N_TP_FAULT_REQUESTS]]
            _require(toks2 == want2, "phase 27b: the new gang's tokens "
                     f"{_agreement(toks2, want2)} of the first burst's")
            launches_after = _check_launches(
                cfg, _gang_records(report_dir, new_pids,
                                   N_TP_FAULT_REQUESTS),
                "phase 27b after the respawn")
            restarts = fleet.metrics.counter(
                "server_replica_restarts_total", cause="death").value
            _require(restarts == 1, f"phase 27b: {restarts} restarts")
            respawn_start_s = w.start_s
    finally:
        if fleet is not None:
            fleet.close()
        shutil.rmtree(report_dir, ignore_errors=True)
    gone = [p for p in pids + new_pids if not _pid_gone(p)]
    _require(not gone, f"phase 27b: rank processes alive after close: "
             f"{gone}")
    report = {
        "np": GANG_NP["13"], "requests": N_TP_REQUESTS,
        "gang_start_s": start_s, "burst_wall_s": wall,
        "tokens_per_s": served["tokens_per_s"],
        "ttft_streamed_s": served["ttft_streamed_s"],
        "phase13_decode_tokens_per_s": tp["decode_tokens_per_s"],
        "phase13_decode_ms_per_step": tp["decode_ms_per_step"],
        "launches": tp["launches"], "launches_respawned": launches_after,
        "fault_codes": codes,
        "fault_to_replacement_s": replaced - killed["at"],
        "respawned_gang_start_s": respawn_start_s,
        "after_respawn": {k: after[k] for k in ("codes", "answered")},
        "card": _card_line(torch)}
    tp.pop("tokens")
    _log("tp " + json.dumps(tp))
    _log("fleet_tp " + json.dumps(report))
    return tp, report


def _stream_until_first(fleet, payload, at_first):
    """A streamed client that calls ``at_first()`` at its first token and
    reads on: (500 when its terminal event is an error, else 200,
    the events)."""
    import urllib.request

    host, port = fleet.address
    req = urllib.request.Request(
        f"http://{host}:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if not line.startswith(b"data: "):
                continue
            events.append(json.loads(line[6:]))
            if len(events) == 1 and "token" in events[0]:
                at_first()
    code = 500 if events and "error" in events[-1] else 200
    return code, events


def _pid_gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _mixtral_cfg(n_layers, **kw):
    """Mixtral-8x7B's published widths (``mistralai/Mixtral-8x7B-v0.1``
    config.json; arXiv:2401.04088 Table 1) as LlamaConfig fields, at a
    cut depth."""
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(n_layers=n_layers, **MIXTRAL, **kw)


def serve_moe(torch):
    """Phase 17: Mixtral-8x7B widths at depth MOE_SERVE_DEPTH, int8
    attention and head (B5), bf16 experts, fp32 routers, through phase
    3's paged engine on phase 3's requests in vocab 32000; launches
    against the engine's counts, every request on its budget; then the
    depth-2 logits through the kernels against the plain versions."""
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = _mixtral_cfg(MOE_SERVE_DEPTH, max_cache_len=2048, quant="int8")
    t = time.perf_counter()
    model = random_quant_llama(torch, cfg, _seeded(torch, SEED + 17))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, device=DEVICE)
    prompts, budgets = _requests(cfg)
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    spent = _time_engine(torch, engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _require(launches.pop("quantized_matmul_int4") == 0,
             "phase 17: the int8 run launched the int4 matmul")
    _check_budgets(engine, results, rids, budgets, cfg.vocab_size, "17")
    stats = dict(engine.stats)
    L = cfg.n_layers
    # a decode step: one paged decode a layer; q, k, v, o a layer and
    # the head in int8 (the experts and the routers stay dense)
    want = {"paged_attention_decode": L * stats["steps"],
            "quantized_matmul": (4 * L + 1)
            * (stats["steps"] + stats["prefill_segments"])}
    for name, n in launches.items():
        _require(n > 0 and n == want[name],
                 f"phase 17 {name}: {n} launches, engine counts predict "
                 f"{want[name]}")
    decoded = sum(len(results[r]) for r in rids) - len(rids)
    # the dense combine reads every expert of every layer each step
    expert_bytes = (L * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
                    * torch.finfo(cfg.dtype).bits // 8)
    report = {
        "n_layers": L, "n_experts": cfg.n_experts, "top_k": cfg.moe_top_k,
        "vocab": cfg.vocab_size, "requests": len(rids), "n_slots": 8,
        "page_size": 64, "chunk": 16, "init_s": init_s,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": int(decoded + len(rids)), "wall_s": wall,
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "expert_bytes_per_step": expert_bytes,
        "expert_bound_ms_per_step": 1e3 * expert_bytes / HBM_BYTES_PER_S,
        "decode_tokens_per_s": decoded / spent["decode"],
        "prefill_s": sum(spent["prefill"]),
        "prefill_ms_mean": 1e3 * statistics.mean(spent["prefill"]),
        "prefill_ms_max": 1e3 * max(spent["prefill"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stats": stats, "launches": launches,
        "launches_per_decode_step": {"paged_attention_decode": L,
                                     "quantized_matmul": 4 * L + 1},
    }
    # one MoE layer alone at the decode step's shape (8 slots), L2
    # flushed: the layer's device ms beside its experts' byte bound
    timer = Timer(torch)
    x = torch.randn((8, 1, cfg.d_model), generator=_seeded(torch, SEED),
                    device=DEVICE).to(cfg.dtype)
    with torch.no_grad():
        layer_ms = timer.ms(lambda: model.layers[0].moe_mlp(x))
    report.update({"moe_layer_ms_at_decode": layer_ms,
                   "moe_layers_ms_per_step": layer_ms * L})
    del timer
    _log("moe_serving " + json.dumps(report))
    del engine
    gc.collect()
    report["logits"] = moe_vs_plain_model(torch, model)
    return report


@contextlib.contextmanager
def _routes(masks, replay=False):
    """Record every top-k expert choice the MoE code makes (its
    ``_topk_mask`` calls) into ``masks``, in order; with ``replay``,
    make each call return the next recorded mask instead, and count the
    tokens whose own choice differed. The depth-2 checks run the plain
    versions first, recording, then the kernels replaying: both paths
    route alike, so the comparison measures the kernels. (A near-tie of
    the router's top k that bf16 rounding decides otherwise moves a
    token's whole expert output, and with it every later layer; the
    package has no such switch.)"""
    from sparkdl_tpu_torch.models import moe

    own = moe._topk_mask
    report = {"calls": 0, "tokens": 0, "routed_otherwise": 0}

    def choose(probs, top_k):
        mask = own(probs, top_k)
        if not replay:
            masks.append(mask)
            return mask
        want = masks[report["calls"]]
        report["calls"] += 1
        _require(want.shape == mask.shape,
                 f"replayed routes: shape {tuple(mask.shape)}, recorded "
                 f"{tuple(want.shape)}")
        differ = (want != mask).any(-1)
        report["tokens"] += differ.numel()
        report["routed_otherwise"] += int(differ.sum())
        return want

    moe._topk_mask = choose
    try:
        yield report
    finally:
        moe._topk_mask = own
    if replay:
        _require(report["calls"] == len(masks),
                 f"replayed {report['calls']} of {len(masks)} routes")


def moe_vs_plain_model(torch, model):
    """Phase 17's depth-2 check: phase 4's calls through the first two
    layers of the MoE model, through the plain versions and then
    through the kernels routed as the plain run routed
    (:func:`_routes`), held to phase 4's tolerance; the share of tokens
    whose own route differed is reported."""
    small = _depth2(model, decode=True, page_size=64, n_pages=8)
    masks = []
    with torch.no_grad():
        with plain_ops(), _routes(masks):
            ref = _depth2_logits(torch, small, DEVICE, 4, SEED + 1)
        with _routes(masks, replay=True) as routed:
            got = _depth2_logits(torch, small, DEVICE, 4, SEED + 1)
    report = {"calls": [_logits_row(torch, g, r, f"moe {_call_name(i)}")
                        for i, (g, r) in enumerate(zip(got, ref))],
              "routed_otherwise_share": routed["routed_otherwise"]
              / routed["tokens"]}
    _log("moe " + json.dumps(report))
    return report


def _moe_loss(model, per_layer):
    """Phase 18's loss over ``model``: cross entropy + 0.01 x
    ``moe_aux_loss`` of the step's router probabilities (composed by
    the caller, as tests/models/test_moe_llama.py does), with
    ``f.model``; each layer's load-balance loss goes to ``per_layer``."""
    import torch

    from sparkdl_tpu_torch.models.moe import load_balance_loss, moe_aux_loss
    from sparkdl_tpu_torch.parallel.train import cross_entropy_loss

    k = model.cfg.moe_top_k

    def loss_fn(batch):
        device = next(model.parameters()).device
        inputs = torch.as_tensor(batch["inputs"], device=device)
        targets = torch.as_tensor(batch["targets"], device=device)
        logits, inter = model(inputs, return_intermediates=True)
        per_layer[:] = [load_balance_loss(s["moe_mlp"]["router_probs"][0]
                                          .detach(), k)
                        for s in inter.values()]
        return (cross_entropy_loss(logits, targets)
                + 0.01 * moe_aux_loss(inter, k))

    loss_fn.model = model
    return loss_fn


def train_moe(torch, gen):
    """Phase 18: LoRA (rank 16 on q and v) on Mixtral-8x7B widths at
    depth MOE_TRAIN_DEPTH, flash attention (B1-B3), bf16 base and
    experts, fp32 routers, adapters, norms and head; batch 1 x
    MOE_TRAIN_SEQ, CE + 0.01 aux, AdamW on the adapters: a warm-up step,
    then MOE_TRAIN_STEPS timed (flash counters zeroed between) and one
    profiled; then the depth-2 loss and adapter gradients through the
    kernels against the plain versions."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_train_step,
    )

    cfg = _mixtral_cfg(MOE_TRAIN_DEPTH, attention="flash", lora_rank=16,
                       lora_alpha=16.0, lora_targets=("q_proj", "v_proj"))
    t = time.perf_counter()
    model = init_weights(Llama(cfg, device=DEVICE), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    mask = lora_mask(model)
    lora = [p for n, p in model.named_parameters() if mask[n]]
    opt = torch.optim.AdamW(lora, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    per_layer = []
    step = make_train_step(_moe_loss(model, per_layer), opt, param_mask=mask,
                           device=DEVICE)
    batch = global_batch(np.random.default_rng(SEED + 18), cfg.vocab_size,
                         1, MOE_TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batch)["loss"].item()]
    _zero_flash()
    times = []
    for _ in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch)["loss"].item())
        times.append(time.perf_counter() - t)
    launches = _flash_launches()
    peak = torch.cuda.max_memory_allocated()
    aux = [x.item() for x in per_layer]
    k, e = cfg.moe_top_k, cfg.n_experts
    _require(all(np.isfinite(losses)), f"phase 18 losses {losses}")
    _require(len(aux) == cfg.n_layers and all(k <= a <= e * k for a in aux),
             f"phase 18: the layers' load-balance losses {aux} outside "
             f"[top_k, E x top_k] = [{k}, {e * k}]")
    want = cfg.n_layers * MOE_TRAIN_STEPS
    for name, n in launches.items():
        _require(n == want, f"phase 18 {name}: {n} launches in "
                 f"{MOE_TRAIN_STEPS} steps, want {want}")
    step_s = statistics.median(times)
    report = {"n_layers": cfg.n_layers, "n_experts": e, "top_k": k,
              "batch": 1, "seq": MOE_TRAIN_SEQ, "lora_rank": cfg.lora_rank,
              "losses": losses, "aux_per_layer": aux, "init_s": init_s,
              "step_ms": [1e3 * x for x in times],
              "step_ms_median": 1e3 * step_s,
              "tokens_per_s": MOE_TRAIN_STEPS * MOE_TRAIN_SEQ / sum(times),
              "peak_mem_gb": peak / 1e9, "launches": launches}
    # the experts' einsums are the step's only batched GEMMs (attention
    # runs in the flash kernels, the projections and the head as mm)
    report["profile"] = profile_step(torch, step, batch, 1e3 * step_s,
                                     ops=("aten::bmm",))
    bmm_ms = report["profile"]["ops_device_ms"].get("aten::bmm", 0.0)
    report["expert_gemm_share_of_busy"] = (
        bmm_ms / report["profile"]["device_busy_ms"]
        if report["profile"]["device_busy_ms"] else None)
    _log("moe_train " + json.dumps({k_: v for k_, v in report.items()
                                    if k_ != "profile"}))
    del step, opt
    report["vs_plain"] = _moe_train_vs_plain(torch, model, gen)
    return report


def _moe_train_vs_plain(torch, model, gen):
    """Phase 18's depth-2 check: the first two layers of its model (the
    same tensors), non-zero ``lora_b``, one batch of 1 x MOE_TRAIN_SEQ:
    the loss and every adapter gradient through the kernels and through
    the plain versions, held to phase 6's tolerance."""
    from sparkdl_tpu_torch.parallel.train import global_batch

    small = _depth2(model)
    lora = {n: p for n, p in small.named_parameters() if p.requires_grad}
    with torch.no_grad():
        for n, p in lora.items():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    loss_fn = _moe_loss(small, [])
    batch = global_batch(np.random.default_rng(SEED + 19),
                         small.cfg.vocab_size, 1, MOE_TRAIN_SEQ)

    def run():
        for p in lora.values():
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in lora.items()}

    masks = []
    with plain_ops(), _routes(masks):
        ref_loss, ref = run()
    with _routes(masks, replay=True) as routed:
        got_loss, got = run()
    # phase 6's tolerance: the paths differ in attention alone, and the
    # kernels route as the plain run routed (_routes)
    report = {"loss": got_loss, "plain_loss": ref_loss, "grads": {},
              "routed_otherwise_share": routed["routed_otherwise"]
              / routed["tokens"]}
    _require(np.isfinite(got_loss)
             and abs(got_loss - ref_loss) <= 2.0 ** -10 * abs(ref_loss),
             f"phase 18 loss, kernels {got_loss} vs plain {ref_loss}")
    for name, g in got.items():
        r = ref[name]
        rel = ((g - r).norm() / r.norm()).item()
        report["grads"][name] = rel
        _require(bool(torch.isfinite(g).all()) and r.norm() > 0
                 and rel <= 2.0 ** -5,
                 f"phase 18 {name} gradient, kernels vs plain: relative "
                 f"error {rel}")
    report["worst_rel_norm_err"] = max(report["grads"].values())
    _log("moe_train_vs_plain " + json.dumps(
        {k: v for k, v in report.items() if k != "grads"}))
    return report


def _ep_close(torch, got, ref):
    """One tensor against the single-process layer's: the error's norm
    relative to the reference's, and the worst element against the
    reference's largest."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return {"rel_norm_err": ((got - ref).norm() / ref.norm()).item(),
            "max_abs_err": err.max().item(),
            "scale": ref.abs().max().item()}


def _timed_collectives(torch, mesh, device):
    """The host ms of every all-reduce and all-to-all ``mesh`` issues,
    each between two synchronizes (gloo stages through the host, so the
    card waits for them anyway); returns the list they fill."""
    spent = []

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(device)
            spent.append(1e3 * (time.perf_counter() - t))
            return out
        return call

    mesh.all_reduce = timed(mesh.all_reduce)
    mesh._all_to_all = timed(mesh._all_to_all)
    return spent


def ep_main(layer, tokens, capacity, runs, seed, device, started):
    """Every rank of phase 19: ``make_named_mesh("expert")``, one MoE
    layer of ``layer`` (MoEConfig fields) drawn from ``seed`` on every
    rank alike, and held whole once as the single-process oracle on
    n x ``tokens`` tokens (its loss sum(y * w)); then this rank's
    experts through the psum form on all the tokens and through the
    all-to-all form on its ``tokens`` at no-drop capacity (E / top_k)
    and at ``capacity``, forward and backward, each ``runs`` times
    after a warm-up, the collectives' host ms recorded. Rank 0 returns
    every rank's report."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models import moe
    from sparkdl_tpu_torch.parallel.mesh import make_named_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    ready_s = time.time() - started
    mesh = make_named_mesh("expert")
    dev = _gang_device(torch, mesh, device)
    rank, n = mesh.axis_index("expert"), mesh.axis_size("expert")
    cfg = moe.MoEConfig(**layer)
    oracle = moe.MoEMLP(cfg, dev)
    gen = _seeded(torch, seed, dev)
    with torch.no_grad():
        for p in (*(getattr(oracle, k) for k in moe.EXPERT_WEIGHTS),
                  oracle.router.kernel):
            p.normal_(0.0, 0.02, generator=gen)
        oracle.router.bias.zero_()
    x = torch.randn((n * tokens, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    w = torch.randn((n * tokens, cfg.d_model), generator=gen, device=dev)
    e = cfg.n_experts // n
    mine = slice(rank * e, (rank + 1) * e)
    rows = slice(rank * tokens, (rank + 1) * tokens)
    # the oracle: every expert, every token, one process
    for p in oracle.parameters():
        p.requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y_ref = oracle(xr)
    (y_ref.float() * w).sum().backward()
    ref = {"router.kernel": oracle.router.kernel.grad,
           "router.bias": oracle.router.bias.grad,
           **{k: getattr(oracle, k).grad[mine].clone()
              for k in moe.EXPERT_WEIGHTS}, "x": xr.grad}
    y_ref = y_ref.detach()
    with torch.no_grad():
        ref_chosen = moe._topk_mask(torch.softmax(oracle.router(x), -1),
                                    cfg.top_k) > 0
    local = {"router": {"kernel": oracle.router.kernel.detach().clone(),
                        "bias": oracle.router.bias.detach().clone()},
             **{k: getattr(oracle, k).detach()[mine].clone()
                for k in moe.EXPERT_WEIGHTS}}
    del oracle, xr
    gc.collect()
    torch.cuda.empty_cache()
    leaves = [local["router"]["kernel"], local["router"]["bias"],
              *(local[k] for k in moe.EXPERT_WEIGHTS)]
    for p in leaves:
        p.requires_grad_(True)
    spent = _timed_collectives(torch, mesh, dev)
    forms = {"psum": (moe.expert_parallel_moe(mesh, cfg), slice(None)),
             "a2a": (moe.expert_parallel_moe_a2a(
                 mesh, cfg, capacity_factor=cfg.n_experts / cfg.top_k), rows),
             "a2a_tight": (moe.expert_parallel_moe_a2a(
                 mesh, cfg, capacity_factor=capacity), rows)}
    report = {"rank": rank, "size": n, "backend": _state.state().backend,
              "device": str(dev), "ready_s": ready_s, "forms": {}}
    torch.cuda.reset_peak_memory_stats(dev)
    for name, (f, cut) in forms.items():
        ms, coll = [], []
        for i in range(runs + 1):
            for p in leaves:
                p.grad = None
            xi = x[cut].clone().requires_grad_(True)
            torch.cuda.synchronize(dev)
            spent.clear()
            t = time.perf_counter()
            y = f(local, xi)
            (y.float() * w[cut]).sum().backward()
            torch.cuda.synchronize(dev)
            if i:  # the first run warms up
                ms.append(1e3 * (time.perf_counter() - t))
                coll.append(sum(spent))
        # the binder's own routing, replayed: a row whose experts differ
        # from the oracle's met a near-tie that its fp32 router product
        # over other rows decided otherwise (counted, left out)
        with torch.no_grad():
            sel = moe.moe_gates(xi.float() @ local["router"]["kernel"]
                                + local["router"]["bias"], cfg.top_k) > 0
        rows_kept = (sel == ref_chosen[cut]).all(-1)
        row = {"ms_per_call": ms, "ms_median": statistics.median(ms),
               "collective_ms": coll,
               "collective_ms_median": statistics.median(coll),
               "tokens": int(xi.shape[0]),
               "routed_alike": rows_kept.float().mean().item()}
        if name == "a2a_tight":
            # only the rows whose chosen experts all won a slot
            c = max(1, int(np.ceil(xi.shape[0] * cfg.top_k / cfg.n_experts
                                   * capacity)))
            pos = torch.cumsum(sel.int(), 0) - 1
            survived = ((~sel) | (pos < c)).all(-1)
            rows_kept &= survived
            row.update({"capacity": c, "survivors": int(survived.sum())})
        else:
            got = {"router.kernel": local["router"]["kernel"].grad,
                   "router.bias": local["router"]["bias"].grad,
                   **{k: local[k].grad for k in moe.EXPERT_WEIGHTS},
                   "x": xi.grad}
            row["grads"] = {k: _ep_close(torch, g, ref[k] if k != "x"
                                         else ref[k][cut])
                            for k, g in got.items()}
        row["out"] = _ep_close(torch, y.detach()[rows_kept],
                               y_ref[cut][rows_kept])
        report["forms"][name] = row
        del y, xi
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return hvd.allgather_object(report)


def expert_parallel(torch):
    """Phase 19: HorovodRunner(np=GANG_NP["19"]) ranks of :func:`ep_main`
    sharing the card over gloo, one MoE layer at Mixtral-8x7B width
    (E / n experts a rank); both forms against the single-process layer
    within bf16 tolerance."""
    from sparkdl_tpu_torch import HorovodRunner

    layer = dict(d_model=MIXTRAL["d_model"], d_ff=MIXTRAL["d_ff"],
                 n_experts=MIXTRAL["n_experts"], top_k=MIXTRAL["moe_top_k"],
                 dtype=torch.bfloat16)
    t = time.perf_counter()
    ranks = HorovodRunner(np=GANG_NP["19"]).run(
        ep_main, layer=layer, tokens=EP_TOKENS, capacity=EP_CAPACITY,
        runs=EP_RUNS, seed=SEED + 19, device=DEVICE, started=time.time())
    run_wall_s = time.perf_counter() - t
    size = len(ranks)
    _require([r["rank"] for r in ranks] == list(range(size))
             and size == max(-GANG_NP["19"], 1),
             f"phase 19: ranks {[r['rank'] for r in ranks]}")
    if GANG_NP["19"] <= -2 and DEVICE == "cuda":
        _require(all(r["backend"] == "gloo" for r in ranks),
                 f"phase 19: backends {[r['backend'] for r in ranks]}")
    # bf16 tolerance, stated before the first run (the outputs on the
    # rows routed as the oracle routes them, at least 99 % of them): the
    # forms sum the experts' bf16 partial outputs in other orders and
    # round at other points (a rank's combine, the all-reduce, the
    # dispatch buffers), one or two bf16 ulps (2^-8 relative) an
    # element, so the output's error norm within 2^-7 of its norm and
    # the worst element within 2^-5 of its scale; each gradient within
    # 2^-5 of its norm (phase 6's footing)
    worst = {"out": 0.0, "grad": 0.0}
    for r in ranks:
        for name, row in r["forms"].items():
            out = row["out"]
            worst["out"] = max(worst["out"], out["rel_norm_err"])
            _require(out["rel_norm_err"] <= 2.0 ** -7
                     and out["max_abs_err"] <= 2.0 ** -5 * out["scale"],
                     f"phase 19 rank {r['rank']} {name} output: {out}")
            for g_name, g in row.get("grads", {}).items():
                worst["grad"] = max(worst["grad"], g["rel_norm_err"])
                _require(g["rel_norm_err"] <= 2.0 ** -5,
                         f"phase 19 rank {r['rank']} {name} {g_name} "
                         f"gradient: {g}")
        _require(r["forms"]["a2a_tight"]["survivors"] > 0,
                 f"phase 19 rank {r['rank']}: no row survived capacity "
                 f"{EP_CAPACITY}")
        _require(all(row["routed_alike"] >= 0.99
                     for row in r["forms"].values()),
                 f"phase 19 rank {r['rank']}: routed alike "
                 f"{[row['routed_alike'] for row in r['forms'].values()]}")
    report = {"np": GANG_NP["19"], "size": size, "run_wall_s": run_wall_s,
              "worst_out_rel_norm_err": worst["out"],
              "worst_grad_rel_norm_err": worst["grad"],
              "ms_per_call": {name: [r["forms"][name]["ms_median"]
                                     for r in ranks]
                              for name in ranks[0]["forms"]},
              "collective_ms_per_call": {
                  name: [r["forms"][name]["collective_ms_median"]
                         for r in ranks] for name in ranks[0]["forms"]},
              "ranks": ranks}
    _log("expert_parallel " + json.dumps(report))
    return report


def _tp_collectives(torch, mesh, device):
    """Count and time every all-reduce and all-gather ``mesh`` issues
    (its instance methods wrapped: the model's differentiable
    collectives call them), each between two synchronizes of ``device``
    (gloo stages through the host, so the card waits for them anyway).
    Returns ``{kind: [host ms of each call]}``, which the calls fill."""
    calls = {"all_reduce": [], "all_gather": []}
    on_card = device.type == "cuda"
    for kind, spent in calls.items():
        fn = getattr(mesh, kind)

        def call(*a, _fn=fn, _spent=spent, **k):
            if on_card:
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = _fn(*a, **k)
            if on_card:
                torch.cuda.synchronize(device)
            _spent.append(1e3 * (time.perf_counter() - t))
            return out

        setattr(mesh, kind, call)
    return calls


def _tp_train_collectives(cfg, seq, chunk=512):
    """Phase 20's collectives on a model axis of two, a forward and a
    backward, as the model issues them (LoRA on column-parallel
    targets, the vocabulary-parallel fused loss in chunks of ``chunk``):
    the forward all-gathers the embedding's d_model once and each
    chunk's (logsumexp, gold) pairs once, and all-reduces o_proj's and
    down_proj's partial outputs in every layer (g); the backward
    all-reduces the gradient of every input that entered through f: the
    loss's hidden, each layer's MLP input, each layer's attention input
    but layer 0's (the frozen embedding's output carries no gradient),
    and each column-parallel target's whole ``lora_a``."""
    n_layers, n_lora = cfg.n_layers, len(cfg.lora_targets)
    chunks = -(-seq // chunk)
    return ({"all_reduce": 2 * n_layers, "all_gather": 1 + chunks},
            {"all_reduce": 1 + n_layers + (n_layers - 1) + n_lora * n_layers,
             "all_gather": 0})


def _tp_weights(torch, cfg, seed, device):
    """Phase 20's whole model: :func:`_seq_weights` from a generator of
    its own seeded with ``seed`` (every rank and the launching process draw the
    same)."""
    from sparkdl_tpu_torch.models.llama import Llama

    return _seq_weights(torch, Llama(cfg, device=device),
                        _seeded(torch, seed, device))


def tp_train_main(cfg, batch, steps, seed, device, ckpt_dir, started):
    """Every rank of phase 20: ``make_mesh(MeshSpec(model=size))``, the
    whole LoRA Llama of ``cfg`` drawn from ``seed`` and this rank's slice
    of it kept (``Llama.from_params(..., mesh=mesh)``), AdamW on its
    adapters, the vocabulary-parallel fused loss. Step 0's loss and its
    gathered adapter gradients (no update) with the collectives of its
    forward and of its backward; then ``steps`` timed steps, the flash
    counters and the collectives recorded from zero, the whole adapters
    gathered after step 1 and after the last; then a save of the
    adapters with their specs (every rank; rank 0 writes) and the loss
    of the saved weights. Rank 0 returns every rank's report (the
    gathered tensors in rank 0's)."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.sharding import full_host_value
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
    )
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    mesh = make_mesh(MeshSpec(model=size))
    dev = _gang_device(torch, mesh, device)
    on_card = dev.type == "cuda"
    t = time.perf_counter()
    whole = _tp_weights(torch, cfg, seed, dev)
    model = Llama.from_params(cfg, whole.state_dict(), device=dev, mesh=mesh)
    del whole
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    build_s = time.perf_counter() - t
    specs = model.tp_specs
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    loss_fn = make_lm_loss_fn(model, loss="fused")
    step = make_train_step(loss_fn, opt, param_mask=mask, device=dev)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def gather(tensors):
        return {n: full_host_value(x, specs.get(n, ()), mesh)
                for n, x in tensors}

    calls = _tp_collectives(torch, mesh, dev)

    def counted():
        out = {k: len(v) for k, v in calls.items()}
        ms = sum(sum(v) for v in calls.values())
        for v in calls.values():
            v.clear()
        return out, ms

    # step 0's loss and gradients, no update
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(on_dev)
    forward, _ = counted()
    loss.backward()
    backward, _ = counted()
    step0_loss = loss.item()
    del loss
    grads = gather((n, p.grad) for n, p in named)
    opt.zero_grad(set_to_none=True)

    _zero_flash()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times, step_calls, step_coll_ms = [], [], [], []
    after1 = None
    for i in range(steps):
        counted()  # drop what a gather between the steps issued
        if on_card:
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        losses.append(step(on_dev)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
        n_calls, ms = counted()
        step_calls.append(n_calls)
        step_coll_ms.append(ms)
        if i == 1:
            after1 = gather(named)
    launches = _flash_launches()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    final = gather(named)

    ckpt = TrainCheckpointer(ckpt_dir)
    if on_card:
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    wrote = ckpt.save(steps, dict(named), mesh=mesh, specs=specs)
    save_ms = 1e3 * (time.perf_counter() - t)
    hvd.barrier()
    with torch.no_grad():
        saved_loss = loss_fn(on_dev).item()
    report = {
        "rank": rank, "size": size, "backend": _state.state().backend,
        "device": str(dev), "ready_s": ready_s, "build_s": build_s,
        "heads_local": model.layers[0].attn.n_heads,
        "kv_heads_local": model.n_kv_heads,
        "vocab_local": int(model.lm_head.kernel.shape[1]),
        "step0_loss": step0_loss, "forward_collectives": forward,
        "backward_collectives": backward, "step_collectives": step_calls,
        "losses": losses, "step_ms": [1e3 * x for x in times],
        "step_ms_median": 1e3 * statistics.median(times),
        "collective_ms": step_coll_ms,
        "collective_ms_median": statistics.median(step_coll_ms),
        "launches": launches, "peak_mem_gb": peak / 1e9,
        "adapter_sha256": _adapter_digest(list(final.items())),
        "saved_loss": saved_loss, "wrote": wrote, "save_ms": save_ms,
        "save": ckpt.last_save,
        "step0_grads": grads if rank == 0 else None,
        "after1": after1 if rank == 0 else None}
    return hvd.allgather_object(report)


def _rel_norm_err(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _fp32_run(torch, model, mask, batch):
    """``model``'s weights widened to fp32, dense attention, the fused
    loss in fp32: the step-0 loss and the trained leaves' gradients, then
    the trained leaves after two AdamW steps of phase 20's settings (on
    the host). The yardstick of phase 20's bf16 gradients and updates."""
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.parallel.train import make_lm_loss_fn

    cfg = dataclasses.replace(model.cfg, dtype=torch.float32,
                              attention="reference")
    twin = Llama(cfg, device=model.device)
    twin.load_state_dict(model.state_dict())
    for name, p in twin.named_parameters():
        p.requires_grad_(mask[name])
    named = [(n, p) for n, p in twin.named_parameters() if mask[n]]
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    loss_fn = make_lm_loss_fn(twin, loss="fused")
    loss = loss_fn(batch)
    loss.backward()
    out = {"loss": loss.item(),
           "grads": {n: p.grad.detach().cpu() for n, p in named}}
    del loss
    opt.step()
    opt.zero_grad(set_to_none=True)
    loss_fn(batch).backward()
    opt.step()
    out["after1"] = {n: p.detach().cpu() for n, p in named}
    del twin, named, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train(torch):
    """Phase 20: HorovodRunner(np=GANG_NP["20"]) ranks of
    :func:`tp_train_main` sharing the card over gloo; then one process
    holding the whole model of the same depth and weights: its step 0
    and its steps against the ranks', and the ranks' checkpoint restored
    onto it through ``restore(target_mesh=...)`` on a one-rank mesh."""
    import shutil
    import tempfile

    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
    )
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    cfg = _train_cfg(n_layers=TP_TRAIN_DEPTH)
    batch = global_batch(np.random.default_rng(SEED + 20), cfg.vocab_size, 1,
                         TP_TRAIN_SEQ)
    work = tempfile.mkdtemp(prefix="chip-smoke-20-")
    ckpt_dir = os.path.join(work, "ckpt")
    try:
        t = time.perf_counter()
        ranks = HorovodRunner(np=GANG_NP["20"]).run(
            tp_train_main, cfg=cfg, batch=batch, steps=TP_TRAIN_STEPS,
            seed=SEED + 20, device=DEVICE, ckpt_dir=ckpt_dir,
            started=time.time())
        run_wall_s = time.perf_counter() - t
        size = len(ranks)
        _require([r["rank"] for r in ranks] == list(range(size))
                 and size == max(-GANG_NP["20"], 1),
                 f"phase 20: ranks {[r['rank'] for r in ranks]}")
        if GANG_NP["20"] <= -2 and DEVICE == "cuda":
            _require(all(r["backend"] == "gloo" for r in ranks),
                     f"phase 20: backends {[r['backend'] for r in ranks]}")
        forward, backward = _tp_train_collectives(cfg, TP_TRAIN_SEQ)
        tp = size > 1
        if not tp:
            forward = backward = {"all_reduce": 0, "all_gather": 0}
        step_want = {k: forward[k] + backward[k] for k in forward}
        r0 = ranks[0]
        for r in ranks:
            _require(r["heads_local"] * size == cfg.n_heads
                     and r["kv_heads_local"] * size == cfg.n_kv_heads
                     and r["vocab_local"] * size == cfg.vocab_size,
                     f"phase 20 rank {r['rank']}: {r['heads_local']} heads, "
                     f"{r['kv_heads_local']} kv heads, {r['vocab_local']} "
                     "vocabulary columns")
            _require(r["forward_collectives"] == forward
                     and r["backward_collectives"] == backward,
                     f"phase 20 rank {r['rank']}: collectives of a forward "
                     f"{r['forward_collectives']} and a backward "
                     f"{r['backward_collectives']}, the model predicts "
                     f"{forward} and {backward}")
            _require(all(c == step_want for c in r["step_collectives"]),
                     f"phase 20 rank {r['rank']}: collectives a step "
                     f"{r['step_collectives']}, want {step_want}")
            want = cfg.n_layers * TP_TRAIN_STEPS
            _require(r["launches"] == dict.fromkeys(r["launches"], want),
                     f"phase 20 rank {r['rank']}: launches {r['launches']}, "
                     f"want {want} of each")
            _require(all(np.isfinite(r["losses"])),
                     f"phase 20 rank {r['rank']}: losses {r['losses']}")
            # every rank computes the whole loss
            for key in ("adapter_sha256", "losses", "step0_loss",
                        "saved_loss"):
                _require(r[key] == r0[key],
                         f"phase 20: rank {r['rank']}'s {key} differs "
                         "from rank 0's")
        _require([r["wrote"] for r in ranks]
                 == [True] + [False] * (size - 1),
                 f"phase 20: writers {[r['wrote'] for r in ranks]}")

        # one process, the whole model of the same weights and batch:
        # first its fp32 twin (the same bf16 weights widened, dense
        # attention), whose step-0 gradients and first two updates are
        # the yardstick of both bf16 runs, then the model itself
        model = _tp_weights(torch, cfg, SEED + 20, torch.device(DEVICE))
        mask = lora_mask(model)
        on_dev = {k: torch.as_tensor(v, device=DEVICE)
                  for k, v in batch.items()}
        exact = _fp32_run(torch, model, mask, on_dev)
        named = [(n, p) for n, p in model.named_parameters() if mask[n]]
        initial = {n: p.detach().cpu().clone() for n, p in named}
        opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        loss_fn = make_lm_loss_fn(model, loss="fused")
        step = make_train_step(loss_fn, opt, param_mask=mask, device=DEVICE)
        loss = loss_fn(on_dev)
        loss.backward()
        whole_loss = loss.item()
        del loss
        # Tolerances: the loss within 2^-10 relative (phase 6's), at
        # step 0 and at every timed step. The step-0 gradients: TP rounds each row-parallel projection's
        # two partial outputs, and each f's two partial input gradients,
        # to bf16 before their sum, where one card rounds the whole sum
        # once, and near-uniform attention makes the q and k gradients
        # cancel: on one H100 80GB HBM3 at 700 W, TP's were up to 6.0 %
        # of their norm off one card's (layer 7's q). So each bf16 run is
        # held against the fp32 gradient of the same weights: TP's error
        # within twice one card's (a missing f or g halves a gradient: an
        # error near 50 %). The adapters' update over steps 0 and 1
        # (after step 1 less the initial weights, each entry about 2e-4
        # against weights of 0.02: 1 % of their norm): AdamW's first
        # steps move each entry by about lr times the sign of its
        # gradient, so the entries whose gradient bf16 rounding flips
        # move the other way on either run, and TP's update is held
        # against the fp32 twin's within twice one card's distance or
        # 2^-5 of its norm, the larger (phase 15's tolerance, applied to
        # the change; an update lost or of the wrong sign is 100 % or
        # 200 % off).
        report = {"np": GANG_NP["20"], "n_layers": cfg.n_layers,
                  "seq": TP_TRAIN_SEQ, "size": size,
                  "run_wall_s": run_wall_s, "card": _card_line(torch),
                  "step0_loss": r0["step0_loss"], "whole_loss": whole_loss,
                  "fp32_loss": exact["loss"],
                  "loss_rel_err": abs(r0["step0_loss"] - whole_loss)
                  / abs(whole_loss), "grads": {}, "update": {}}
        _require(abs(r0["step0_loss"] - whole_loss)
                 <= 2.0 ** -10 * abs(whole_loss),
                 f"phase 20: step 0's loss {r0['step0_loss']} on TP={size} "
                 f"vs {whole_loss} on one card")
        for name, p in named:
            ref = exact["grads"][name]
            row = {"tp_vs_one_card": _rel_norm_err(r0["step0_grads"][name],
                                                   p.grad.detach().cpu()),
                   "tp_vs_fp32": _rel_norm_err(r0["step0_grads"][name], ref),
                   "one_card_vs_fp32": _rel_norm_err(p.grad.detach().cpu(),
                                                     ref)}
            report["grads"][name] = row
            _require(ref.norm() > 0 and row["tp_vs_fp32"]
                     <= 2 * row["one_card_vs_fp32"],
                     f"phase 20 {name}: step 0's gradient on TP={size} "
                     f"against fp32 {row}")
        opt.zero_grad(set_to_none=True)
        single_losses = [step(on_dev)["loss"].item() for _ in range(2)]
        after1 = {n: p.detach().cpu().clone() for n, p in named}
        single_losses += [step(on_dev)["loss"].item()
                          for _ in range(TP_TRAIN_STEPS - 2)]
        _require(all(abs(a - b) <= 2.0 ** -10 * abs(b)
                     for a, b in zip(r0["losses"], single_losses, strict=True)),
                 f"phase 20: losses {r0['losses']} on TP={size} vs "
                 f"{single_losses} on one card")
        for name, _ in named:
            tp_upd = r0["after1"][name] - initial[name]
            one_upd = after1[name] - initial[name]
            fp32_upd = exact["after1"][name] - initial[name]
            row = {"tp_vs_one_card": _rel_norm_err(tp_upd, one_upd),
                   "tp_vs_fp32": _rel_norm_err(tp_upd, fp32_upd),
                   "one_card_vs_fp32": _rel_norm_err(one_upd, fp32_upd),
                   "update_of_weights": (one_upd.norm()
                                         / initial[name].norm()).item()}
            report["update"][name] = row
            _require(fp32_upd.norm() > 0 and row["tp_vs_fp32"]
                     <= max(2 * row["one_card_vs_fp32"], 2.0 ** -5),
                     f"phase 20 {name}: the update of steps 0 and 1 on "
                     f"TP={size} against fp32 {row}")
        del opt, step, after1, initial, exact

        # the ranks' checkpoint, re-laid onto one rank, into this model
        ckpt = TrainCheckpointer(ckpt_dir)
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored = ckpt.restore(TP_TRAIN_STEPS,
                                target=dict(named),
                                target_mesh=make_mesh(MeshSpec()))
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t)
        reshard = ckpt.last_reshard
        _require(reshard is not None and reshard["direction"] == "shrink"
                 and reshard["bytes_moved"] == sum(
                     p.numel() * p.element_size() for _, p in named),
                 f"phase 20: last_reshard {reshard}")
        with torch.no_grad():
            for name, p in named:
                p.copy_(restored[name])
            restored_loss = loss_fn(on_dev).item()
        _require(_adapter_digest(named) == r0["adapter_sha256"],
                 "phase 20: the restored adapters differ from the ranks' "
                 "gathered ones")
        _require(abs(restored_loss - r0["saved_loss"])
                 <= 2.0 ** -10 * abs(r0["saved_loss"]),
                 f"phase 20: the restored single-card model's loss "
                 f"{restored_loss} vs TP's {r0['saved_loss']} at the save")
        del model, named, restored
    finally:
        shutil.rmtree(work, ignore_errors=True)
    step_s = statistics.median([x for r in ranks for x in r["step_ms"]]) / 1e3
    coll = [r["collective_ms_median"] for r in ranks]
    report.update({
        "worst_grad_rel_norm_err": {
            k: max(g[k] for g in report["grads"].values())
            for k in ("tp_vs_one_card", "tp_vs_fp32", "one_card_vs_fp32")},
        "worst_update_rel_norm_err": {
            k: max(u[k] for u in report["update"].values())
            for k in ("tp_vs_one_card", "tp_vs_fp32", "one_card_vs_fp32")},
        "losses": r0["losses"], "single_losses": single_losses,
        "step_ms_median": 1e3 * step_s,
        "tokens_per_s": TP_TRAIN_SEQ / step_s,
        "collectives_per_step": dict(step_want),
        "collective_ms_per_step": coll,
        "collective_share_of_step": [c / r["step_ms_median"]
                                     for c, r in zip(coll, ranks)],
        "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
        "save_ms": r0["save_ms"],
        "gather_ms": 1e3 * r0["save"]["gather_s"],
        "sidecar_bytes": r0["save"]["sidecar_bytes"],
        "checkpoint_bytes": r0["save"]["bytes"],
        "restore_ms": restore_ms, "last_reshard": reshard,
        "restored_loss": restored_loss, "saved_loss": r0["saved_loss"],
        "launches": {k: sum(r["launches"][k] for r in ranks)
                     for k in r0["launches"]},
        "ranks": [{k: v for k, v in r.items()
                   if k not in ("step0_grads", "after1", "save")}
                  for r in ranks]})
    _log("tp_train " + json.dumps(report))
    return report


def _timed_calls(torch, mesh, device, kinds):
    """Count and time every call of ``mesh``'s collectives ``kinds``
    (its instance methods wrapped: the model's autograd nodes and the
    engine call them), each between two synchronizes of ``device``.
    Returns ``{kind: [host ms of each call]}``, which the calls fill."""
    calls = {kind: [] for kind in kinds}
    on_card = device.type == "cuda"
    for kind, spent in calls.items():
        fn = getattr(mesh, kind)

        def call(*a, _fn=fn, _spent=spent, **k):
            if on_card:
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = _fn(*a, **k)
            if on_card:
                torch.cuda.synchronize(device)
            _spent.append(1e3 * (time.perf_counter() - t))
            return out

        setattr(mesh, kind, call)
    return calls


def _fsdp_train_collectives(cfg):
    """Phase 21a's collectives a step on each rank (LoRA, the fused
    loss, no ignored labels): every block gathered in the forward and
    again when the backward reaches it (its weights are not kept), the
    head once (kept into the backward), one gather each (one dtype); no
    reduce-scatter (the split base is frozen); one all-reduce of the
    adapters' gradients and one of the loss."""
    return {"all_gather": 2 * cfg.n_layers + 1, "reduce_scatter": 0,
            "all_reduce": 2}


def _resident_bytes(cfg, mesh):
    """The parameter bytes a rank of ``mesh`` stores by
    ``param_sharding``: every leaf whole, over the product of the axes
    that split it."""
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.parallel.sharding import (
        TRANSFORMER_RULES,
        param_sharding,
        split_dims,
    )

    whole = Llama(cfg, device="meta").state_dict()
    specs = param_sharding(whole, TRANSFORMER_RULES, mesh)
    total = 0
    for name, t in whole.items():
        n = 1
        for axes in split_dims(specs[name], mesh.shape).values():
            for a in axes:
                n *= mesh.axis_size(a)
        total += t.numel() * t.element_size() // n
    return total


def fsdp_train_main(cfg, batch, steps, seed, device, started):
    """Every rank of phase 21a: ``make_mesh(MeshSpec(fsdp=size))``, the
    whole LoRA Llama of ``cfg`` drawn from ``seed`` (phase 20's
    weights) and this rank's fsdp blocks kept
    (``Llama.from_params(..., mesh=mesh)``), AdamW on its adapters, the
    fused loss, this rank's rows of ``batch``. One untimed step (its
    averaged adapter gradients kept), then ``steps`` timed steps, the
    flash counters and the collectives recorded from zero, the adapters
    after the first timed step and after the last. Returns every rank's
    report (the tensors in rank 0's)."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
        shard_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    mesh = make_mesh(MeshSpec(fsdp=size))
    dev = _gang_device(torch, mesh, device)
    on_card = dev.type == "cuda"
    t = time.perf_counter()
    whole = _tp_weights(torch, cfg, seed, dev)
    whole_bytes = sum(p.numel() * p.element_size()
                      for p in whole.parameters())
    model = Llama.from_params(cfg, whole.state_dict(), device=dev, mesh=mesh)
    del whole
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    build_s = time.perf_counter() - t
    resident = sum(p.numel() * p.element_size() for p in model.parameters())
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model, loss="fused"), opt,
                           param_mask=mask, device=dev)
    mine = {k: torch.as_tensor(v, device=dev)
            for k, v in shard_batch(batch, mesh).items()}

    def host(tensors):
        return {n: x.detach().cpu().clone() for n, x in tensors}

    calls = _timed_calls(torch, mesh, dev,
                         ("all_gather", "reduce_scatter", "all_reduce"))

    def counted():
        out = {k: len(v) for k, v in calls.items()}
        ms = {k: sum(v) for k, v in calls.items()}
        for v in calls.values():
            v.clear()
        return out, ms

    # the untimed step 0: its loss, its averaged adapter gradients
    initial = host(named)
    step0_loss = step(mine)["loss"].item()
    step0_calls, _ = counted()
    grads = host((n, p.grad) for n, p in named)

    _zero_flash()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times, step_calls, gather_ms = [], [], [], []
    after1 = None
    for i in range(steps):
        if on_card:
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        losses.append(step(mine)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
        n_calls, ms = counted()
        step_calls.append(n_calls)
        gather_ms.append(ms["all_gather"])
        if i == 0:
            after1 = host(named)
    launches = _flash_launches()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    final = host(named)
    step_ms = [1e3 * x for x in times]
    report = {
        "rank": rank, "size": size, "backend": _state.state().backend,
        "device": str(dev), "ready_s": ready_s, "build_s": build_s,
        "resident_bytes": resident,
        "resident_bytes_by_rules": _resident_bytes(cfg, mesh),
        "whole_bytes": whole_bytes,
        "step0_loss": step0_loss, "step0_collectives": step0_calls,
        "step_collectives": step_calls, "losses": losses,
        "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
        "gather_ms": gather_ms,
        "gather_share": [g / s for g, s in zip(gather_ms, step_ms)],
        "launches": launches, "peak_mem_gb": peak / 1e9,
        "adapter_sha256": _adapter_digest(list(final.items())),
        "initial": initial if rank == 0 else None,
        "step0_grads": grads if rank == 0 else None,
        "after1": after1 if rank == 0 else None}
    return hvd.allgather_object(report)


def fsdp_train(torch):
    """Phase 21a: HorovodRunner(np=GANG_NP["21a"]) ranks of
    :func:`fsdp_train_main` sharing the card over gloo; then one process
    holding the whole model of the same depth and weights on the same
    global batch: its losses, step-0 gradients and first update, and
    an fp32 twin's, against the ranks'."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        make_lm_loss_fn,
        make_train_step,
    )

    cfg = _train_cfg(n_layers=FSDP_TRAIN_DEPTH)
    batch = global_batch(np.random.default_rng(SEED + 21), cfg.vocab_size,
                         FSDP_TRAIN_ROWS, FSDP_TRAIN_SEQ)
    t = time.perf_counter()
    ranks = HorovodRunner(np=GANG_NP["21a"]).run(
        fsdp_train_main, cfg=cfg, batch=batch, steps=FSDP_TRAIN_STEPS,
        seed=SEED + 21, device=DEVICE, started=time.time())
    run_wall_s = time.perf_counter() - t
    size = len(ranks)
    _require([r["rank"] for r in ranks] == list(range(size))
             and size == max(-GANG_NP["21a"], 1),
             f"phase 21a: ranks {[r['rank'] for r in ranks]}")
    if GANG_NP["21a"] <= -2 and DEVICE == "cuda":
        _require(all(r["backend"] == "gloo" for r in ranks),
                 f"phase 21a: backends {[r['backend'] for r in ranks]}")
    want = (_fsdp_train_collectives(cfg) if size > 1 else
            {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0})
    r0 = ranks[0]
    for r in ranks:
        _require(r["resident_bytes"] == r["resident_bytes_by_rules"],
                 f"phase 21a rank {r['rank']}: {r['resident_bytes']} "
                 "parameter bytes resident, param_sharding gives "
                 f"{r['resident_bytes_by_rules']}")
        _require(all(c == want for c in r["step_collectives"]
                     + [r["step0_collectives"]]),
                 f"phase 21a rank {r['rank']}: collectives a step "
                 f"{r['step0_collectives']} then {r['step_collectives']}, "
                 f"PERF.md predicts {want}")
        n = cfg.n_layers * FSDP_TRAIN_STEPS
        _require(r["launches"] == dict.fromkeys(r["launches"], n),
                 f"phase 21a rank {r['rank']}: launches {r['launches']}, "
                 f"want {n} of each")
        _require(all(np.isfinite([r["step0_loss"]] + r["losses"])),
                 f"phase 21a rank {r['rank']}: losses {r['losses']}")
        # C7: every rank returns the global batch's loss
        for key in ("adapter_sha256", "losses", "step0_loss"):
            _require(r[key] == r0[key],
                     f"phase 21a: rank {r['rank']}'s {key} differs from "
                     "rank 0's")

    # one process, the whole model of the same weights on the same
    # global batch: its fp32 twin first, then the model itself
    model = _tp_weights(torch, cfg, SEED + 21, torch.device(DEVICE))
    mask = lora_mask(model)
    on_dev = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    exact = _fp32_run(torch, model, mask, on_dev)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    initial = {n: p.detach().cpu().clone() for n, p in named}
    _require(all(torch.equal(initial[n], r0["initial"][n]) for n in initial),
             "phase 21a: the ranks' adapters before step 0 differ from "
             "the whole model's")
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model, loss="fused"), opt,
                           param_mask=mask, device=DEVICE)
    single_losses = [step(on_dev)["loss"].item()]
    one_grads = {n: p.grad.detach().cpu().clone() for n, p in named}
    single_losses.append(step(on_dev)["loss"].item())
    after1 = {n: p.detach().cpu().clone() for n, p in named}
    single_losses += [step(on_dev)["loss"].item()
                      for _ in range(FSDP_TRAIN_STEPS - 1)]
    del opt, step, model, named
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20's tolerances: the losses within 2^-10 relative, at step 0
    # and at every timed step; each averaged step-0 gradient no farther
    # from the fp32 twin's than twice the one process's; the update of
    # steps 0-1 within twice the one process's distance from the fp32
    # update or 2^-5 of its norm, the larger
    ours = [r0["step0_loss"]] + r0["losses"]
    _require(all(abs(a - b) <= 2.0 ** -10 * abs(b)
                 for a, b in zip(ours, single_losses, strict=True)),
             f"phase 21a: losses {ours} on fsdp={size} vs {single_losses} "
             "on one process")
    report = {"np": GANG_NP["21a"], "n_layers": cfg.n_layers,
              "rows": FSDP_TRAIN_ROWS, "seq": FSDP_TRAIN_SEQ, "size": size,
              "run_wall_s": run_wall_s, "card": _card_line(torch),
              "losses": ours, "single_losses": single_losses,
              "loss_rel_err": max(abs(a - b) / abs(b)
                                  for a, b in zip(ours, single_losses)),
              "grads": {}, "update": {}}
    for name in initial:
        ref = exact["grads"][name]
        got = r0["step0_grads"][name]
        row = {"fsdp_vs_one_process": _rel_norm_err(got, one_grads[name]),
               "fsdp_vs_fp32": _rel_norm_err(got, ref),
               "one_process_vs_fp32": _rel_norm_err(one_grads[name], ref)}
        report["grads"][name] = row
        _require(ref.norm() > 0 and row["fsdp_vs_fp32"]
                 <= 2 * row["one_process_vs_fp32"],
                 f"phase 21a {name}: step 0's gradient on fsdp={size} "
                 f"against fp32 {row}")
        ours_upd = r0["after1"][name] - initial[name]
        one_upd = after1[name] - initial[name]
        fp32_upd = exact["after1"][name] - initial[name]
        row = {"fsdp_vs_one_process": _rel_norm_err(ours_upd, one_upd),
               "fsdp_vs_fp32": _rel_norm_err(ours_upd, fp32_upd),
               "one_process_vs_fp32": _rel_norm_err(one_upd, fp32_upd)}
        report["update"][name] = row
        _require(fp32_upd.norm() > 0 and row["fsdp_vs_fp32"]
                 <= max(2 * row["one_process_vs_fp32"], 2.0 ** -5),
                 f"phase 21a {name}: the update of steps 0 and 1 on "
                 f"fsdp={size} against fp32 {row}")
    del exact, initial, after1, one_grads
    step_s = statistics.median([x for r in ranks for x in r["step_ms"]]) / 1e3
    report.update({
        "worst_grad_rel_norm_err": {
            k: max(g[k] for g in report["grads"].values())
            for k in ("fsdp_vs_one_process", "fsdp_vs_fp32",
                      "one_process_vs_fp32")},
        "worst_update_rel_norm_err": {
            k: max(u[k] for u in report["update"].values())
            for k in ("fsdp_vs_one_process", "fsdp_vs_fp32",
                      "one_process_vs_fp32")},
        "step_ms_median": 1e3 * step_s,
        "tokens_per_s": FSDP_TRAIN_ROWS * FSDP_TRAIN_SEQ / step_s,
        "collectives_per_step": want,
        "gather_ms_per_step": [statistics.median(r["gather_ms"])
                               for r in ranks],
        "gather_share_of_step": [statistics.median(r["gather_share"])
                                 for r in ranks],
        "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
        "resident_gb": [r["resident_bytes"] / 1e9 for r in ranks],
        "whole_weights_gb": r0["whole_bytes"] / 1e9,
        "launches": {k: sum(r["launches"][k] for r in ranks)
                     for k in r0["launches"]},
        "ranks": [{k: v for k, v in r.items()
                   if k not in ("step0_grads", "after1", "initial")}
                  for r in ranks]})
    _log("fsdp_train " + json.dumps(report))
    return report


def fsdp_serve_main(cfg, n_requests, budget, device, started):
    """Every rank of phase 21b: ``make_mesh(MeshSpec(fsdp=size))``,
    phase 3's weights at ``cfg``'s depth rebuilt on this rank's card from
    the shared seed (int8), an int8 paged engine (8 slots, pages of 64,
    chunk 16) with ``mesh=``, which keeps this rank's fsdp blocks, and
    the whole model freed; phase 3's first ``n_requests`` requests at
    ``budget`` tokens, counters zeroed just before the run, the
    collectives counted and timed inside it. Returns every rank's
    report."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    mesh = make_mesh(MeshSpec(fsdp=size))
    dev = _gang_device(torch, mesh, device)
    on_card = dev.type == "cuda"
    full = random_quant_llama(torch, cfg, _seeded(torch, SEED, dev), dev)
    engine = ContinuousBatchingEngine(full, full.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, mesh=mesh,
                                      device=dev)
    del full
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    resident = sum(p.numel() * p.element_size()
                   for p in engine._model.parameters())
    prompts, _ = _requests(cfg, n_requests)
    rids = [engine.submit(p, budget) for p in prompts]
    spent = _time_engine(torch, engine)
    calls = _timed_calls(torch, mesh, dev,
                         ("all_gather", "all_reduce", "broadcast"))
    # the gathers' host ms inside the timed decode chunks
    decode_fn, decode_gather_ms = engine._decode_chunk, [0.0]

    def decode_chunk(*a, **k):
        before = sum(calls["all_gather"])
        out = decode_fn(*a, **k)
        decode_gather_ms[0] += sum(calls["all_gather"]) - before
        return out

    engine._decode_chunk = decode_chunk
    if on_card:
        torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    stats = dict(engine.stats)
    forwards = stats["steps"] + stats["prefill_segments"]
    report = {
        "rank": rank, "size": size, "backend": _state.state().backend,
        "device": str(dev), "ready_s": ready_s, "resident_bytes": resident,
        "tokens": [results[r].tolist() for r in rids],
        "finish_reasons": [engine.finish_reasons[r] for r in rids],
        "stats": stats, "launches": launches,
        "collectives": {k: len(v) for k, v in calls.items()},
        "gather_ms": sum(calls["all_gather"]),
        "collective_ms": sum(sum(v) for v in calls.values()),
        "wall_s": wall, "forwards": forwards,
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "prefill_ms_mean": 1e3 * statistics.mean(spent["prefill"]),
        "gather_ms_per_forward": sum(calls["all_gather"]) / forwards,
        "gather_share_of_decode": decode_gather_ms[0]
        / (1e3 * spent["decode"])}
    return hvd.allgather_object(report)


def fsdp_serve(torch):
    """Phase 21b: HorovodRunner(np=GANG_NP["21b"]) ranks of
    :func:`fsdp_serve_main`, two on the one card (gloo); then a
    single-rank engine in this process on the same weights (phase 3's,
    rebuilt from the seed at the same depth) and requests: the ranks'
    tokens must be identical to each other and to its own (the gathered
    weights are the whole ones bit for bit, and the kernels see the
    same shapes)."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.models.llama import LlamaConfig
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    cfg = LlamaConfig.llama3_8b(max_cache_len=2048, quant="int8",
                                n_layers=FSDP_SERVE_DEPTH)
    t = time.perf_counter()
    ranks = HorovodRunner(np=GANG_NP["21b"]).run(
        fsdp_serve_main, cfg=cfg, n_requests=FSDP_SERVE_REQUESTS,
        budget=FSDP_SERVE_BUDGET, device=DEVICE, started=time.time())
    run_wall_s = time.perf_counter() - t
    size = len(ranks)
    _require([r["rank"] for r in ranks] == list(range(size))
             and size == max(-GANG_NP["21b"], 1),
             f"phase 21b: ranks {[r['rank'] for r in ranks]}")
    r0 = ranks[0]
    for r in ranks:
        stats, forwards = r["stats"], r["forwards"]
        want = {"paged_attention_decode": cfg.n_layers * stats["steps"],
                "quantized_matmul": (7 * cfg.n_layers + 1) * forwards,
                "quantized_matmul_int4": 0}
        _require(r["launches"] == want,
                 f"phase 21b rank {r['rank']}: launches {r['launches']}, "
                 f"the engine's counts predict {want}")
        # a forward: one gather a block and one of the head (int8, one
        # dtype each), and the sampled tokens broadcast over fsdp
        fsdp = size > 1
        want = {"all_gather": (cfg.n_layers + 1) * forwards * fsdp,
                "all_reduce": 0, "broadcast": forwards * fsdp}
        _require(r["collectives"] == want,
                 f"phase 21b rank {r['rank']}: collectives "
                 f"{r['collectives']}, want {want}")
        for key in ("tokens", "finish_reasons", "stats"):
            _require(r[key] == r0[key],
                     f"phase 21b: rank {r['rank']}'s {key} differ from "
                     "rank 0's")
    model = random_quant_llama(torch, cfg, _seeded(torch, SEED))
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, device=DEVICE)
    prompts, _ = _requests(cfg, FSDP_SERVE_REQUESTS)
    rids = [engine.submit(p, FSDP_SERVE_BUDGET) for p in prompts]
    spent = _time_engine(torch, engine)
    results = engine.run()
    single = [results[r].tolist() for r in rids]
    single_decode_ms = 1e3 * spent["decode"] / engine.stats["steps"]
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    for i, (toks, reason) in enumerate(zip(r0["tokens"],
                                           r0["finish_reasons"])):
        _require(len(toks) == FSDP_SERVE_BUDGET and reason == "length"
                 and all(0 <= t < cfg.vocab_size for t in toks),
                 f"phase 21b request {i}: {len(toks)} tokens on {reason}")
    _require(r0["tokens"] == single,
             f"phase 21b: the fsdp={size} engine's tokens differ from a "
             f"single-rank engine's: {_agreement(r0['tokens'], single)}")
    report = {k: v for k, v in r0.items()
              if k not in ("tokens", "finish_reasons")}
    report.update({
        "np": GANG_NP["21b"], "n_layers": cfg.n_layers,
        "requests": FSDP_SERVE_REQUESTS, "budget": FSDP_SERVE_BUDGET,
        "run_wall_s": run_wall_s, "card": _card_line(torch),
        "single_rank_decode_ms_per_step": single_decode_ms,
        "gather_share_of_decode_step": [r["gather_share_of_decode"]
                                        for r in ranks],
        "ranks": [{k: r[k] for k in (
            "rank", "backend", "device", "resident_bytes",
            "decode_ms_per_step", "prefill_ms_mean", "gather_ms_per_forward",
            "launches", "collectives")} for r in ranks]})
    _log("fsdp_serve " + json.dumps(report))
    return report


@contextlib.contextmanager
def _no_name_lookups():
    """Phase 22 on a machine without a network: the routable address of
    this one host is loopback, and a ``.invalid`` host is remote, so no
    name is resolved (a lookup would ask a name server)."""
    from sparkdl_tpu_torch.horovod import control_plane, topology

    routable, is_local = control_plane.routable_host_ip, \
        topology.is_local_host
    control_plane.routable_host_ip = lambda: "127.0.0.1"
    topology.is_local_host = lambda host: (not host.endswith(".invalid")
                                           and is_local(host))
    topology._addressable.cache_clear()
    try:
        yield
    finally:
        control_plane.routable_host_ip = routable
        topology.is_local_host = is_local
        topology._addressable.cache_clear()


@contextlib.contextmanager
def _attrs(obj, **settings):
    """``obj``'s attributes set for the block, put back after."""
    saved = {k: getattr(obj, k) for k in settings}
    for k, v in settings.items():
        setattr(obj, k, v)
    try:
        yield obj
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


@contextlib.contextmanager
def _launcher_settings(**settings):
    """The launcher's module settings for the length of the block, the
    ranks' device the card's (or the CPU in a rehearsal)."""
    from sparkdl_tpu_torch.horovod import launcher

    settings.setdefault("WORKER_DEVICE", None if DEVICE == "cuda" else "cpu")
    with _attrs(launcher, **settings):
        yield launcher


@contextlib.contextmanager
def _minispark(slots):
    """The repo's pyspark double as ``pyspark`` with a session of
    ``slots`` active; it counts its barrier jobs (``.jobs``). Afterwards
    the session, the double's modules, the port's Spark backend and the
    executors' path are gone."""
    root = os.path.dirname(os.path.abspath(__file__))
    shim = os.path.join(root, "tests", "minispark", "shim")
    _require(os.path.isdir(shim), f"phase 22: no pyspark double at {shim}")
    path = os.environ.get("PYTHONPATH")
    # the executors import the port from this checkout
    os.environ["PYTHONPATH"] = root if not path else root + os.pathsep + path
    sys.path.insert(0, shim)
    try:
        import pyspark
        from pyspark.sql import SparkSession

        collect = pyspark._BarrierJob.collect
        session = SparkSession._activate(n_slots=slots)
        session.jobs = 0

        def counted(job):
            session.jobs += 1
            return collect(job)

        pyspark._BarrierJob.collect = counted
        yield session
    finally:
        sys.path.remove(shim)
        if path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = path
        for mod in list(sys.modules):
            if (mod == "pyspark" or mod.startswith("pyspark.")
                    or mod == "sparkdl_tpu_torch.horovod.spark_backend"):
                del sys.modules[mod]


def _noop_main():
    return None


def spark_gang(torch, gang):
    """Phases 22a and 22b: 9a's configuration as a barrier job of the
    one-slot session, then np beyond its slots."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.parallel.train import global_batch

    cfg = _train_cfg()
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    np_arg = GANG_NP["22a"]
    with _no_name_lookups(), _launcher_settings() as launcher, \
            _minispark(np_arg) as session:
        ranks, wall_s, seen = _gang_run(
            np_arg, cfg, batch, steps=GANG_STEPS, warmup=1, seed=SEED,
            adapters=False)
        _require(session.jobs == 1,
                 f"phase 22a ran {session.jobs} barrier jobs, want 1")
        try:
            HorovodRunner(np=np_arg + 1).run(_noop_main)
            refused = None
        except launcher.SlotExhaustionError as e:
            refused = str(e)
        _require(refused is not None and session.jobs == 1,
                 f"phase 22b: np={np_arg + 1} on {np_arg} slot(s) gave "
                 f"{refused!r} after {session.jobs} barrier job(s)")
    _check_gang_ranks(torch, ranks, cfg, GANG_STEPS, seen, "22a")
    r0 = ranks[0]
    _require(len(ranks) == np_arg and r0["rank"] == 0,
             f"phase 22a: rank 0's result did not reach the driver: {ranks}")
    if DEVICE == "cuda":
        _require(r0["backend"] == "cpu:gloo,cuda:nccl"
                 and r0["device"] == "cuda:0",
                 f"phase 22a: {r0['backend']} on {r0['device']}, want NCCL "
                 "on cuda:0")
    # phase 6's tolerance: each loss within 2^-10 relative of 9a's
    got, want = r0["losses"], gang["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    _require(len(got) == len(want) and max(rel) <= 2.0 ** -10,
             f"phase 22a losses {got} vs 9a's {want}")
    report = {k: v for k, v in r0.items() if k not in ("battery",
                                                       "adapters")}
    report.update({
        "np": np_arg, "n_layers": cfg.n_layers, "run_wall_s": wall_s,
        "bypasses": "real Spark's scheduler (the minispark double)",
        "losses_bit_identical_to_9a": got == want,
        "loss_rel_err_vs_9a": max(rel),
        "phase9a_step_ms_median": gang["step_ms_median"],
        "phase9a_ready_s": gang["ready_s"],
        "phase9a_run_wall_s": gang["run_wall_s"],
        "step_ms_over_9a": r0["step_ms_median"] / gang["step_ms_median"],
        "refused_22b": refused})
    _log("spark " + json.dumps(report))
    return report


def _flash_fwd_check(torch, fa, q, k, v, o, lse, causal):
    """Phase 2b's forward tolerance for the kernel's (o, lse) on q, k, v:
    ({"o": max abs err, "lse": ...}, whether every element is within it
    and finite)."""
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    weighted = fa.flash_attention_reference(q.float(), k.float(),
                                            v.float().abs(), causal)[0]
    ro = ro.float()
    err_o = (o.float() - ro).abs()
    err_lse = (lse - rlse.float()).abs()
    tol_o = 2.0 ** -7 * weighted + _bf16_ulp(torch, ro) + 1e-6
    ok = (bool((err_o <= tol_o).all()) and bool((err_lse <= 1e-4).all())
          and bool(torch.isfinite(o).all()))
    return {"o": err_o.max().item(), "lse": err_lse.max().item()}, ok


def slot_main(shape, seed, device):
    """The rank of phases 22c and 22d: one ``hvd.allreduce_`` of a
    tensor on its device, and one flash forward against its plain
    version at ``shape``."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod.control_plane import CONTROL_SECRET_ENV
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.ops import flash_attention as fa

    hvd.init()
    st = _state.state()
    dev = st.device if device == "cuda" else torch.device(device)
    x = torch.arange(4, dtype=torch.float32, device=dev) + hvd.rank()
    hvd.allreduce_(x, op=hvd.Sum)
    b, s, h, d, causal = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    _zero_flash()
    o, lse = fa.flash_fwd(q, k, v, causal)
    launches = _flash_launches()
    errs, ok = _flash_fwd_check(torch, fa, q, k, v, o, lse, causal)
    with open("/proc/self/environ", "rb") as f:
        started_with = f.read()  # the environment the rank started with
    return {"size": hvd.size(), "backend": st.backend, "device": str(dev),
            "allreduce": x.tolist(), "allreduce_on": x.device.type,
            "launches": launches, "max_abs_err": errs, "within_tol": ok,
            "secret_at_exec": CONTROL_SECRET_ENV.encode() in started_with}


def _check_slot_rank(r, phase):
    _require(r["size"] == 1 and r["allreduce"] == [0.0, 1.0, 2.0, 3.0]
             and r["allreduce_on"] == DEVICE,
             f"phase {phase}: allreduce gave {r['allreduce']} on "
             f"{r['allreduce_on']} in a gang of {r['size']}")
    _require(r["within_tol"] and r["launches"]["flash_fwd"] == 1,
             f"phase {phase}: flash forward {r['max_abs_err']}, launches "
             f"{r['launches']}")
    if DEVICE == "cuda":
        _require(r["backend"] == "cpu:gloo,cuda:nccl",
                 f"phase {phase}: backend {r['backend']}, want NCCL")


def slot_wait(torch):
    """Phase 22c: a local HorovodRunner(np=1) waits for the card slots
    that this process holds, and runs when a timer releases them."""
    from sparkdl_tpu_torch import HorovodRunner

    with _launcher_settings() as launcher:
        total = launcher.available_slots()
        _require(total >= 1, f"phase 22c: {total} slots on this host")
        held = launcher.claim_slots(total, total, timeout=1)
        claim, waits = launcher.claim_slots, []

        def timed_claim(n, total, timeout=None):
            t = time.perf_counter()
            c = claim(n, total, timeout)
            waits.append(time.perf_counter() - t)
            return c

        launcher.claim_slots = timed_claim
        timer = threading.Timer(SLOT_HOLD_S, held.release)
        t = time.perf_counter()
        timer.start()
        try:
            r = HorovodRunner(np=1).run(slot_main, shape=SLOT_FLASH_SHAPE,
                                        seed=SEED, device=DEVICE)
        finally:
            timer.cancel()
            held.release()
            launcher.claim_slots = claim
        wall_s = time.perf_counter() - t
    _require(len(waits) == 1 and waits[0] >= SLOT_HOLD_S,
             f"phase 22c: the slot claim waited {waits} s, want >= "
             f"{SLOT_HOLD_S}")
    _check_slot_rank(r, "22c")
    report = dict(r, slots=total, hold_s=SLOT_HOLD_S, claim_wait_s=waits[0],
                  run_wall_s=wall_s)
    _log("slot_wait " + json.dumps(report))
    return report


def remote_rank(torch):
    """Phase 22d: one rank on ``fakeremote.invalid`` through a fake remote
    shell, which records its argv, drops the host and runs the rest
    here."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.horovod import control_plane

    work = tempfile.mkdtemp(prefix="chip-smoke-22d-")
    argv_log = os.path.join(work, "argv.log")
    shell = os.path.join(work, "fakessh")
    with open(shell, "w") as f:
        f.write("#!/bin/sh\n"
                f"printf '%s\\n' \"$*\" >> {argv_log}\n"
                "shift\n"
                "exec sh -c \"$*\"\n")
    os.chmod(shell, 0o755)
    token_hex, secrets = control_plane._secrets.token_hex, []

    def recorded(n):
        secrets.append(token_hex(n))
        return secrets[-1]

    control_plane._secrets.token_hex = recorded
    try:
        with _no_name_lookups(), _launcher_settings(
                HOSTS=[("fakeremote.invalid", 1)], REMOTE_SHELL=shell,
                REMOTE_PYTHON=sys.executable):
            t = time.perf_counter()
            r = HorovodRunner(np=1).run(slot_main, shape=SLOT_FLASH_SHAPE,
                                        seed=SEED, device=DEVICE)
            wall_s = time.perf_counter() - t
    finally:
        control_plane._secrets.token_hex = token_hex
    with open(argv_log) as f:
        argv = f.read().splitlines()
    _require(len(argv) == 1 and argv[0].startswith("fakeremote.invalid "),
             f"phase 22d: the shell was called as {argv}")
    _require(len(secrets) == 1 and secrets[0] not in argv[0]
             and "SECRET" not in argv[0],
             "phase 22d: the control plane's secret is on the command line")
    _require("payload" not in argv[0] and len(argv[0]) < 1000,
             f"phase 22d: the payload is on the command line: {argv[0]}")
    _require(not r["secret_at_exec"],
             "phase 22d: the rank was started with the secret in its "
             "environment")
    _check_slot_rank(r, "22d")
    report = dict(r, argv=argv[0], argv_bytes=len(argv[0]),
                  run_wall_s=wall_s)
    _log("remote_rank " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# Phase 23: the model zoo (BASELINE.json configs 1-3) through HorovodRunner,
# and the HF Llama conversion into the int8 serving path


def _zoo_model(torch, family, device, gen=None, dtype=None):
    """Phase 23's model of ``family`` (``"mnist"``, ``"resnet50"``,
    ``"bert"``) at full width on ``device``, its weights drawn from
    ``gen`` (flax's initialisers); ``dtype`` overrides the compute type
    (the fp32 twin)."""
    from sparkdl_tpu_torch.models import (
        BertConfig,
        BertForQuestionAnswering,
        MnistCNN,
        ResNet50,
    )

    kw = {} if dtype is None else {"dtype": dtype}
    if family == "mnist":
        return MnistCNN(device=device, generator=gen, **kw)
    if family == "resnet50":
        return ResNet50(device=device, generator=gen, **kw)
    return BertForQuestionAnswering(BertConfig.base(**kw), device=device,
                                    generator=gen)


def _zoo_batch(torch, family, device):
    """Phase 23's global batch of ``family``, drawn on ``device`` from
    the seed (every rank and the in-process twin draw the same): MNIST
    64 x 28 x 28 x 1 images and 10 classes; ResNet-50 128 x 224 x 224 x
    3 NHWC images and 1000 classes; BERT SQuAD 32 x 384 tokens with
    padding masks of lengths 128-384, a 64-token question (type 0)
    before the context (type 1), start <= end inside each length."""
    gen = _seeded(torch, SEED + 23, device)
    if family in ("mnist", "resnet50"):
        b, hw, c, classes = ((MNIST_BATCH, 28, 1, 10) if family == "mnist"
                             else (RESNET_BATCH, RESNET_IMAGE, 3, 1000))
        return {"x": torch.randn((b, hw, hw, c), generator=gen,
                                 device=device),
                "y": torch.randint(0, classes, (b,), generator=gen,
                                   device=device)}
    from sparkdl_tpu_torch.models import BertConfig

    b, s = BERT_BATCH, BERT_SEQ
    lengths = torch.randint(BERT_MIN_LEN, s + 1, (b,), generator=gen,
                            device=device)
    pos = torch.arange(s, device=device)
    mask = pos[None, :] < lengths[:, None]
    starts = (torch.rand((b,), generator=gen, device=device)
              * lengths).long()
    ends = starts + (torch.rand((b,), generator=gen, device=device)
                     * (lengths - starts)).long()
    return {"ids": torch.randint(0, BertConfig.base().vocab_size, (b, s),
                                 generator=gen, device=device),
            "types": ((pos[None, :] >= 64) & mask).long(),
            "mask": mask, "starts": starts, "ends": ends}


def _zoo_logits(model, family, batch):
    if family == "bert":
        return model(batch["ids"], batch["types"], batch["mask"])
    return model(batch["x"])


def _zoo_loss_fn(family, model):
    """Cross entropy (MNIST, ResNet-50) or SQuAD's start CE + end CE."""
    from sparkdl_tpu_torch.parallel.train import cross_entropy_loss

    def loss_fn(batch):
        out = _zoo_logits(model, family, batch)
        if family == "bert":
            return (cross_entropy_loss(out[0], batch["starts"])
                    + cross_entropy_loss(out[1], batch["ends"]))
        return cross_entropy_loss(out, batch["y"])

    loss_fn.model = model
    return loss_fn


def _zoo_optimizer(torch, family, model):
    """MNIST: Adam 1e-3; ResNet-50: SGD 0.1, momentum 0.9
    (benchmarks/model_bench.py's recipe); BERT: AdamW 3e-5 with optax's
    default weight decay 1e-4 set explicitly (torch's default is 1e-2)."""
    params = model.parameters()
    if family == "mnist":
        return torch.optim.Adam(params, lr=1e-3)
    if family == "resnet50":
        return torch.optim.SGD(params, lr=0.1, momentum=0.9)
    return torch.optim.AdamW(params, lr=3e-5, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def zoo_main(family, steps, warmup, seed, device, started, gang=True):
    """One training run of phase 23a-23c: ``family``'s model drawn from
    ``seed`` on this rank's card, rank 0's weights and running
    statistics (``replicate``), its optimizer wrapped in
    ``hvd.DistributedOptimizer``, this rank's rows of the seed's global
    batch (``shard_batch``); ``warmup`` steps, then ``steps`` timed ones.
    With ``gang=False`` the same run in this process with the plain
    optimizer (the in-process twin), which also returns the model.
    Returns every rank's report (``allgather_object``)."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.horovod import log_to_driver
    from sparkdl_tpu_torch.parallel.train import (
        make_train_step,
        param_count,
        replicate,
        shard_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, size, backend = 0, 1, None
    if gang:
        hvd.init()
        rank, size = hvd.rank(), hvd.size()
        st = _state.state()
        backend = st.backend
        if device == "cuda" and st.device is not None:
            device = st.device  # a gang rank's card; local mode: the current
    ready_s = time.time() - started
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    model = _zoo_model(torch, family, device,
                       _seeded(torch, seed + rank, device)).train()
    opt = _zoo_optimizer(torch, family, model)
    batch = _zoo_batch(torch, family, device)
    if gang:
        replicate(model)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        hvd.broadcast_optimizer_state(opt)
        batch = shard_batch(batch)
    step = make_train_step(_zoo_loss_fn(family, model), opt, device=device)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    losses = [step(batch)["loss"].item() for _ in range(warmup)]
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(steps):
        sync()
        t = time.perf_counter()
        losses.append(step(batch)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
    rows = next(iter(batch.values())).shape[0]
    report = {
        "family": family, "rank": rank, "size": size, "backend": backend,
        "device": str(device), "ready_s": ready_s, "rows": int(rows),
        "params": param_count(model), "losses": losses,
        "step_ms": [1e3 * x for x in times],
        "step_ms_median": 1e3 * statistics.median(times),
        "samples_per_s": steps * rows / sum(times),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else 0.0),
        "buffers": len(stats0),
        "buffers_moved": sum(not torch.equal(b, stats0[n])
                             for n, b in model.named_buffers())}
    if not gang:
        return report, model, step, batch
    log_to_driver(f"zoo {family} rank {rank} of {size}: loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"{report['step_ms_median']:.1f} ms a step")
    return hvd.allgather_object(report)


def _zoo_flops_per_sample(family):
    """Model FLOPs a trained sample, as benchmarks/model_bench.py counts
    them: ResNet-50 3 x 4.09 GFLOP; BERT-base 3 x (2 x 85.1M matmul
    parameters + 12 x 4 x seq x d_model) a token, x seq."""
    if family == "resnet50":
        return 3 * 4.09e9
    if family == "bert":
        return 3 * (2 * 85.1e6 + 12 * 4 * BERT_SEQ * 768) * BERT_SEQ
    return None


def _zoo_bf16_err(torch, family, model, batch):
    """The bf16 model's logits on the batch's first 4 samples against an
    fp32 twin of the same weights (eval mode: the running statistics),
    as the largest error over the largest fp32 logit."""
    few = {k: v[:4] for k, v in batch.items()}
    twin = _zoo_model(torch, family, next(model.parameters()).device,
                      dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    model.eval()
    twin.eval()
    with torch.no_grad():
        got, ref = _zoo_logits(model, family, few), _zoo_logits(
            twin, family, few)
    if family != "bert":
        got, ref = (got,), (ref,)
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.abs().max().item() for r in ref)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return {"max_abs_err": err, "logit_scale": scale,
            "rel_err": err / scale, "finite": finite}


def zoo(torch, phase, family):
    """Phase 23a-23c: ``family`` trained under ``HorovodRunner(np=
    ZOO_NP[phase])`` with ``hvd.DistributedOptimizer``; 23b and 23c also
    against the same steps in this process (the losses within 2^-10),
    the running statistics moved (ResNet-50), the bf16 logits of 4
    samples against an fp32 twin within ZOO_BF16_TOL, and one more step
    of the in-process run profiled."""
    from sparkdl_tpu_torch import HorovodRunner

    steps, warmup = ((MNIST_STEPS, 1) if family == "mnist"
                     else (ZOO_STEPS, ZOO_WARMUP))
    with _launcher_settings(), _StdoutCopy() as out:
        t = time.perf_counter()
        ranks = HorovodRunner(np=ZOO_NP[phase]).run(
            zoo_main, family=family, steps=steps, warmup=warmup, seed=SEED,
            device=DEVICE, started=time.time())
        wall_s = time.perf_counter() - t
    r0 = ranks[0]
    _require(len(ranks) == max(ZOO_NP[phase], 1) and r0["rank"] == 0,
             f"phase {phase}: rank 0's result did not reach the driver")
    _require(f"zoo {family} rank 0 of " in out.seen(),
             f"phase {phase}: no log_to_driver line on the driver's stdout")
    losses = r0["losses"]
    _require(all(np.isfinite(losses)), f"phase {phase}: losses {losses}")
    report = dict(r0)
    report.update({"phase": phase, "np": ZOO_NP[phase], "warmup": warmup,
                   "steps": steps, "run_wall_s": wall_s})
    flops = _zoo_flops_per_sample(family)
    if flops is not None:
        report["model_tflops_per_s"] = flops * r0["samples_per_s"] / 1e12
        report["share_of_989_tflops"] = (flops * r0["samples_per_s"]
                                         / PEAK_FLOPS["bf16"])
    if family == "mnist":
        _require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                 f"phase {phase}: the loss did not fall: {losses}")
        _log(f"zoo_{phase} " + json.dumps(report))
        return report

    twin, model, step, batch = zoo_main(family, steps, warmup, SEED, DEVICE,
                                        time.time(), gang=False)
    diff = max(abs(a - b) for a, b in zip(losses, twin["losses"]))
    report["twin_losses"] = twin["losses"]
    report["twin_step_ms_median"] = twin["step_ms_median"]
    report["twin_max_loss_diff"] = diff
    _require(diff <= 2.0 ** -10,
             f"phase {phase}: the gang's losses {losses} are not within "
             f"2^-10 of the in-process run's {twin['losses']}")
    if family == "resnet50":
        _require(r0["buffers"] == 2 * 53 and r0["buffers_moved"]
                 == r0["buffers"],
                 f"phase {phase}: {r0['buffers_moved']} of "
                 f"{r0['buffers']} running statistics moved")
    report["profile"] = profile_step(torch, step, batch,
                                     twin["step_ms_median"])
    bf16 = _zoo_bf16_err(torch, family, model, batch)
    report["bf16_vs_fp32"] = bf16
    _require(bf16["finite"] and bf16["rel_err"] <= ZOO_BF16_TOL,
             f"phase {phase}: bf16 logits against the fp32 twin: {bf16}")
    del model, step, batch
    _log(f"zoo_{phase} " + json.dumps({k: v for k, v in report.items()
                                       if k != "profile"}))
    return report


def bert_mesh_main(steps, seed, device, started):
    """Every rank of phase 27a: for ``MeshSpec(model=size)`` and then
    ``MeshSpec(fsdp=size)``, phase 23c's BERT-base SQuAD drawn whole
    from ``seed`` on this rank's card and this rank's slice kept
    (``BertForQuestionAnswering.from_params(..., mesh=)``), AdamW 3e-5
    over every weight, this rank's rows of phase 23c's batch; ``steps``
    steps of the mesh-aware ``make_train_step``, each timed, with every
    collective of the mesh counted and timed between synchronizes.
    Returns every rank's reports."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.models import BertConfig, BertForQuestionAnswering
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from sparkdl_tpu_torch.parallel.train import make_train_step, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    ready_s = time.time() - started
    rank, size = hvd.rank(), hvd.size()
    out = {"rank": rank, "backend": _state.state().backend,
           "ready_s": ready_s, "meshes": {}}
    for name, spec in (("model", MeshSpec(model=size)),
                       ("fsdp", MeshSpec(fsdp=size))):
        mesh = make_mesh(spec)
        dev = _gang_device(torch, mesh, device)
        on_card = dev.type == "cuda"
        t = time.perf_counter()
        whole = _zoo_model(torch, "bert", dev, _seeded(torch, seed, dev))
        model = BertForQuestionAnswering.from_params(
            BertConfig.base(), whole.state_dict(), dev, mesh=mesh).train()
        del whole
        build_s = time.perf_counter() - t
        opt = _zoo_optimizer(torch, "bert", model)
        step = make_train_step(_zoo_loss_fn("bert", model), opt, device=dev)
        mine = shard_batch(_zoo_batch(torch, "bert", dev), mesh)
        kinds = ("all_reduce", "all_gather", "reduce_scatter")
        calls = _timed_calls(torch, mesh, dev, kinds)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        losses, times, counts, coll_ms = [], [], [], []
        for _ in range(steps):
            for v in calls.values():
                v.clear()
            if on_card:
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            losses.append(step(mine)["loss"].item())  # waits for the step
            times.append(time.perf_counter() - t)
            counts.append({k: len(v) for k, v in calls.items()})
            coll_ms.append(sum(sum(v) for v in calls.values()))
        # the first step: allocations and the optimizer's state
        warm = times[1:] or times
        warm_coll = coll_ms[1:] or coll_ms
        out["meshes"][name] = {
            "axes": dict(mesh.shape), "build_s": build_s,
            "rows": int(next(iter(mine.values())).shape[0]),
            "heads_local": model.bert.layers[0].attn.n_heads,
            "zero3_units": (None if model.zero3 is None
                            else len(model.zero3.units)),
            "losses": losses, "step_ms": [1e3 * x for x in times],
            "step_ms_median": 1e3 * statistics.median(warm),
            "collectives_per_step": counts,
            "collective_ms": coll_ms,
            "collective_ms_median": statistics.median(warm_coll),
            "collective_share_of_step": (statistics.median(warm_coll)
                                         / (1e3 * statistics.median(warm))),
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if on_card else 0.0)}
        del model, opt, step, mine
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return hvd.allgather_object(out)


def bert_mesh(torch, phase23c):
    """Phase 27a: phase 23c's BERT-base SQuAD under
    ``HorovodRunner(np=GANG_NP["27a"])``, two ranks sharing the card
    over gloo (:func:`bert_mesh_main`), tensor-parallel and then ZeRO-3;
    then the same ``BERT_MESH_STEPS`` steps in this process (the whole
    model, the whole batch, the plain optimizer, ``make_train_step``,
    phase 20's one-card comparison): each mesh's losses within 2^-10
    relative of these, every rank's alike."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.models import BertConfig
    from sparkdl_tpu_torch.parallel.train import make_train_step

    with _launcher_settings():
        t = time.perf_counter()
        ranks = HorovodRunner(np=GANG_NP["27a"]).run(
            bert_mesh_main, steps=BERT_MESH_STEPS, seed=SEED, device=DEVICE,
            started=time.time())
        wall_s = time.perf_counter() - t
    size = len(ranks)
    _require([r["rank"] for r in ranks] == list(range(size))
             and size == max(-GANG_NP["27a"], 1),
             f"phase 27a: ranks {[r['rank'] for r in ranks]}")
    if GANG_NP["27a"] <= -2 and DEVICE == "cuda":
        _require(all(r["backend"] == "gloo" for r in ranks),
                 f"phase 27a: backends {[r['backend'] for r in ranks]}")
    dev = torch.device(DEVICE)
    model = _zoo_model(torch, "bert", dev, _seeded(torch, SEED, dev)).train()
    step = make_train_step(_zoo_loss_fn("bert", model),
                           _zoo_optimizer(torch, "bert", model), device=dev)
    batch = _zoo_batch(torch, "bert", dev)
    single = [step(batch)["loss"].item() for _ in range(BERT_MESH_STEPS)]
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    base = BertConfig.base()
    report = {"np": GANG_NP["27a"], "steps": BERT_MESH_STEPS,
              "batch": [BERT_BATCH, BERT_SEQ], "run_wall_s": wall_s,
              "single_losses": single,
              "phase23c_step_ms_median": phase23c["step_ms_median"],
              "card": _card_line(torch), "meshes": {}}
    for name in ("model", "fsdp"):
        rows = [r["meshes"][name] for r in ranks]
        r0 = rows[0]
        for r in rows:
            _require(r["losses"] == r0["losses"],
                     f"phase 27a {name}={size}: the ranks' losses differ "
                     f"{[x['losses'] for x in rows]}")
        _require(all(np.isfinite(r0["losses"])) and all(
            abs(a - b) <= 2.0 ** -10 * abs(b)
            for a, b in zip(r0["losses"], single, strict=True)),
                 f"phase 27a {name}={size}: losses {r0['losses']} vs "
                 f"{single} in one process")
        if name == "model":
            _require(all(r["heads_local"] * size == base.n_heads
                         for r in rows),
                     f"phase 27a: heads a rank "
                     f"{[r['heads_local'] for r in rows]}")
        else:
            _require(all(r["zero3_units"] == base.n_layers for r in rows)
                     and all(r["rows"] * size == BERT_BATCH for r in rows),
                     f"phase 27a fsdp: units "
                     f"{[r['zero3_units'] for r in rows]}, rows "
                     f"{[r['rows'] for r in rows]}")
        report["meshes"][name] = {
            **{k: r0[k] for k in ("axes", "rows", "losses",
                                  "collectives_per_step")},
            "build_s": [r["build_s"] for r in rows],
            "step_ms_median": [r["step_ms_median"] for r in rows],
            "collective_ms_median": [r["collective_ms_median"]
                                     for r in rows],
            "collective_share_of_step": [r["collective_share_of_step"]
                                         for r in rows],
            "peak_mem_gb": [r["peak_mem_gb"] for r in rows],
            "samples_per_s": BERT_BATCH / (1e-3 * statistics.median(
                [r["step_ms_median"] for r in rows])),
            "max_loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
                r0["losses"], single))}
    report["ready_s"] = [r["ready_s"] for r in ranks]
    _log("bert_mesh " + json.dumps(report))
    return report


def _hf_llama_state_dict(torch, hf, gen):
    """An HF ``LlamaForCausalLM`` state dict at ``hf``'s widths on the
    card in bf16, drawn from ``gen``: every matrix normal(0.02), the norm
    weights 1 + normal(0.02), ``lm_head.weight`` its own."""
    d, f = hf.hidden_size, hf.intermediate_size
    kv = hf.num_key_value_heads * (d // hf.num_attention_heads)

    def normal(*shape, mean=0.0):
        t = torch.empty(shape, dtype=torch.bfloat16, device=DEVICE)
        return t.normal_(mean, 0.02, generator=gen)

    sd = {"model.embed_tokens.weight": normal(hf.vocab_size, d)}
    for i in range(hf.num_hidden_layers):
        p = f"model.layers.{i}"
        sd.update({f"{p}.self_attn.q_proj.weight": normal(d, d),
                   f"{p}.self_attn.k_proj.weight": normal(kv, d),
                   f"{p}.self_attn.v_proj.weight": normal(kv, d),
                   f"{p}.self_attn.o_proj.weight": normal(d, d),
                   f"{p}.mlp.gate_proj.weight": normal(f, d),
                   f"{p}.mlp.up_proj.weight": normal(f, d),
                   f"{p}.mlp.down_proj.weight": normal(d, f),
                   f"{p}.input_layernorm.weight": normal(d, mean=1.0),
                   f"{p}.post_attention_layernorm.weight":
                       normal(d, mean=1.0)})
    sd["model.norm.weight"] = normal(d, mean=1.0)
    sd["lm_head.weight"] = normal(hf.vocab_size, d)
    return sd


def hf_convert(torch):
    """Phase 23d: an HF Llama state dict at Llama-3-8B's widths (bf16, on
    the card) through ``params_from_hf``, the port's ``Llama`` and
    ``params_to_hf`` (bit-identical to the input), then
    ``quantize_llama_params`` to int8 and phase 3's first HF_REQUESTS
    requests through the paged engine, counters zeroed just before the
    run."""
    import types

    from sparkdl_tpu_torch.models.convert import (
        config_from_hf,
        params_from_hf,
        params_to_hf,
    )
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.quant import quantize_llama_params
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    hf = types.SimpleNamespace(**HF_LLAMA3_8B)
    cfg = config_from_hf(hf, max_cache_len=2048)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sd = _hf_llama_state_dict(torch, hf, _seeded(torch, SEED + 23))
    hf_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = params_from_hf(sd, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    from_s = time.perf_counter() - t
    t = time.perf_counter()
    model = Llama.from_params(cfg, params, device=DEVICE)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    back = params_to_hf(model.state_dict(), cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    to_s = time.perf_counter() - t
    _require(set(back) == set(sd),
             f"phase 23d: params_to_hf gave {sorted(set(back) ^ set(sd))}")
    differ = [k for k in sd if back[k].dtype != sd[k].dtype
              or not torch.equal(back[k], sd[k])]
    _require(not differ, f"phase 23d: the round trip changed {differ[:6]}")
    del back, sd
    gc.collect()
    torch.cuda.empty_cache()
    convert_peak = torch.cuda.max_memory_allocated() / 1e9

    t = time.perf_counter()
    q = quantize_llama_params(model.state_dict(), device=DEVICE)
    del model
    cfg_q = dataclasses.replace(cfg, quant="int8")
    model = Llama.from_params(cfg_q, q, device=DEVICE)
    del q
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, device=DEVICE)
    prompts, budgets = _requests(cfg_q, HF_REQUESTS)
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    spent = _time_engine(torch, engine)
    torch.cuda.synchronize()
    _zero_launches()
    t = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t
    launches = _read_launches()
    _check_budgets(engine, results, rids, budgets, cfg_q.vocab_size, "23d")
    want = _engines_launches(cfg_q, [engine])
    _require(launches == want and launches["quantized_matmul"] > 0
             and launches["paged_attention_decode"] > 0,
             f"phase 23d: launches {launches}, the engine's counts "
             f"predict {want}")
    stats = dict(engine.stats)
    decoded = sum(len(results[r]) for r in rids) - len(rids)
    report = {
        "n_layers": cfg.n_layers, "hf_bytes": hf_bytes,
        "from_hf_s": from_s, "llama_from_params_s": build_s,
        "to_hf_s": to_s, "round_trip_bit_identical": True,
        "convert_peak_gb": convert_peak, "quantize_s": quant_s,
        "requests": len(rids), "budgets": budgets,
        "serve_wall_s": wall,
        "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
        "decode_tokens_per_s": decoded / spent["decode"],
        "prefill_ms_mean": 1e3 * statistics.mean(spent["prefill"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stats": stats, "launches": launches}
    del engine, model
    _log("hf_convert " + json.dumps(report))
    return report


# -- phase 24: gang and serving telemetry ------------------------------------


@contextlib.contextmanager
def _telemetry_on(**settings):
    """The port's telemetry on for the block: ``observe.TELEMETRY_DIR`` a
    fresh temporary root (yielded), and ``settings`` (``{"health.STALL_S":
    5.0, ...}``, module settings, never an environment variable) in
    force; every one put back after."""
    from sparkdl_tpu_torch import observe

    root = tempfile.mkdtemp(prefix="chip-smoke-telemetry-")
    with observe.applied_settings(dict(settings,
                                       **{"observe.TELEMETRY_DIR": root})):
        yield root


def _one_run_dir(root):
    dirs = [os.path.join(root, d) for d in os.listdir(root)
            if d.startswith("run-")]
    _require(len(dirs) == 1, f"{len(dirs)} run dirs under {root}, want 1")
    return dirs[0]


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _lanes(run_dir):
    """The run dir's timeline events by lane (0 the driver or the
    server, rank + 1 a rank)."""
    with open(os.path.join(run_dir, "timeline.json")) as f:
        doc = json.load(f)
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] != "M":
            lanes.setdefault(e["pid"], []).append(e)
    return lanes


def _series(run_dir):
    """``metrics.json``'s series: (name, labels with the extra ones,
    the series dict)."""
    with open(os.path.join(run_dir, "metrics.json")) as f:
        doc = json.load(f)
    return [(m["name"], {**m["labels"], **s["labels"]}, m)
            for s in doc["series"]
            for kind in ("counters", "gauges", "histograms")
            for m in s[kind]]


def _metric(series, name, **labels):
    """The one series ``name`` whose labels include ``labels``."""
    hits = [m for n, lab, m in series if n == name and all(
        lab.get(k) == str(v) for k, v in labels.items())]
    _require(len(hits) == 1, f"{len(hits)} series {name}{labels} in the "
             "run dir, want 1")
    return hits[0]


def _hist_quantile(h, q):
    """Quantile ``q`` of a histogram series, interpolated inside its
    bucket (Prometheus' ``histogram_quantile``)."""
    target, seen, lo = q * h["count"], 0, 0.0
    for upper, n in zip(h["buckets"], h["counts"]):
        if n and seen + n >= target:
            return lo + (upper - lo) * (target - seen) / n
        seen, lo = seen + n, upper
    return h["buckets"][-1]


def _lora_step_flops(model, named, cfg, tokens, seq):
    """Model FLOPs of one LoRA step, phase 5's count: forward 2N,
    backward dX 2N, dW 2N_train, attention 3 x 4 S d_model / 2 a layer
    (causal), a token."""
    from sparkdl_tpu_torch.parallel.train import param_count

    n_matmul = param_count(model) - cfg.vocab_size * cfg.d_model
    n_train = sum(p.numel() for _, p in named)
    attn = 3 * (4 * seq * cfg.d_model) / 2 * cfg.n_layers
    return (4 * n_matmul + 2 * n_train + attn) * tokens


def autotune_serve(torch, card):
    """Phase 28a: ``python -m sparkdl_tpu_torch.perf.autotune --bench
    serve`` (its ``main``, in this process; each trial a subprocess of
    ``perf.trial``) over :data:`AUTOTUNE_KNOB`'s default and
    :data:`AUTOTUNE_VALUE` at Llama-3-8B width, depth
    :data:`AUTOTUNE_DEPTH`, int8 weights, the paged cache; the profile
    emitted under a temporary directory's ``h100`` key. Gates: the plan,
    every trial's ledger line (4 rounds of tokens/s, the card's name),
    its B4 and B5 launches what its engines' decode steps and forwards
    predict, and a verified or degraded profile with its evidence."""
    import io

    from sparkdl_tpu_torch.observe import perf as operf
    from sparkdl_tpu_torch.perf import autotune, profile

    root = tempfile.mkdtemp(prefix="chip-smoke-28a-")
    history = os.path.join(root, "history.jsonl")
    profiles = os.path.join(root, "profiles")
    bench_args = [f"--layers={AUTOTUNE_DEPTH}"]
    if DEVICE != "cuda":
        bench_args += ["--device=cpu", "--config=tiny"]
    argv = ["--bench", "serve", "--knob", AUTOTUNE_KNOB,
            "--values", f"{AUTOTUNE_KNOB}={AUTOTUNE_VALUE}",
            "--max-trials", str(AUTOTUNE_MAX_TRIALS),
            "--profile-dir", profiles, "--history", history,
            "--trial-timeout", str(AUTOTUNE_TRIAL_TIMEOUT_S)]
    argv += [f"--bench-arg={a}" for a in bench_args]
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = autotune.main(argv)
    wall_s = time.perf_counter() - t
    _require(rc == 0, f"phase 28a: autotune exited {rc}: "
             f"{out.getvalue()[-400:]}")
    emitted = json.loads(out.getvalue())
    kind = "h100" if DEVICE == "cuda" else "cpu"
    _require(emitted["profile"] == os.path.join(profiles, kind,
                                                "serve.json"),
             f"phase 28a: the profile went to {emitted['profile']}")
    doc = profile.load_profile(emitted["profile"])
    ev = doc["evidence"]
    _require(doc["status"] in (profile.STATUS_VERIFIED,
                               profile.STATUS_DEGRADED)
             and doc["bench"] == "serve"
             and profile.strict_device_kind(doc["device_kind"]) == kind,
             f"phase 28a: profile {doc['status']} for {doc['device_kind']}")
    _require([tr["overrides"] for tr in ev["trials"]]
             == [{AUTOTUNE_KNOB: AUTOTUNE_VALUE}],
             f"phase 28a: trials {ev['trials']}")
    searched = isinstance(ev["verification"], dict)
    forced = None
    if not searched:
        # the search kept the defaults (the value ties at this depth):
        # the proof-or-degrade step runs on the candidate all the same,
        # so every run drives the verification trials
        runner = autotune.make_runner(
            "serve", history_path=history, extra_args=bench_args,
            timeout=AUTOTUNE_TRIAL_TIMEOUT_S)
        forced = autotune.verify_and_emit(runner, autotune.SearchResult(
            bench="serve", primary_metric=runner.primary_metric,
            baseline=ev["baseline"], trials=[],
            best_overrides={AUTOTUNE_KNOB: AUTOTUNE_VALUE},
            best_metrics=None, pruned=[], space_size=ev["space_size"],
            device_kind=doc["device_kind"]), log=lambda msg: None)
        _require(forced["status"] in (profile.STATUS_VERIFIED,
                                      profile.STATUS_DEGRADED)
                 and isinstance(forced["evidence"]["verification"], dict),
                 f"phase 28a: forced verification {forced['status']}")
    verification = (ev if searched else forced["evidence"])["verification"]
    lines = operf.read_history(history)
    _require(len(lines) == 4,
             f"phase 28a: {len(lines)} ledger lines, want the search's 2 "
             "and the verification's 2")
    cfg_layers = AUTOTUNE_DEPTH
    trials = []
    for rec in lines:
        got = rec["launches"]
        tps = rec["metrics"]["serve_tokens_per_sec"]
        _require(rec["bench"] == "trial:serve"
                 and len(tps["samples"]) == 4
                 and rec["n_layers"] == cfg_layers,
                 f"phase 28a: ledger line {rec['bench']} with "
                 f"{len(tps['samples'])} samples, {rec['n_layers']} layers")
        if DEVICE == "cuda":
            want = {"paged_attention_decode":
                    cfg_layers * rec["engine_steps"],
                    "quantized_matmul":
                    (7 * cfg_layers + 1) * rec["engine_forwards"]}
            _require(rec["device_kind"] == torch.cuda.get_device_name(0)
                     and all(got[k] == n > 0 for k, n in want.items())
                     and got["quantized_matmul_int4"] == 0
                     and not any(got[k] for k in ("flash_fwd",
                                                  "flash_bwd_dq",
                                                  "flash_bwd_dkv")),
                     f"phase 28a: trial {rec['settings']} launched {got}, "
                     f"its engines' counts predict {want}")
        trials.append({
            "settings": rec["settings"], "tokens_per_s": tps["value"],
            "tokens_per_s_samples": tps["samples"],
            "ttft_ms_p50": rec["metrics"]["serve_ttft_ms"]["value"],
            "inter_token_ms_p50":
                rec["metrics"]["serve_inter_token_ms"]["value"],
            "wall_s": rec["wall_s"], "build_s": rec["build_s"],
            "engine_steps": rec["engine_steps"], "launches": got})
    report = {
        "phase": "28a", "n_layers": cfg_layers, "knob": AUTOTUNE_KNOB,
        "value": AUTOTUNE_VALUE, "trials": trials,
        "decision": ev["trials"][0]["decision"],
        "delta": ev["trials"][0]["delta"],
        "threshold": ev["trials"][0]["threshold"],
        "verification": verification["primary"],
        "verification_forced": not searched,
        "verified_status": (forced or doc)["status"],
        "status": doc["status"], "knobs": doc["knobs"],
        "candidate_knobs": doc.get("candidate_knobs", {}),
        "launches": {k: sum(tr["launches"][k] for tr in trials)
                     for k in ("paged_attention_decode",
                               "quantized_matmul")},
        "profile_dir": profiles, "wall_s": wall_s, "card": card}
    _log("autotune " + json.dumps(report))
    return report


def _captures_a_device_tensor(torch):
    """A ``main`` whose closure holds a tensor on the card (the meta
    device in a CPU rehearsal)."""
    table = torch.zeros((1024, 1024), device=(
        DEVICE if DEVICE == "cuda" else "meta"))

    def main():
        return float(table.sum())

    return main


def preflight_refusal(torch, card):
    """Phase 28d: ``preflight.ENABLED`` on, a launch whose ``main``
    captures a CUDA tensor is refused with ``PreflightLintError`` before
    the launcher spawns anything (``subprocess.Popen`` a tripwire); the
    lint's own time beside the refused launch's."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.analysis import preflight
    from sparkdl_tpu_torch.horovod import launcher

    main = _captures_a_device_tensor(torch)
    spawned = []

    def tripwire(*a, **k):
        spawned.append(a[0] if a else None)
        raise CheckFailed("phase 28d: the launcher spawned a worker")

    refused = None
    with _attrs(preflight, ENABLED=True), \
            _attrs(launcher.subprocess, Popen=tripwire), \
            _launcher_settings():
        t = time.perf_counter()
        findings = None
        try:
            preflight.preflight_lint(main, {})
        except preflight.PreflightLintError as e:
            findings = e.findings
        lint_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        try:
            HorovodRunner(np=1).run(main)
        except preflight.PreflightLintError as e:
            refused = e
        launch_ms = 1e3 * (time.perf_counter() - t)
    _require(findings and [f.op for f in findings] == ["torch.Tensor"],
             f"phase 28d: the lint found {findings}")
    _require(refused is not None and not spawned,
             f"phase 28d: the launch was {'not ' if refused is None else ''}"
             f"refused, {len(spawned)} spawn(s)")
    report = {"phase": "28d", "refused": type(refused).__name__,
              "finding": str(refused.findings[0])[:200],
              "preflight_lint_ms": lint_ms, "refused_launch_ms": launch_ms,
              "spawned": len(spawned), "card": card}
    _log("preflight " + json.dumps(report))
    return report


def telemetry_main(cfg, batch, warmup, steps, save_after, seed, device,
                   ckpt_dir, report_settings=()):
    """Every rank of phase 24a: 9a's trainer (:func:`_gang_trainer`), its
    step in ``instrument_step`` with phase 5's FLOPs a step registered,
    the model and AdamW's state registered with ``mem``; ``warmup`` +
    ``steps`` steps, a ``TrainCheckpointer`` save of the adapters after
    step ``save_after``. Rank 0 returns every rank's report, with the
    values of the registered settings ``report_settings`` in force (28b)
    and whether the lock-order sanitizer is installed (28c)."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.observe import mem, perf
    from sparkdl_tpu_torch.parallel.train import instrument_step
    from sparkdl_tpu_torch.utils import knobs, locksan
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    tr = _gang_trainer(cfg, batch, seed, device)
    mem.register_tree("params", tr.model)
    mem.register_tree("opt_state", tr.opt)
    rows, seq = tr.mine["inputs"].shape
    flops = _lora_step_flops(tr.model, tr.named, cfg, rows * seq, seq)
    perf.register_step_cost("train_step", flops=flops)
    step = instrument_step(tr.step)
    ckpt = TrainCheckpointer(ckpt_dir)
    _zero_flash()
    losses, times = [], []
    for s in range(warmup + steps):
        tr.sync()
        t = time.perf_counter()
        losses.append(step(tr.mine)["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t)
        if s == save_after:
            ckpt.save(s, {"adapters": dict(tr.named)})
    launches = _flash_launches()
    mem.sample_now()  # the categories' last gauges, for the last flush

    def nbytes(tensors):
        seen = {id(t): t for t in tensors if isinstance(t, torch.Tensor)}
        return sum(t.numel() * t.element_size() for t in seen.values())

    return hvd.allgather_object({
        "rank": hvd.rank(), "losses": losses,
        "step_ms": [1e3 * x for x in times[warmup:]],
        "step_ms_median": 1e3 * statistics.median(times[warmup:]),
        "settings": {n: knobs.read(n) for n in report_settings},
        "locksan_installed": locksan.installed(),
        "flops_per_step": flops, "launches": launches,
        "params_bytes": nbytes(list(tr.model.parameters())
                               + list(tr.model.buffers())),
        "opt_state_bytes": nbytes(t for st in tr.opt.state.values()
                                  for t in st.values())})


def telemetry_gang(torch, gang, tuned):
    """Phase 24a: 9a's fine-tune with the telemetry on; 28b and 28c ride
    it: phase 28a's profile (``tuned["profile_dir"]``) applied by the
    launcher's pre-flight, the lock-order sanitizer on the driver and the
    rank."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.observe import health, perf
    from sparkdl_tpu_torch.parallel.train import global_batch
    from sparkdl_tpu_torch.perf import profile
    from sparkdl_tpu_torch.utils import knobs, locksan

    cfg = _train_cfg()
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    beats = []
    observe_beat = health.HangDetector.observe_beat

    def counted(self, rank, payload):
        beats.append(rank)
        return observe_beat(self, rank, payload)

    ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-24a-")
    san_dir = tempfile.mkdtemp(prefix="chip-smoke-28c-")
    # every serve setting, tuned or not: the profile's value or the default
    names = [kb.name for kb in knobs.tunable_knobs("serve")]
    health.HangDetector.observe_beat = counted
    locksan.reset()
    try:
        with _telemetry_on(**{"health.HEARTBEAT_S":
                              TELEMETRY_HEARTBEAT_S}) as root, \
                _launcher_settings(), \
                _attrs(profile, PROFILE=tuned["profile_dir"]), \
                _attrs(locksan, ENABLED=True,
                       REPORT=os.path.join(san_dir, "concur_report.json")):
            t = time.perf_counter()
            applied = profile.preflight_settings()
            preflight_ms = 1e3 * (time.perf_counter() - t)
            t = time.perf_counter()
            ranks = HorovodRunner(np=GANG_NP["24a"]).run(
                telemetry_main, cfg=cfg, batch=batch,
                warmup=TELEMETRY_WARMUP, steps=TELEMETRY_STEPS,
                save_after=TELEMETRY_SAVE_AFTER, seed=SEED, device=DEVICE,
                ckpt_dir=ckpt_dir, report_settings=names)
            wall_s = time.perf_counter() - t
    finally:
        health.HangDetector.observe_beat = observe_beat
        driver_san = locksan.report()
        locksan.uninstall()
        locksan.reset()
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tuned_knobs = (tuned["knobs"] if tuned["status"] ==
                   profile.STATUS_VERIFIED else {})
    _require(applied == tuned_knobs, f"phase 28b: the pre-flight applies "
             f"{applied}, the profile holds {tuned_knobs}")
    want = {n: tuned_knobs.get(n, knobs.get(n).default) for n in names}
    for r in ranks:
        _require(r["settings"] == want, f"phase 28b: rank {r['rank']} ran "
                 f"under {r['settings']}, the profile gives {want}")
    _require(driver_san["installed"] and driver_san["lock_sites"] > 0
             and driver_san["cycles"] == [] and not driver_san["inversions"],
             f"phase 28c: the driver's sanitizer: {driver_san['lock_sites']} "
             f"sites, cycles {driver_san['cycles']}, "
             f"{len(driver_san['inversions'])} inversions")
    rank_san = []
    for r in ranks:
        path = os.path.join(san_dir, f"concur_report-rank-{r['rank']}.json")
        _require(r["locksan_installed"] and os.path.isfile(path),
                 f"phase 28c: rank {r['rank']} ran no sanitizer ({path})")
        with open(path) as f:
            doc = json.load(f)
        _require(doc["cycles"] == [] and not doc["inversions"],
                 f"phase 28c: rank {r['rank']}: cycles {doc['cycles']}, "
                 f"{len(doc['inversions'])} inversions")
        rank_san.append(doc)
    sanitizer = {
        "driver": {k: (len(v) if isinstance(v, list) else v)
                   for k, v in driver_san.items() if k != "schema"},
        "ranks": [{k: (len(v) if isinstance(v, list) else v)
                   for k, v in d.items() if k != "schema"}
                  for d in rank_san],
        "long_holds": [(h["lock"], h["held_s"]) for d in rank_san
                       for h in d["long_holds"]]}
    _log("preflight_profile " + json.dumps({
        "phase": "28b", "applied": applied, "rank_settings": want,
        "preflight_settings_ms": preflight_ms,
        "card": tuned["card"]}))
    _log("locksan " + json.dumps(dict(sanitizer, phase="28c")))
    run_dir = _one_run_dir(root)
    r0 = ranks[0]
    n_steps = TELEMETRY_WARMUP + TELEMETRY_STEPS
    names = set(os.listdir(run_dir))
    want = {"timeline.json", "metrics.prom", "metrics.json", "perf.json",
            "health.json"}
    _require(want <= names, f"phase 24a: the run dir lacks "
             f"{sorted(want - names)}")
    lanes = _lanes(run_dir)
    lane = lanes.get(1, [])
    phases = [e["args"]["phase"] for e in lane
              if e["name"] == "train_step" and e["ph"] == "X"]
    _require(phases == ["compile"] + ["execute"] * (n_steps - 1),
             f"phase 24a: rank 0's train_step spans {phases}")
    lane_names = [e["name"] for e in lane]
    for name, n in (("checkpoint.save", 1), ("worker.start", 1),
                    ("worker.exit", 1)):
        _require(lane_names.count(name) == n, f"phase 24a: {name} "
                 f"{lane_names.count(name)} times on rank 0's lane")
    _require("gang.attempt" in [e["name"] for e in lanes.get(0, [])],
             "phase 24a: no gang.attempt on the driver's lane")
    series = _series(run_dir)
    total = _metric(series, "train_step_total", phase="execute", rank=0)
    _require(total["value"] == n_steps - 1,
             f"phase 24a: train_step_total {total['value']}")
    with open(os.path.join(run_dir, "perf.json")) as f:
        rows = json.load(f)["ranks"]["0"]
    for row in rows["per_step"]:
        gap = abs(sum(row["components"].values()) - row["dur_s"])
        _require(gap <= 1e-6 * len(row["components"]),
                 f"phase 24a: a step's components miss its span by {gap} s")
    kind = (perf.normalize_device_kind(torch.cuda.get_device_name(0))
            if DEVICE == "cuda" else "cpu")
    mfu = _metric(series, "mfu", fn="train_step", device_kind=kind,
                  rank=0)["value"]
    _require(0 < mfu <= 1.05, f"phase 24a: MFU {mfu} against {kind}")
    for cat, key in (("params", "params_bytes"),
                     ("opt_state", "opt_state_bytes")):
        got = _metric(series, "mem_bytes", category=cat, rank=0)["value"]
        _require(got == r0[key], f"phase 24a: mem_bytes{{{cat}}} {got}, "
                 f"the tensors hold {r0[key]}")
    limit = None
    if DEVICE == "cuda":
        limit = _metric(series, "device_hbm_bytes", kind="limit",
                        rank=0)["value"]
        total_mem = torch.cuda.get_device_properties(0).total_memory
        _require(limit == total_mem, f"phase 24a: device_hbm_bytes limit "
                 f"{limit}, the card holds {total_mem}")
    with open(os.path.join(run_dir, "health.json")) as f:
        attempt = json.load(f)["attempts"][0]
    _require(beats and attempt["hang_verdict"] is None
             and not attempt["stalled"],
             f"phase 24a: {len(beats)} beats, verdict "
             f"{attempt['hang_verdict']}, stalled {attempt['stalled']}")
    for name, n in r0["launches"].items():
        _require(n == cfg.n_layers * n_steps, f"phase 24a: {name} {n} "
                 f"launches in {n_steps} steps, want {cfg.n_layers} a step")
    report = {
        "np": GANG_NP["24a"], "n_layers": cfg.n_layers, "steps": n_steps,
        "step_ms": r0["step_ms"], "step_ms_median": r0["step_ms_median"],
        "phase9a_step_ms_median": gang["step_ms_median"],
        "step_ms_over_9a": r0["step_ms_median"] / gang["step_ms_median"],
        "mfu": mfu, "mfu_device_kind": kind,
        "flops_per_step": r0["flops_per_step"],
        "fractions": rows["fractions"], "perf_steps": rows["steps"],
        "beats": len(beats), "hbm_limit": limit,
        "params_bytes": r0["params_bytes"],
        "opt_state_bytes": r0["opt_state_bytes"],
        "run_dir_bytes": _dir_bytes(run_dir), "run_wall_s": wall_s,
        "launches": r0["launches"],
        "profile_applied": applied, "preflight_settings_ms": preflight_ms,
        "sanitizer": sanitizer}
    _log("telemetry_gang " + json.dumps(report))
    return report


def _hang_wedge():
    """Phase 24b's wedge, user code of ``main``: the rank enters an
    allreduce (as the hang detector sees it) that no peer ever joins."""
    from sparkdl_tpu_torch.observe import health

    health.note_collective("allreduce")
    threading.Event().wait()


def hang_main(cfg, batch, seed, device):
    """Every rank of phase 24b: the instrumented step of
    :func:`_gang_trainer`'s model; attempt 0 takes one step and wedges
    (:func:`_hang_wedge`), attempt 1 takes two."""
    from sparkdl_tpu_torch import horovod, hvd
    from sparkdl_tpu_torch.parallel.train import instrument_step

    tr = _gang_trainer(cfg, batch, seed, device)
    ctx = horovod.restart_context()
    step = instrument_step(tr.step)
    _zero_flash()
    if ctx.attempt == 0:
        step(tr.mine)["loss"].item()
        _hang_wedge()
    losses = [step(tr.mine)["loss"].item() for _ in range(2)]
    return hvd.allgather_object({"attempt": ctx.attempt, "losses": losses,
                                 "launches": _flash_launches()})


def hang_gang(torch):
    """Phase 24b: a hang diagnosed and relaunched on the card."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.horovod import supervisor
    from sparkdl_tpu_torch.parallel.train import global_batch

    cfg = _train_cfg(n_layers=HANG_DEPTH)
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    policy = supervisor.policy
    supervisor.policy = supervisor.RetryPolicy(max_retries=1,
                                               backoff_base=0.5, jitter=0.0)
    try:
        with _telemetry_on(**{"health.HEARTBEAT_S": HANG_HEARTBEAT_S,
                              "health.STALL_S": HANG_STALL_S,
                              "observe.FLUSH_S": 1.0}) as root, \
                _launcher_settings():
            t = time.perf_counter()
            ranks = HorovodRunner(np=GANG_NP["24b"]).run(
                hang_main, cfg=cfg, batch=batch, seed=SEED, device=DEVICE)
            wall_s = time.perf_counter() - t
    finally:
        supervisor.policy = policy
    run_dir = _one_run_dir(root)
    r0 = ranks[0]
    _require(r0["attempt"] == 1 and len(r0["losses"]) == 2
             and all(np.isfinite(r0["losses"])),
             f"phase 24b: the relaunch returned {r0}")
    with open(os.path.join(run_dir, "health.json")) as f:
        attempts = json.load(f)["attempts"]
    verdicts = [a["hang_verdict"] for a in attempts]
    _require(len(verdicts) == 2 and verdicts[0] is not None
             and verdicts[1] is None, f"phase 24b: verdicts {verdicts}")
    with open(os.path.join(run_dir, "stack-rank-0.txt")) as f:
        dump = f.read()
    _require("_hang_wedge" in dump,
             "phase 24b: the stack dump does not name the wedged frame")
    lanes = _lanes(run_dir)
    driver = lanes.get(0, [])
    failures = [e["args"] for e in driver if e["name"] == "gang.failure"]
    _require([(a["kind"], a["verdict"]) for a in failures]
             == [("hang", "transient")], f"phase 24b: failures {failures}")
    restarts = _metric(_series(run_dir), "gang_restarts_total",
                       rank="driver")["value"]
    _require(restarts == 1, f"phase 24b: gang_restarts_total {restarts}")
    lane = lanes.get(1, [])
    starts = [e for e in lane if e["name"] == "worker.start"]
    _require(len(starts) == 2, f"phase 24b: {len(starts)} worker.start "
             "on rank 0's lane, want one an attempt")
    with open(os.path.join(run_dir, "flightrec-rank-0.json")) as f:
        tail = json.load(f)["events"]
    hang_ts = next(e["ts"] for e in driver if e["name"] == "health.hang")
    wedged_steps = [e for e in tail if e["name"] == "train_step"
                    and e["ph"] == "X" and e["ts"] < hang_ts]
    _require(wedged_steps, "phase 24b: attempt 0's train_step span is not "
             "in the recovered flight-recorder tail")
    wedge_at = max(e["ts"] + e["dur"] for e in wedged_steps)
    relaunch_at = [e["ts"] for e in driver
                   if e["name"] == "gang.attempt"][1]
    resumed_at = min(e["ts"] for e in lane if e["name"] == "train_step"
                     and e["ph"] == "X" and e["ts"] > hang_ts)
    wedge_to_verdict = (hang_ts - wedge_at) / 1e6
    _require(wedge_to_verdict >= HANG_STALL_S, f"phase 24b: the verdict "
             f"came {wedge_to_verdict} s after the wedge, inside the "
             f"{HANG_STALL_S} s window")
    want = HANG_DEPTH * 2
    for name, n in r0["launches"].items():
        _require(n == want, f"phase 24b: {name} {n} launches, want {want}")
    report = {
        "np": GANG_NP["24b"], "n_layers": HANG_DEPTH, "verdict": verdicts[0],
        "stall_s": HANG_STALL_S, "heartbeat_s": HANG_HEARTBEAT_S,
        "wedge_to_verdict_s": wedge_to_verdict,
        "verdict_to_relaunch_s": (relaunch_at - hang_ts) / 1e6,
        "wedge_to_resumed_step_s": (resumed_at - wedge_at) / 1e6,
        "run_wall_s": wall_s, "losses": r0["losses"],
        "run_dir_bytes": _dir_bytes(run_dir), "launches": r0["launches"]}
    _log("hang_gang " + json.dumps(report))
    return report


def _serve_gathered(torch, model, prompts, budgets):
    """Phase 24c's run: phase 3's engine behind the HTTP frontend, one
    urllib client a request (odd ones streamed), started together; the
    engine's first burst waits until every request has arrived, so a
    run's steps (and launches) depend on the requests alone. Counters
    zeroed just before the clients start. Returns what it measured, the
    engine and the frontend (closed)."""
    from sparkdl_tpu_torch.models.server import ServingFrontend
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine

    n = len(prompts)
    engine = ContinuousBatchingEngine(model, model.state_dict(), n_slots=8,
                                      chunk=16, page_size=64, device=DEVICE)
    spent = _time_engine(torch, engine)
    chunks = []
    decode, run = engine._decode_chunk, engine.run

    def counted(*a, **k):
        chunks.append(1)
        return decode(*a, **k)

    fe = ServingFrontend(engine)

    def gathered_run(*a, **k):
        deadline = time.monotonic() + 60
        while (len(fe._live) + fe._arrivals.qsize() < n
               and time.monotonic() < deadline):
            time.sleep(0.002)
        fe._poll_queue(engine)
        return run(*a, **k)

    engine._decode_chunk, engine.run = counted, gathered_run
    fe.start()
    replies, errors = [None] * n, []

    def client(i):
        payload = {"tokens": prompts[i].tolist(),
                   "max_new_tokens": budgets[i], "stream": bool(i % 2)}
        t = time.perf_counter()
        try:
            replies[i] = (t, _http(fe, "/generate", payload))
        except Exception as e:  # reported below as a failed request
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        torch.cuda.synchronize()
        _zero_launches()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        launches = _read_launches()
    finally:
        fe.close()
    _require(not errors and all(r is not None for r in replies),
             f"phase 24c: HTTP requests failed: {errors}")
    ttft = []
    for i, (t_sent, reply) in enumerate(replies):
        toks = ([e["token"] for _, e in reply[:-1]] if i % 2
                else reply["tokens"])
        _require(len(toks) == budgets[i], f"phase 24c: request {i} "
                 f"returned {len(toks)} tokens, budget {budgets[i]}")
        if i % 2:
            ttft.append(reply[0][0] - t_sent)
    stats = dict(engine.stats)
    want = {"paged_attention_decode": model.cfg.n_layers * stats["steps"],
            "quantized_matmul": (7 * model.cfg.n_layers + 1)
            * (stats["steps"] + stats["prefill_segments"])}
    for name, k in want.items():
        _require(k > 0 and launches[name] == k, f"phase 24c: {name} "
                 f"{launches[name]} launches, engine counts predict {k}")
    return {"launches": launches, "stats": stats, "chunks": len(chunks),
            "decode_ms_per_step": 1e3 * spent["decode"] / stats["steps"],
            "ttft_streamed_s": ttft}, engine, fe


def serve_telemetry(torch, model):
    """Phase 24c: ServingTelemetry on phase 3's int8 engine behind HTTP,
    beside the same requests with the switch off."""
    from sparkdl_tpu_torch.observe import mem

    prompts, budgets = _requests(model.cfg, TELEMETRY_REQUESTS)
    off, _, _ = _serve_gathered(torch, model, prompts, budgets)
    with _telemetry_on():
        on, engine, fe = _serve_gathered(torch, model, prompts, budgets)
        kv_pages = mem.category_bytes()["kv_pages"]
    run_dir = fe.request_telemetry.run_dir
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (engine._cache.k, engine._cache.v))
    _require(kv_pages == pool_bytes, f"phase 24c: mem kv_pages {kv_pages}, "
             f"the pools hold {pool_bytes}")
    _require(on["launches"] == off["launches"], f"phase 24c: launches "
             f"{on['launches']} with the telemetry on, {off['launches']} "
             "off")
    tracks = {}
    for e in _lanes(run_dir).get(0, []):
        if e["cat"] == "serving":
            tracks.setdefault(e["tid"], []).append(e)
    _require(len(tracks) == TELEMETRY_REQUESTS,
             f"phase 24c: {len(tracks)} request tracks")
    order = ("request.submit", "request.admit", "request.first_token",
             "request.done")
    for tid, events in tracks.items():
        ts = {e["name"]: e["ts"] for e in events if e["ph"] == "i"}
        _require(all(k in ts for k in order)
                 and [ts[k] for k in order] == sorted(ts[k] for k in order)
                 and any(e["name"] == "request" and e["ph"] == "X"
                         for e in events),
                 f"phase 24c: request {tid}'s span tree {sorted(ts)}")
    series = _series(run_dir)
    ttft = _metric(series, "server_ttft_seconds", rank="server")
    _require(ttft["count"] == TELEMETRY_REQUESTS,
             f"phase 24c: server_ttft_seconds counts {ttft['count']}")
    chunks = _metric(series, "engine_decode_chunks_total",
                     rank="server")["value"]
    _require(chunks == on["chunks"], f"phase 24c: engine_decode_chunks_total"
             f" {chunks}, the engine ran {on['chunks']}")
    _require(os.path.exists(os.path.join(run_dir, "flightrec-rank-0.ring")),
             "phase 24c: no flight-recorder ring in the run dir")
    report = {
        "requests": TELEMETRY_REQUESTS, "n_slots": 8, "page_size": 64,
        "chunk": 16, "launches": on["launches"],
        "launches_off": off["launches"], "decode_chunks": on["chunks"],
        "ttft_p50_s": _hist_quantile(ttft, 0.5),
        "ttft_p95_s": _hist_quantile(ttft, 0.95),
        "ttft_streamed_clients_s": {
            "median": statistics.median(on["ttft_streamed_s"]),
            "max": max(on["ttft_streamed_s"])},
        "decode_ms_per_step": on["decode_ms_per_step"],
        "decode_ms_per_step_off": off["decode_ms_per_step"],
        "kv_pages_bytes": kv_pages, "run_dir_bytes": _dir_bytes(run_dir)}
    _log("serve_telemetry " + json.dumps(report))
    return report


# -- phase 25: the live tier and the readers ---------------------------------


@contextlib.contextmanager
def _observe_settings(settings):
    """Module settings of ``sparkdl_tpu_torch.observe``'s modules
    (``{"alerts.ENABLED": True, ...}``) for the block, then put back."""
    import importlib

    saved = []
    for key, value in settings.items():
        mod, name = key.rsplit(".", 1)
        module = importlib.import_module(f"sparkdl_tpu_torch.observe.{mod}")
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)
    try:
        yield
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


def _get(url, timeout=10):
    """GET ``url``: (seconds, body text)."""
    import urllib.request

    t = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read().decode()
    return time.perf_counter() - t, body


def _parse_prometheus(text):
    """``{series: value}`` of a Prometheus text body; raises on a line
    that is not ``name{labels} value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def alert_main(cfg, batch, warmup, healthy, slowed, factor, seed, device):
    """Every rank of phase 25a: 9a's trainer (:func:`_gang_trainer`), its
    step in ``instrument_step``; ``warmup`` + ``healthy`` steps of one
    trainer step, then ``slowed`` steps of ``factor`` trainer steps in
    one span. Each step's wall start, ms and flash launches (counters
    zeroed first). Rank 0 returns every rank's report."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.observe import perf
    from sparkdl_tpu_torch.parallel.train import instrument_step

    tr = _gang_trainer(cfg, batch, seed, device)
    rows, seq = tr.mine["inputs"].shape
    perf.register_step_cost("train_step", flops=_lora_step_flops(
        tr.model, tr.named, cfg, rows * seq, seq))

    def steps(times):
        for _ in range(times):
            out = tr.step(tr.mine)
        return out

    step = instrument_step(steps, name="train_step")
    _zero_flash()
    starts, ms, launches = [], [], []
    for s in range(warmup + healthy + slowed):
        tr.sync()
        before = _flash_launches()
        starts.append(time.time())
        t = time.perf_counter()
        step(factor if s >= warmup + healthy else 1)["loss"].item()
        ms.append(1e3 * (time.perf_counter() - t))
        after = _flash_launches()
        launches.append({k: after[k] - before[k] for k in after})
    return hvd.allgather_object({
        "rank": hvd.rank(), "starts": starts, "step_ms": ms,
        "step_launches": launches, "launches": _flash_launches()})


def alert_gang(torch):
    """Phase 25a: a slowdown of 9a's fine-tune caught, profiled, diffed."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.observe import doctor, forensics, statusz, top
    from sparkdl_tpu_torch.parallel.train import global_batch

    cfg = _train_cfg()
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    servers, managers, scrapes, metrics = [], [], [], []
    start_statusz = statusz.maybe_start_statusz
    make_forensics = forensics.maybe_make_forensics

    def kept_server(*a, **k):
        servers.append(start_statusz(*a, **k))
        return servers[-1]

    def kept_manager(*a, **k):
        managers.append(make_forensics(*a, **k))
        return managers[-1]

    done = threading.Event()

    def scrape():
        """The driver's own reads of the live page while the gang runs."""
        while not done.wait(0.5):
            if not servers:
                continue
            base = f"http://{servers[0].address}"
            try:
                took, body = _get(base + "/statusz")
                scrapes.append((took, json.loads(body)))
                metrics[:] = [_get(base + "/metrics")[1]]  # the newest
            except OSError:
                continue  # between attempts, or the gang's end

    scraper = threading.Thread(target=scrape, daemon=True)
    statusz.maybe_start_statusz = kept_server
    forensics.maybe_make_forensics = kept_manager
    t = time.perf_counter()
    try:
        with _telemetry_on(**ALERT_RANK_SETTINGS) as root, \
                _observe_settings(ALERT_SETTINGS), _launcher_settings():
            scraper.start()
            ranks = HorovodRunner(np=GANG_NP["25a"]).run(
                alert_main, cfg=cfg, batch=batch, warmup=ALERT_WARMUP,
                healthy=ALERT_HEALTHY, slowed=ALERT_SLOWED,
                factor=ALERT_SLOW_FACTOR, seed=SEED, device=DEVICE)
    finally:
        wall_s = time.perf_counter() - t
        done.set()
        scraper.join(timeout=10)
        statusz.maybe_start_statusz = start_statusz
        forensics.maybe_make_forensics = make_forensics
    run_dir = _one_run_dir(root)
    r0 = ranks[0]
    first_slow = ALERT_WARMUP + ALERT_HEALTHY
    names = set(os.listdir(run_dir))
    want = {"alerts.json", "regression_report.json",
            "profile_report-rank-0-0.json", "trace-rank-0-0.json"}
    _require(want <= names, f"phase 25a: the run dir lacks "
             f"{sorted(want - names)}")
    with open(os.path.join(run_dir, "alerts.json")) as f:
        fired = json.load(f)["alerts"]
    _require([(a["rule"], a["rank"]) for a in fired]
             == [("step_time_regression", 0)],
             f"phase 25a: alerts {[(a['rule'], a['rank']) for a in fired]}")
    alert = fired[0]
    _require(alert["ts"] > r0["starts"][first_slow],
             f"phase 25a: the alert at {alert['ts']} came before the first "
             f"slowed step began ({r0['starts'][first_slow]})")
    with open(os.path.join(run_dir, "regression_report.json")) as f:
        entries = json.load(f)["reports"]
    _require(len(entries) == 1, f"phase 25a: {len(entries)} regression "
             "entries")
    entry = entries[0]
    cap = entry["capture"]
    _require(cap is not None and "error" not in cap
             and cap["steps_captured"] == 2,
             f"phase 25a: the capture {cap}")
    diff = entry["diff"]
    comp = diff["delta"]["components_per_step"]
    base_c = diff["baseline"]["components_per_step"]["compute"]
    grew = (base_c + comp["compute"]) / base_c
    _require(diff["significant"] and diff["top_growing_component"]
             == "compute" and grew >= 1.5,
             f"phase 25a: the diff names {diff['top_growing_component']}, "
             f"compute x{grew:.3f}")
    [completed] = managers[0].captures_status()["completed"]
    with open(os.path.join(run_dir, cap["report"])) as f:
        per_step = json.load(f)["attribution"]["per_step"]
    captured = [r["step"] for r in per_step]
    _require(len(captured) == 2 and all(s >= first_slow for s in captured),
             f"phase 25a: captured steps {captured}")
    # the diff is the firing window's, healthy and slowed steps mixed; the
    # captured steps are all slowed: their compute against the baseline's
    captured_grew = statistics.mean(
        r["components"]["compute"] for r in per_step) / base_c
    _require(captured_grew >= 2.5,
             f"phase 25a: the captured steps' compute x{captured_grew:.3f} "
             "of the baseline's")
    with open(os.path.join(run_dir, cap["trace_dir"])) as f:
        trace = json.load(f)["traceEvents"]
    in_trace, in_counters = {}, {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        in_trace[name] = sum(1 for e in trace if e.get("cat") == "kernel"
                             and f"{name}_kernel" in e.get("name", ""))
        in_counters[name] = sum(r0["step_launches"][s][name]
                                for s in captured)
        want_n = cfg.n_layers * ALERT_SLOW_FACTOR * len(captured)
        _require(in_trace[name] == in_counters[name] == want_n,
                 f"phase 25a: {name} {in_trace[name]} times in the trace, "
                 f"{in_counters[name]} launches over the captured steps, "
                 f"want {want_n}")
    text = doctor.render_text(doctor.diagnose(run_dir))
    for part in ("alerts: 1 fired", "step_time_regression",
                 "perf forensics: 1 regression report(s), 1 capture(s)"):
        _require(part in text, f"phase 25a: the doctor lacks {part!r}")
    live = [(took, d) for took, d in scrapes
            if isinstance(d["ranks"].get("0", {}).get("step"), int)
            and isinstance(d["ranks"]["0"].get("beat_age_s"), float)
            and "0" in d["perf"]["per_rank"]]
    _require(live, f"phase 25a: no mid-run /statusz with rank 0's step, "
             f"beat age and perf window in {len(scrapes)} scrapes")
    _require(metrics and any(k.startswith("train_step_total{")
                             for k in _parse_prometheus(metrics[0])),
             "phase 25a: /metrics carried no train_step_total")
    frame = top.render(live[-1][1])
    _require("gang status" in frame, "phase 25a: top rendered no frame")
    slow_ms = r0["step_ms"][first_slow:]
    captured_ms = [r0["step_ms"][s] for s in captured]
    span_ms = [1e3 * r["dur_s"] for r in per_step]
    other_ms = [m for s, m in enumerate(r0["step_ms"])
                if s >= first_slow and s not in captured
                and s != captured[0] - 1]
    # the profiler starts at the end of the step before the window and
    # stops at the end of its last, on the training thread, outside the
    # step spans: in the loop's time of those two steps, not the spans'
    start_ms = r0["step_ms"][captured[0] - 1] - statistics.median(other_ms)
    stop_ms = captured_ms[-1] - span_ms[-1]
    latency = sorted(took for took, _ in scrapes)
    report = {
        "np": GANG_NP["25a"], "n_layers": cfg.n_layers,
        "steps": len(r0["step_ms"]), "slowed_from": first_slow,
        "healthy_ms_median": statistics.median(
            r0["step_ms"][ALERT_WARMUP:first_slow]),
        "slowed_ms_median": statistics.median(slow_ms),
        "first_slowed_to_alert_s": alert["ts"] - r0["starts"][first_slow],
        "alert_to_profile_done_s": completed["ts"] - alert["ts"],
        "alert_detail": alert["detail"],
        "captured_steps": captured, "captured_ms": captured_ms,
        "captured_span_ms": span_ms,
        "uncaptured_slowed_ms_median": statistics.median(other_ms),
        "profiler_start_ms": start_ms, "profiler_stop_ms": stop_ms,
        "profile_window_s": cap["window_s"],
        "diff_step_factor": diff["delta"]["step_factor"],
        "diff_compute_factor": grew,
        "captured_compute_factor": captured_grew,
        "diff_steps": [diff["baseline"]["steps"], diff["regressed"]["steps"]],
        "trace_kernels": in_trace,
        "trace_bytes": os.path.getsize(os.path.join(run_dir,
                                                    cap["trace_dir"])),
        "statusz_scrapes": len(scrapes),
        "statusz_ms_median": 1e3 * statistics.median(latency),
        "statusz_ms_max": 1e3 * latency[-1],
        "run_dir_bytes": _dir_bytes(run_dir), "wall_s": wall_s,
        "launches": r0["launches"]}
    _log("alert_gang " + json.dumps(report))
    return report


def fleet_statusz(torch, model):
    """Phase 25b: a one-replica fleet on this process's ``/statusz``, and
    the ``server_ttft`` rule over its histogram."""
    from sparkdl_tpu_torch.models.fleet import FleetFrontend
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
    from sparkdl_tpu_torch.observe import alerts, statusz
    from sparkdl_tpu_torch.observe.aggregate import GangTelemetry

    cfg = model.cfg
    params = model.state_dict()
    prompts, budgets = _requests(cfg, FLEET_STATUSZ_REQUESTS)
    payloads = [{"tokens": p.tolist(), "max_new_tokens": b}
                for p, b in zip(prompts, budgets)]
    engines = []

    def factory():
        engines.append(ContinuousBatchingEngine(
            model, params, n_slots=8, chunk=16, page_size=64, device=DEVICE))
        return engines[-1]

    t = time.perf_counter()
    server = statusz.StatuszServer(GangTelemetry()).start()
    fleet = FleetFrontend(factory, replicas=1,
                          max_queue=FLEET_MAX_QUEUE).start()
    docs, latency, fires = [], [], {}
    try:
        burst = {}
        runner = threading.Thread(target=lambda: burst.update(
            zip(("got", "wall"), _fleet_burst(fleet, payloads))))
        _zero_launches()
        runner.start()
        while runner.is_alive():
            took, body = _get(f"http://{server.address}/statusz")
            latency.append(took)
            docs.append(json.loads(body))
            time.sleep(0.1)
        runner.join()
        launches = _read_launches()
        snap = fleet.metrics.snapshot()
        [ttft] = [h for h in snap["histograms"]
                  if h["name"] == "server_ttft_seconds"]
        p99 = alerts._histogram_quantile(ttft["buckets"], ttft["counts"],
                                         0.99)
        for name, bound in (("below", p99 / 2), ("above", p99 * 2)):
            with _observe_settings({"alerts.TTFT_P99_S": bound,
                                    "alerts.CHECK_S": 0.0}):
                engine = alerts.AlertEngine(GangTelemetry())
                engine.poll()
                engine.poll()  # latched: the same firing, not another
            fires[name] = [r["rule"] for r in engine.records()]
    finally:
        fleet.close()
        server.close()
    wall_s = time.perf_counter() - t
    _require(statusz.fleet_status() is None,
             "phase 25b: a closed fleet is still registered")
    _burst_summary(burst["got"], payloads, burst["wall"], cfg.vocab_size,
                   "phase 25b")
    want = _engines_launches(cfg, engines)
    _require(launches == want, f"phase 25b: launches {launches}, the "
             f"engine's counts predict {want}")
    rows = [d["fleet"] for d in docs if d.get("fleet")]
    _require(rows and all(len(f) == 1 and len(f[0]["replicas"]) == 1
                          and isinstance(f[0]["queue_depth"], int)
                          for f in rows),
             f"phase 25b: /statusz fleet rows {rows[:1]}")
    depths = [f[0]["queue_depth"] for f in rows]
    _require(ttft["count"] == FLEET_STATUSZ_REQUESTS,
             f"phase 25b: server_ttft_seconds counts {ttft['count']}")
    _require(fires == {"below": ["server_ttft"], "above": []},
             f"phase 25b: server_ttft fired {fires} around p99 {p99}")
    latency.sort()
    report = {
        "requests": FLEET_STATUSZ_REQUESTS, "replicas": 1,
        "launches": launches, "ttft_p99_bucket_s": p99,
        "ttft_p50_s": _hist_quantile(ttft, 0.5),
        "queue_depth_max": max(depths), "statusz_scrapes": len(docs),
        "statusz_ms_median": 1e3 * statistics.median(latency),
        "statusz_ms_max": 1e3 * latency[-1],
        "server_ttft_fires": fires, "wall_s": wall_s}
    _log("fleet_statusz " + json.dumps(report))
    return report


# -- phase 26: an elastic round trip -------------------------------------------


def elastic_main(cfg, batch, steps, seed, device, ckpt_dir, log_dir, pace_s):
    """Every rank of phase 26: 9b's trainer (:func:`_gang_trainer`) on the
    mesh of its restart context's target axes (else ``data`` over the
    world), resumed from the context's step onto that mesh; each step
    saved on the mesh (adapters and optimizer state), a barrier, a line
    in ``<log_dir>/a<attempt>-r<rank>.jsonl`` (the loss, the step's ms,
    the flash counters so far, the wall clock at the step's end and, on
    an attempt's first step, when the rank was past ``hvd.init``, had
    its model built and had restored), the
    fault injection's hook, ``pace_s`` of pause. A rank of a one-rank
    gang on the card must have bound ``cuda:0`` over NCCL. Rank 0
    returns every rank's report."""
    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import restart_context
    from sparkdl_tpu_torch.parallel.mesh import make_mesh_from_axes
    from sparkdl_tpu_torch.utils.chaos import chaos_step
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    tr = _gang_trainer(cfg, batch, seed, device)
    ctx = restart_context()
    rank, size = hvd.rank(), hvd.size()
    if device == "cuda" and size == 1:
        _require(tr.device == torch.device("cuda", 0)
                 and tr.backend == "cpu:gloo,cuda:nccl",
                 f"phase 26: the one-rank gang bound {tr.device} over "
                 f"{tr.backend}, not cuda:0 over NCCL")
    mesh = make_mesh_from_axes(dict(ctx.target_axes or {"data": size}))
    ckpt = TrainCheckpointer(ckpt_dir)
    start, reshard, restore_ms, restored_at = 0, None, None, None
    if ctx.resume_step is not None:
        tr.sync()
        t = time.perf_counter()
        state = ckpt.restore(ctx.resume_step,
                             target={"adapters": dict(tr.named), "opt": None},
                             target_mesh=mesh)
        with torch.no_grad():
            for name, p in tr.named:
                p.copy_(state["adapters"][name])
        tr.opt.load_state_dict(state["opt"])
        tr.sync()
        restore_ms = 1e3 * (time.perf_counter() - t)
        restored_at = time.time()
        reshard = ckpt.last_reshard
        start = ckpt.last_restored_step + 1
    _zero_flash()
    path = os.path.join(log_dir, f"a{ctx.attempt}-r{rank}.jsonl")
    losses = []
    for s in range(start, steps):
        tr.sync()
        t = time.perf_counter()
        losses.append(tr.step(tr.mine)["loss"].item())  # waits for the step
        ms = 1e3 * (time.perf_counter() - t)
        done_at = time.time()
        ckpt.save(s, {"adapters": dict(tr.named),
                      "opt": tr.opt.state_dict()}, mesh=mesh, specs={})
        hvd.barrier()  # rank 0's step committed before any rank dies
        with open(path, "a") as f:
            f.write(json.dumps({
                "attempt": ctx.attempt, "rank": rank, "size": size,
                "step": s, "loss": losses[-1], "ms": ms,
                "done_at": done_at, "launches": _flash_launches(),
                "reshard": reshard if s == start else None,
                "restore_ms": restore_ms if s == start else None,
                "ready_at": tr.ready_at, "built_at": tr.built_at,
                "restored_at": restored_at}) + "\n")
        chaos_step(s)
        time.sleep(pace_s)
    ckpt.close()
    report = {"rank": rank, "size": size, "attempt": ctx.attempt,
              "resume_step": ctx.resume_step, "losses": losses,
              "adapters": ({n: p.detach().cpu() for n, p in tr.named}
                           if rank == 0 else None)}
    return hvd.allgather_object(report)


def _elastic_twin(torch, cfg, batch, worlds, trace_dir):
    """The in-process twin of phase 26's steps: rank 0's weights, an
    AdamW step a committed step on the whole global batch, in as many
    microbatches as the world that committed it had ranks (``worlds``:
    one a step), so each row's products are the gang's; the last step
    under ``profiler.trace`` with ``annotate("phase26.step")``. Its
    losses, the adapters' change and the trace's events."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        make_lm_loss_fn,
        make_train_step,
    )
    from sparkdl_tpu_torch.utils import profiler

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    model = init_weights(Llama(cfg, device=DEVICE), gen)
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    start = {n: p.detach().clone() for n, p in named}
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    steps = {n: make_train_step(make_lm_loss_fn(model), opt,
                                param_mask=mask, grad_accum=n,
                                device=DEVICE)
             for n in sorted(set(worlds))}
    losses = [steps[n](batch)["loss"].item() for n in worlds[:-1]]
    with profiler.trace(trace_dir):
        with profiler.annotate("phase26.step"):
            losses.append(steps[worlds[-1]](batch)["loss"].item())
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    _require(len(files) == 1, f"phase 26: the twin's trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    deltas = {n: (p.detach() - start[n]).cpu() for n, p in named}
    end = {n: p.detach().cpu() for n, p in named}
    del model, opt, steps, named, start
    return losses, deltas, end, events


def elastic_gang(torch):
    """Phase 26: 9b's fine-tune shrinks from two ranks to one after a
    kill and grows back to two when the capacity file says so, in one
    supervised ``HorovodRunner(np=-2)`` launch."""
    import shutil

    from sparkdl_tpu_torch import HorovodRunner, analysis
    from sparkdl_tpu_torch.analysis import comms
    from sparkdl_tpu_torch.horovod import elastic, launcher, supervisor
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.parallel.train import global_batch
    from sparkdl_tpu_torch.utils import chaos
    from sparkdl_tpu_torch.utils.checkpoint import latest_complete_step

    cfg = _train_cfg(n_layers=GANG_SHARED_DEPTH)
    batch = global_batch(np.random.default_rng(SEED + 4), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    work = tempfile.mkdtemp(prefix="chip-smoke-26-")
    ckpt_dir = os.path.join(work, "ckpt")
    log_dir = os.path.join(work, "steps")
    os.makedirs(log_dir)
    cap_file = os.path.join(work, "capacity")
    once = os.path.join(work, "one-kill")
    with open(cap_file, "w") as f:
        f.write("1")
    # the driver's view of the gang: the model's tree on data=2
    analysis.register_gang_sharding(Llama(cfg, device="meta"),
                                    mesh={"data": 2})
    cap_back = {}
    stop = threading.Event()

    def return_capacity():
        while not stop.is_set():
            if (latest_complete_step(ckpt_dir) or -1) >= ELASTIC_GROW_AFTER:
                with open(cap_file, "w") as f:
                    f.write("2")
                cap_back["at"] = time.time()
                return
            time.sleep(0.02)

    contexts = []
    launch_once = launcher._launch_gang_once

    def noted(*args, **kw):
        contexts.append((kw["restart"], kw.get("world"), time.time()))
        return launch_once(*args, **kw)

    returner = threading.Thread(target=return_capacity, daemon=True)
    phase_t = time.perf_counter()
    policy = supervisor.RetryPolicy(max_retries=1, backoff_base=0.5,
                                    backoff_max=1.0, jitter=0.0,
                                    resume_dir=ckpt_dir)
    try:
        returner.start()
        with _telemetry_on(**{"observe.FLUSH_S": 1.0}) as root, \
                _launcher_settings(ABORT_GRACE_S=10.0), \
                _attrs(supervisor, policy=policy), \
                _attrs(launcher, _launch_gang_once=noted), \
                _attrs(chaos, KILL_RANK=1, KILL_STEP=ELASTIC_KILL_AFTER,
                       ONCE_FILE=once), \
                _attrs(elastic, ENABLED=True, CAPACITY_FILE=cap_file,
                       **ELASTIC_SETTINGS):
            t = time.perf_counter()
            ranks = HorovodRunner(np=GANG_NP["26"]).run(
                elastic_main, cfg=cfg, batch=batch, steps=ELASTIC_STEPS,
                seed=SEED, device=DEVICE, ckpt_dir=ckpt_dir,
                log_dir=log_dir, pace_s=ELASTIC_PACE_S)
            wall_s = time.perf_counter() - t
        worlds = supervisor.attempt_world_sizes()
        killed_at = os.stat(once).st_mtime if os.path.exists(once) else None
        records = []
        for name in sorted(os.listdir(log_dir)):
            with open(os.path.join(log_dir, name)) as f:
                records += [json.loads(line) for line in f]
    finally:
        stop.set()
        returner.join(timeout=5)
        comms.clear_gang_sharding()
        shutil.rmtree(work, ignore_errors=True)
    run_dir = _one_run_dir(root)
    r0 = ranks[0]
    _require(killed_at is not None and r0["attempt"] == 2,
             f"phase 26: kill file {killed_at}, final attempt "
             f"{r0['attempt']}; want one kill and two relaunches")
    _require(worlds == [2, 1, 2], f"phase 26: worlds {worlds}")

    def axes(data):
        return {"data": data, "fsdp": 1, "seq": 1, "model": 1}

    pairs = [(c.source_axes, c.target_axes, world)
             for c, world, _ in contexts]
    _require(pairs == [(None, None, None), (axes(2), axes(1), 1),
                       (axes(1), axes(2), 2)],
             f"phase 26: restart contexts {pairs}")
    by_attempt = {}
    for rec in records:
        by_attempt.setdefault(rec["attempt"], []).append(rec)
    directions = [next(r["reshard"]["direction"] for r in by_attempt[a]
                       if r["reshard"] and r["rank"] == 0)
                  for a in (1, 2)]
    _require(directions == ["shrink", "grow"],
             f"phase 26: restores resharded {directions}")
    # each step's loss: the mean of the ranks' of the attempt that
    # committed it, as the gang's averaged step is
    step_losses, step_worlds = {}, {}
    for a in sorted(by_attempt):
        for s in sorted({r["step"] for r in by_attempt[a]}):
            step_losses[s] = float(np.mean([r["loss"] for r in by_attempt[a]
                                            if r["step"] == s]))
            step_worlds[s] = by_attempt[a][0]["size"]
    _require(sorted(step_losses) == list(range(ELASTIC_STEPS)),
             f"phase 26: committed steps {sorted(step_losses)}")
    launches = {}
    for a, recs in by_attempt.items():
        for rank in sorted({r["rank"] for r in recs}):
            mine = [r for r in recs if r["rank"] == rank]
            last = max(mine, key=lambda r: r["step"])
            want = cfg.n_layers * len(mine)
            for name, n in last["launches"].items():
                _require(n == want, f"phase 26 attempt {a} rank {rank}: "
                         f"{name} {n} launches in {len(mine)} steps, want "
                         f"{want}")
                launches[name] = launches.get(name, 0) + n
    with open(os.path.join(run_dir, "elastic.json")) as f:
        decisions = json.load(f)["decisions"]
    kinds = [(d["direction"], d["outcome"], d["from_np"], d["to_np"])
             for d in decisions]
    _require(kinds == [("shrink", "transition", 2, 1),
                       ("grow", "resize", 1, 2),
                       ("grow", "transition", 1, 2)],
             f"phase 26: elastic.json decisions {kinds}")
    driver = _lanes(run_dir).get(0, [])
    preflights = [e["args"] for e in driver
                  if e["name"] == "gang.reshard_preflight"]
    _require([a["target_np"] for a in preflights] == [1, 2],
             f"phase 26: pre-flights {preflights}")

    gc.collect()
    torch.cuda.empty_cache()
    trace_dir = tempfile.mkdtemp(prefix="chip-smoke-26-trace-")
    try:
        twin_losses, twin_deltas, twin_end, trace = _elastic_twin(
            torch, cfg, batch,
            [step_worlds[s] for s in range(ELASTIC_STEPS)], trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    names = {e.get("name", "") for e in trace}
    _require("phase26.step" in names
             and any("flash_fwd_kernel" in n for n in names),
             "phase 26: the twin's trace lacks the region or B1")
    gang_losses = [step_losses[s] for s in range(ELASTIC_STEPS)]
    for got_l, ref_l in zip(gang_losses, twin_losses):
        _require(abs(got_l - ref_l) <= 2.0 ** -10 * abs(ref_l),
                 f"phase 26 losses {gang_losses} vs the twin's "
                 f"{twin_losses}")
    rel_errs = {}
    for name, ref_delta in twin_deltas.items():
        delta = r0["adapters"][name] - (twin_end[name] - ref_delta)
        rel_errs[name] = ((delta - ref_delta).norm()
                          / ref_delta.norm()).item()
    _log("elastic_gang adapters " + json.dumps(rel_errs))
    worst = sorted(rel_errs.items(), key=lambda kv: -kv[1])[:4]
    _require(all(d.norm() > 0 for d in twin_deltas.values())
             and worst[0][1] <= 2.0 ** -5,
             f"phase 26: gang vs twin, relative errors of the adapters' "
             f"changes, worst {worst}")

    grow = next(d for d in decisions if d["outcome"] == "resize")
    first = {a: min(r["done_at"] for r in recs)
             for a, recs in by_attempt.items()}

    def breakdown(a, since):
        """The relaunch of attempt ``a`` from ``since`` (the kill, the
        grow decision) to its first step, by stage (rank 0's)."""
        r = min((r for r in by_attempt[a] if r["rank"] == 0),
                key=lambda r: r["step"])
        spawned = contexts[a][2]
        return {"to_launch": spawned - since,
                "launch_to_ready": r["ready_at"] - spawned,
                "ready_to_built": r["built_at"] - r["ready_at"],
                "built_to_restored": r["restored_at"] - r["built_at"],
                "first_step": r["done_at"] - r["restored_at"]}

    # rank 0's step ms by attempt; an attempt's first step is a fresh
    # process's first (its warm-up), so the median is of the others
    step_ms = {a: [r["ms"] for r in sorted(recs, key=lambda r: r["step"])
                   if r["rank"] == 0] for a, recs in by_attempt.items()}
    report = {
        "np": GANG_NP["26"], "n_layers": cfg.n_layers, "steps": ELASTIC_STEPS,
        "worlds": worlds, "killed_after_step": ELASTIC_KILL_AFTER,
        "grow_resume_step": r0["resume_step"],
        "kill_to_first_shrunk_step_s": first[1] - killed_at,
        "capacity_to_grow_decision_s": grow["ts"] - cap_back["at"],
        "grow_decision_to_first_regrown_step_s": first[2] - grow["ts"],
        "relaunch_breakdown_s": {"shrink": breakdown(1, killed_at),
                                 "grow": breakdown(2, grow["ts"])},
        "step_ms_by_attempt": [step_ms[a] for a in (0, 1, 2)],
        "step_ms_np2_np1_np2": [statistics.median(step_ms[a][1:]
                                                  or step_ms[a])
                                for a in (0, 1, 2)],
        "restore_ms": [next(r["restore_ms"] for r in by_attempt[a]
                            if r["rank"] == 0) for a in (1, 2)],
        "losses": gang_losses, "twin_losses": twin_losses,
        "step_worlds": [step_worlds[s] for s in range(ELASTIC_STEPS)],
        "worst_rel_change_err": max(rel_errs.values()),
        "launches": launches, "run_wall_s": wall_s,
        "phase_wall_s": time.perf_counter() - phase_t}
    _log("elastic_gang " + json.dumps(report))
    return report


# -- phase 29: the GBDT estimators ------------------------------------------


class _Clock:
    """Device intervals: CUDA events on the card, the host clock in a CPU
    rehearsal; :meth:`ms` waits for the device."""

    def __init__(self, torch):
        self.torch = torch
        self.marks = []

    def mark(self):
        if DEVICE == "cuda":
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def ms(self, a, b):
        if DEVICE == "cuda":
            self.torch.cuda.synchronize()
            return self.marks[a].elapsed_time(self.marks[b])
        return 1e3 * (self.marks[b] - self.marks[a])


def _higgs_like(torch, n):
    """``n`` rows x :data:`HIGGS_FEATURES` standard normal float32 features
    and their labels, made on the card from the seed; returns the host
    copies and the signal's Bayes accuracy."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 29)
    X = torch.randn(n, HIGGS_FEATURES, generator=gen, device=DEVICE)
    w = torch.tensor(GBDT_SIGNAL_W, device=DEVICE)
    s = X[:, :len(GBDT_SIGNAL_W)] @ w + 0.5 * X[:, 6] * X[:, 7]
    y = ((s + torch.randn(n, generator=gen, device=DEVICE)) > 0).float()
    bayes = torch.special.ndtr(s.abs()).mean().item()
    return X.cpu().numpy(), y.cpu().numpy(), bayes


def _gbdt_digest(bst):
    h = hashlib.sha256()
    for t in bst.trees:
        for k in sorted(t):
            h.update(np.ascontiguousarray(t[k]).tobytes())
    return h.hexdigest()


def _logloss(torch, margins, y):
    """Train logloss of host margins on the device (the booster's clip)."""
    m = torch.as_tensor(margins[:, 0], device=DEVICE).double()
    t = torch.as_tensor(y, device=DEVICE).double()
    p = torch.sigmoid(m).clamp(1e-15, 1 - 1e-15)
    return float(-(t * p.log() + (1 - t) * (1 - p).log()).mean())


def _host_margins(bst, X):
    """The forest's margins by a numpy descent of its trees over numpy's
    bins, summed in float32 in the card's order."""
    from sparkdl_tpu_torch.xgboost.booster import bin_data

    binned = bin_data(X, bst.edges, bst.missing)
    n_bins = bst.edges.shape[1] + 1
    rows = np.arange(len(X))
    m = np.zeros(len(X), np.float32) + np.float32(bst.base_score)
    for t in bst.trees:
        pos = np.zeros(len(X), np.int64)
        for _ in range(int(bst.params["max_depth"])):
            rf = binned[rows, t["feat"][pos]]
            right = np.where(rf == n_bins, ~t["missing_left"][pos],
                             rf > t["thr"][pos])
            pos = np.where(t["is_split"][pos], 2 * pos + 1 + right, pos)
        m += t["leaf_w"][pos]
    return m


def _tree_stage_ms(torch, binned, g, h):
    """One tree of :data:`GBDT_PARAMS` through the fit's own builder
    (``booster._build_tree``), each stage it calls between two clock
    marks: milliseconds of the histogram, split (with the level's write
    into the tree), route and predict stages, and the histogram's least
    bytes (each input read once, each output written once). The fit has
    run these stages at these shapes already: nothing is cold."""
    from sparkdl_tpu_torch.xgboost import booster as B

    depth, n_bins = GBDT_PARAMS["max_depth"], GBDT_PARAMS["max_bin"]
    f, n = binned.shape
    clock = _Clock(torch)
    spans = {"hist": [], "split": [], "route": [], "predict": []}

    def timed(stage, fn):
        def run(*args, **kw):
            a = clock.mark()
            out = fn(*args, **kw)
            spans[stage].append((a, clock.mark()))
            return out
        return run

    stages = {f"_{s}_stage": timed(s, getattr(B, f"_{s}_stage"))
              for s in spans}
    with _attrs(B, _set_level=timed("split", B._set_level), **stages):
        B._build_tree(binned, g, h,
                      torch.ones(f, dtype=torch.bool, device=binned.device),
                      max_depth=depth, n_bins_tot=n_bins + 1,
                      reg_lambda=1.0, reg_alpha=0.0, gamma=0.0,
                      min_child_weight=1.0,
                      learning_rate=GBDT_PARAMS["learning_rate"])
    ms = {k: [clock.ms(a, b) for a, b in v] for k, v in spans.items()}
    hist_bytes = sum(binned.numel() * binned.element_size() + n * (4 + 4 + 8)
                     + 2 * 2 ** d * f * (n_bins + 1) * 4
                     for d in range(len(ms["hist"])))
    return {"hist_ms": sum(ms["hist"]), "hist_ms_by_level": ms["hist"],
            "split_ms": sum(ms["split"]), "route_ms": sum(ms["route"]),
            "predict_ms": sum(ms["predict"]), "hist_bytes": hist_bytes,
            "hist_bound_ms": 1e3 * hist_bytes / HBM_BYTES_PER_S}


def _forest_agreement(torch, a, b, X, y):
    """Two forests of one fit held as ``tests/test_torch_booster.py``'s
    ``assert_same_forest`` holds them: tree by tree, the same structure
    with leaf weights within ``rtol=1e-5, atol=1e-6`` and gains within
    1e-5 of the tree's largest, up to the first split that differs, which
    must be a near-tie (both candidates' gains within 1e-5 of the tree's
    largest). Then the margins within 1e-5 if no split differs, else
    the class and logloss agreement on ``(X, y)`` (:data:`GBDT_ORDER_TOL`)
    for the trees after the tie. Returns the readings and ``ok``."""
    same, first, numbers_ok = 0, None, True
    for ta, tb in zip(a.trees, b.trees):
        scale = max(1.0, float(np.abs(ta["gain"]).max()))
        diff = np.nonzero((ta["is_split"] != tb["is_split"]) | (
            ta["is_split"] & ((ta["feat"] != tb["feat"])
                              | (ta["thr"] != tb["thr"])
                              | (ta["missing_left"] != tb["missing_left"]))))[0]
        if len(diff):
            node = int(diff[0])
            gains = [float(ta["gain"][node]), float(tb["gain"][node])]
            first = {"tree": same, "node": node, "gains": gains,
                     "largest_gain": scale,
                     "near_tie": abs(gains[0] - gains[1]) <= 1e-5 * scale}
            break
        numbers_ok &= bool(
            np.allclose(tb["leaf_w"], ta["leaf_w"], rtol=1e-5, atol=1e-6)
            and np.abs(tb["gain"] - ta["gain"]).max() <= 1e-5 * scale)
        same += 1
    ma = a.predict_margin(X, device=DEVICE)
    mb = b.predict_margin(X, device="cpu")
    la, lb = _logloss(torch, ma, y), _logloss(torch, mb, y)
    out = {"identical_leading_trees": same, "trees": len(a.trees),
           "leading_trees_numbers_ok": numbers_ok,
           "first_difference": first,
           "same_class": float(((ma[:, 0] > 0) == (mb[:, 0] > 0)).mean()),
           "logloss": [la, lb], "logloss_rel": abs(la - lb) / lb,
           "max_abs_margin_diff": float(np.abs(ma - mb).max())}
    if first is None:
        after = out["max_abs_margin_diff"] <= 1e-5
    else:
        after = (first["near_tie"]
                 and out["same_class"] >= GBDT_ORDER_TOL["same_class"]
                 and out["logloss_rel"] <= GBDT_ORDER_TOL["metric_rel"])
    out["ok"] = numbers_ok and after
    return out


def gbdt_single(torch, card):
    """Phase 29a: the single-process fit at the HIGGS shape (module
    docstring)."""
    from sparkdl_tpu_torch.xgboost import booster as B

    n = HIGGS_ROWS
    t = time.perf_counter()
    X, y, bayes = _higgs_like(torch, n)
    data_s = time.perf_counter() - t
    # the fit through booster.train: its binning timed where it runs (the
    # host's quantile edges, the card's bins), each round's end marked by
    # a callback that also scores the round's margins
    marks, losses, binning = [], [], {}

    def timed(name, fn):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            binning[name] = time.perf_counter() - t
            return out
        return run

    def on_round(rnd, margins):
        marks.append(time.perf_counter())
        losses.append(_logloss(torch, margins, y))
        marks.append(time.perf_counter())

    t = time.perf_counter()
    with _attrs(B, compute_bin_edges=timed("edges", B.compute_bin_edges),
                bin_on=timed("bins", B.bin_on)):
        bst = B.train(dict(GBDT_PARAMS), X, y, callbacks=[on_round],
                      device=DEVICE)
    fit_s = time.perf_counter() - t
    # one tree's stages on the first round's gradients (margins 0)
    binned = B.bin_on(X, bst.edges, np.nan, torch.device(DEVICE))
    binned_bytes = binned.numel() * binned.element_size()
    yt = torch.as_tensor(y, device=DEVICE)
    g = torch.full_like(yt, 0.5) - yt
    h = torch.full_like(yt, 0.25)
    stages = _tree_stage_ms(torch, binned, g, h)
    del binned, yt, g, h
    rounds_s = [marks[2 * r] - marks[2 * r - 1]
                for r in range(1, GBDT_PARAMS["n_estimators"])]
    _require(all(b < a for a, b in zip(losses, losses[1:])),
             f"phase 29a: the train logloss did not fall each round: "
             f"{losses}")
    t = time.perf_counter()
    proba = bst.predict_proba(X, device=DEVICE)
    predict_s = time.perf_counter() - t
    acc = float(((proba[:, 1] > 0.5) == (y > 0.5)).mean())
    floor = 0.5 + GBDT_FLOOR_FRACTION * (bayes - 0.5)
    _require(acc > floor, f"phase 29a: accuracy {acc} under the floor "
             f"{floor} (Bayes {bayes})")
    # the card's margins against a numpy descent of the same trees
    m = GBDT_CPU_ROWS
    t = time.perf_counter()
    host = _host_margins(bst, X[:m])
    host_s = time.perf_counter() - t
    on_card = bst.predict_margin(X[:m], device=DEVICE)[:, 0]
    _require(np.array_equal(on_card, host),
             f"phase 29a: card margins differ from the host descent in "
             f"{int((on_card != host).sum())} of {m} rows")
    # the first rows fit on the card and by the port on the CPU
    t = time.perf_counter()
    small = B.train(dict(GBDT_PARAMS), X[:m], y[:m], device=DEVICE)
    card_small_s = time.perf_counter() - t
    t = time.perf_counter()
    small_cpu = B.train(dict(GBDT_PARAMS), X[:m], y[:m], device="cpu")
    cpu_small_s = time.perf_counter() - t
    agree = _forest_agreement(torch, small, small_cpu, X[:m], y[:m])
    _require(agree["ok"], f"phase 29a: the card's fit of {m} rows against "
             f"the CPU's: {agree}")
    tree_ms = sum(stages[k] for k in ("hist_ms", "split_ms", "route_ms",
                                      "predict_ms"))
    report = {
        "phase": "29a", "rows": n, "features": HIGGS_FEATURES,
        "params": GBDT_PARAMS, "data_s": data_s,
        "host_edges_s": binning["edges"], "card_bin_s": binning["bins"],
        "binned_bytes": binned_bytes, "fit_s": fit_s,
        "round_s_median": statistics.median(rounds_s), "round_s": rounds_s,
        "train_logloss": losses, "accuracy": acc, "bayes_accuracy": bayes,
        "accuracy_floor": floor, "predict_proba_s": predict_s,
        "tree_ms": tree_ms, **stages,
        "hist_share_of_tree": stages["hist_ms"] / tree_ms,
        "hist_bytes_per_s": stages["hist_bytes"] / (stages["hist_ms"] / 1e3),
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "host_descent_rows": m, "host_descent_s": host_s,
        "host_descent_equal": True,
        "cpu_rows": m, "card_fit_s_cpu_rows": card_small_s,
        "cpu_fit_s": cpu_small_s, "card_vs_cpu": agree,
        "tolerance": GBDT_ORDER_TOL, "card": card}
    _log("gbdt_fit " + json.dumps(report))
    return report, X, y


def gbdt_digest_main(inner, **kwargs):
    """A rank of 29b's estimator gang, wrapped: the estimator's own gang
    main (``inner``, ``_fit_booster``'s) with this rank's ``booster.train``
    and ``hvd.allreduce`` observed, so that the ranks' trees' digests are
    allgathered and each all-reduce is timed; returns the estimator's
    result beside them."""
    import time as _time

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.xgboost import booster as B

    seen, calls = {}, []
    train, allreduce = B.train, hvd.allreduce

    def observed_train(*args, **kw):
        seen["booster"] = train(*args, **kw)
        return seen["booster"]

    def timed_allreduce(x, *args, **kw):
        t = _time.perf_counter()
        out = allreduce(x, *args, **kw)
        calls.append((int(np.asarray(x).nbytes), _time.perf_counter() - t))
        return out

    B.train, hvd.allreduce = observed_train, timed_allreduce
    try:
        t = _time.perf_counter()
        result = inner(**kwargs)
        fit_s = _time.perf_counter() - t
    finally:
        B.train, hvd.allreduce = train, allreduce
    return {"result": result, "calls": calls, "fit_s": fit_s,
            "rows": len(kwargs["X"]), "device": str(_state.state().device),
            "digests": hvd.allgather_object(_gbdt_digest(seen["booster"]))}


def gbdt_gang(torch, card, X, y):
    """Phase 29b: the distributed estimator on the first
    :data:`GBDT_GANG_ROWS` rows (module docstring)."""
    import pandas as pd

    import sparkdl_tpu_torch.xgboost as xgb
    from sparkdl_tpu_torch.horovod import launcher
    from sparkdl_tpu_torch.xgboost import booster as B

    n = GBDT_GANG_ROWS
    X, y = X[:n], y[:n]
    params = dict(GBDT_PARAMS, n_estimators=GBDT_GANG_ROUNDS)
    t = time.perf_counter()
    single = B.train(dict(params), X, y, device=DEVICE)
    single_s = time.perf_counter() - t
    single_acc = float((single.predict(X, device=DEVICE) == y).mean())
    pdf = pd.DataFrame({"features": list(X), "label": y})
    est_kw = {k: v for k, v in params.items() if k != "objective"}
    launch, ranks = launcher.launch_gang, {}

    def observed_launch(main, kwargs, **kw):
        # the estimator's gang (its own np, verbosity and per-rank kwargs),
        # each rank's main wrapped (its digest, its all-reduces); the
        # estimator gets its own result back
        ranks.update(launch(main=gbdt_digest_main,
                            kwargs={**kwargs, "inner": main}, **kw))
        return ranks["result"]

    with _attrs(xgb, DEVICE=None if DEVICE == "cuda" else "cpu"), \
            _launcher_settings(), _attrs(launcher, launch_gang=observed_launch):
        t = time.perf_counter()
        model = xgb.XgboostClassifier(num_workers=2, force_repartition=True,
                                      **est_kw).fit(pdf)
        est_s = time.perf_counter() - t
        with _minispark(2) as session:
            sdf = session.createDataFrame(pdf)
            t = time.perf_counter()
            out = model.transform(sdf).toPandas()
            transform_s = time.perf_counter() - t
    est_acc = float((out["prediction"].to_numpy() == y).mean())
    _require(abs(est_acc - single_acc) * 100 <= GBDT_GANG_POINTS,
             f"phase 29b: the estimator's accuracy {est_acc} against one "
             f"process's {single_acc}")
    _require(len(set(ranks["digests"])) == 1,
             f"phase 29b: the ranks built different trees: "
             f"{ranks['digests']}")
    _require(_gbdt_digest(model.get_booster()) == ranks["digests"][0],
             "phase 29b: the model's booster is not rank 0's trees")
    calls = ranks["calls"]
    per_level = [c for c in calls if c[0] > 8 * 1024]  # the histograms
    report = {
        "phase": "29b", "rows": n, "rounds": GBDT_GANG_ROUNDS, "np": 2,
        "single_fit_s": single_s, "single_accuracy": single_acc,
        "estimator_fit_s": est_s, "estimator_accuracy": est_acc,
        "points_apart": abs(est_acc - single_acc) * 100,
        "transform_rows": len(out), "minispark_transform_s": transform_s,
        "rank0_fit_s": ranks["fit_s"], "rank0_rows": ranks["rows"],
        "rank0_device": ranks["device"],
        "identical_trees": True, "digest": ranks["digests"][0],
        "allreduce_calls": len(calls),
        "hist_allreduce_levels": len(per_level),
        "hist_allreduce_bytes": sum(c[0] for c in per_level),
        "hist_allreduce_bytes_max": max(c[0] for c in per_level),
        "hist_allreduce_s": sum(c[1] for c in per_level),
        "hist_allreduce_ms_median": 1e3 * statistics.median(
            c[1] for c in per_level),
        "hist_allreduce_share_of_fit": sum(c[1] for c in per_level)
        / ranks["fit_s"], "card": card}
    _log("gbdt_gang " + json.dumps(report))
    return report


def gbdt_trial(torch, card):
    """Phase 29c: one ``perf.trial gbdt`` subprocess at gbdt_bench.py's
    full shape; its ledger line read back."""
    from sparkdl_tpu_torch.observe import perf as operf

    root = tempfile.mkdtemp(prefix="chip-smoke-29c-")
    history = os.path.join(root, "history.jsonl")
    cmd = [sys.executable, "-m", "sparkdl_tpu_torch.perf.trial", "gbdt",
           "--history", history, "--settings", "{}"]
    if DEVICE != "cuda":
        cmd += ["--device=cpu", "--config=tiny"]
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    t = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    wall_s = time.perf_counter() - t
    _require(proc.returncode == 0, f"phase 29c: the trial exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    (rec,) = operf.read_history(history)
    fit = rec["metrics"]["gbdt_fit_rows_per_sec"]
    pred = rec["metrics"]["gbdt_predict_rows_per_sec"]
    want_kind = torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu"
    _require(rec["bench"] == "gbdt_bench" and rec["device_kind"] == want_kind
             and len(fit["samples"]) == len(pred["samples"]) == 4,
             f"phase 29c: ledger line {rec}")
    report = {"phase": "29c", "rows": rec["rows"],
              "features": rec["features"], "trees": rec["trees"],
              "max_depth": rec["max_depth"], "max_bins": rec["max_bins"],
              "fit_rows_trees_per_s": fit["value"],
              "fit_samples": fit["samples"],
              "predict_rows_per_s": pred["value"],
              "predict_samples": pred["samples"],
              "warm_fit_s": rec["warm_fit_sec"],
              "train_accuracy": rec["train_accuracy"],
              "device_kind": rec["device_kind"], "wall_s": wall_s,
              "card": card}
    _log("gbdt_trial " + json.dumps(report))
    return report


def gbdt(torch, card):
    """Phase 29 (29a, 29b, 29c): none of B1-B6 may launch in it."""
    _zero_launches()
    _zero_flash()
    t = time.perf_counter()
    single, X, y = gbdt_single(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    gang = gbdt_gang(torch, card, X, y)
    del X, y
    gc.collect()
    trial = gbdt_trial(torch, card)
    launches = {**_read_launches(), **_flash_launches()}
    _require(not any(launches.values()),
             f"phase 29 launched a kernel of B1-B6: {launches}")
    report = {"single": single, "gang": gang, "trial": trial,
              "launches_b1_b6": launches, "wall_s": time.perf_counter() - t}
    _log(f"gbdt: phase 29 launched none of B1-B6 ({launches}); "
         f"{report['wall_s']:.1f} s")
    return report


def _copy_gbps(torch, host, dev, reps=3):
    """Host-to-card GB/s of ``host`` (pinned or pageable) into ``dev``,
    the median of ``reps`` timed copies."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dev.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return host.numel() * host.element_size() / statistics.median(
        times[1:]) / 1e9


class _CopyWatch:
    """While on, records each ``Tensor.to(..., non_blocking=True)`` from
    the host onto a card: the stream it was issued on (the stream the
    copy runs on) and whether its source was pinned."""

    def __init__(self, torch):
        self.torch = torch
        self.seen = []

    def __enter__(self):
        torch, seen = self.torch, self.seen
        self._to = orig = torch.Tensor.to

        def to(t, *args, **kwargs):
            out = orig(t, *args, **kwargs)
            if kwargs.get("non_blocking") and out.is_cuda and not t.is_cuda:
                seen.append((torch.cuda.current_stream(out.device).stream_id,
                             t.is_pinned()))
            return out

        torch.Tensor.to = to
        return self

    def __exit__(self, *exc):
        self.torch.Tensor.to = self._to
        return False


def prefetch_card(torch, card):
    """Phase 30a: ``prefetch_to_device(device="cuda")`` feeding a card
    step, against the serial loop; every batch bit for bit its host
    batch, the copies pinned and on a stream other than the step's."""
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.utils import data

    dev = torch.device(DEVICE)
    marks = [time.perf_counter()]
    rng = np.random.default_rng(SEED)
    pool = []
    for i in range(PF_POOL):  # a constant and a random patch: cheap
        a = np.full(PF_SHAPE, i + 0.5, np.float32)
        a[i] = rng.standard_normal(PF_SHAPE[1:], dtype=np.float32)
        pool.append(a)
    refs = [torch.from_numpy(a).to(dev) for a in pool]
    nbytes = pool[0].nbytes
    staging = torch.empty(PF_SHAPE, dtype=torch.float32, device=dev)
    pinned = torch.from_numpy(pool[0]).pin_memory()
    gbps = {"pinned": _copy_gbps(torch, pinned, staging),
            "pageable": _copy_gbps(torch, torch.from_numpy(pool[0]),
                                   staging)}
    del pinned, staging

    # the card step: bf16 matmuls of about the producer's time, then the
    # batch compared with its host batch on the card, and a scalar read
    # (as a training step reads its loss)
    w = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16) / 90.5
    for _ in range(3):
        w @ w
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        w @ w
    torch.cuda.synchronize()
    reps = max(1, round(PF_PRODUCE_S / ((time.perf_counter() - t) / 10)))
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def step(batch):
        x = batch["x"]
        y = w
        for _ in range(reps):
            y = y @ w
        bad.add_((x != refs[batch["k"] % PF_POOL]).sum())
        return float(y[0, 0].float() + x[0, 0, 0, 0])

    def produce(n):
        for k in range(n):
            time.sleep(PF_PRODUCE_S)  # the producer's fixed work
            yield {"x": pool[k % PF_POOL], "k": k}

    step({"x": refs[0], "k": 0})
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    t = time.perf_counter()
    for batch in produce(PF_BATCHES):
        step({"x": torch.from_numpy(batch["x"]).to(dev), "k": batch["k"]})
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t

    observe.TELEMETRY_DIR = tempfile.mkdtemp(prefix="phase30-")
    observe.timeline().drain()
    consumer = torch.cuda.current_stream().stream_id
    try:
        t = time.perf_counter()
        seen = 0
        with _CopyWatch(torch) as copies:
            for batch in data.prefetch_to_device(produce(PF_BATCHES),
                                                 device="cuda"):
                step(batch)
                seen += 1
        torch.cuda.synchronize()
        prefetched_s = time.perf_counter() - t
        waits = [e["dur"] / 1e3 for e in observe.timeline().drain()
                 if e["name"] == "data.wait"
                 and e["args"].get("phase") != "prime"]
    finally:
        observe.TELEMETRY_DIR = None
        observe.timeline().drain()
    _require(seen == PF_BATCHES, f"phase 30a: {seen} of {PF_BATCHES} "
             "batches came out of prefetch_to_device")
    _require(int(bad) == 0, f"phase 30a: {int(bad)} elements of the "
             "prefetched batches differ from their host batches")
    marks.append(time.perf_counter())

    copy_streams = sorted({st for st, _ in copies.seen})
    _require(len(copies.seen) == PF_BATCHES and consumer not in copy_streams,
             f"phase 30a: {len(copies.seen)} copies on streams {copy_streams}, "
             f"the step on stream {consumer}")
    _require(all(pinned for _, pinned in copies.seen),
             "phase 30a: a prefetch copy was not from pinned memory")
    _require(prefetched_s < 2.0 * serial_s,
             f"phase 30a: the prefetched loop took {prefetched_s:.3f} s, "
             f"the serial one {serial_s:.3f} s")
    report = {"phase": "30a", "batches": PF_BATCHES, "batch_bytes": nbytes,
              "producer_s_a_batch": PF_PRODUCE_S, "step_matmuls": reps,
              "h2d_gbps": gbps, "serial_s": serial_s,
              "prefetched_s": prefetched_s,
              "prefetched_over_serial": prefetched_s / serial_s,
              "data_wait_ms_mean": statistics.mean(waits) if waits else None,
              "data_wait_spans": len(waits),
              "copy_streams": copy_streams, "consumer_stream": consumer,
              "copies_watched": len(copies.seen),
              # the pool, the copy rates and the step's calibration; then
              # the two loops
              "setup_s": marks[1] - marks[0], "loops_s": marks[2] - marks[1],
              "card": card}
    _log("prefetch " + json.dumps(report))
    del refs, w
    return report


def _long_prompt(cfg):
    """Phase 31's long prompt: LONG_PROMPT tokens drawn from its seed."""
    rng = np.random.default_rng(SEED + 31)
    return rng.integers(0, cfg.vocab_size, (LONG_PROMPT,)).astype(np.int32)


def serve_long(torch, model):
    """Phase 31a: Llama-3.1-8B (``LlamaConfig.llama31_8b``, the llama3
    RoPE rescale over its 8192-token original window) at full width on
    phase 3's int8 tensors (the engine's model takes them: no second
    quantization, no copy), a paged engine of LONG_SLOTS slots whose
    tables span LONG_CACHE_LEN positions: the LONG_PROMPT-token request
    and phase 3's first LONG_COMPANIONS requests, counters zeroed just
    before the run."""
    from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig
    from sparkdl_tpu_torch.models.serving import ContinuousBatchingEngine
    from sparkdl_tpu_torch.observe import mem

    cfg = LlamaConfig.llama31_8b(max_cache_len=LONG_CACHE_LEN, quant="int8")
    params = model.state_dict()
    # the config on no memory: the engine's model is phase 3's tensors
    engine = ContinuousBatchingEngine(
        Llama(cfg, device="meta"), params, n_slots=LONG_SLOTS, chunk=16,
        page_size=64, prefill_chunk=LONG_PREFILL_CHUNK, device=DEVICE)
    served = engine._model.state_dict()
    _require(all(served[k].data_ptr() == v.data_ptr()
                 for k, v in params.items()),
             "phase 31a: the engine copied phase 3's weights")
    prompts, budgets = _requests(model.cfg, LONG_COMPANIONS)
    prompts, budgets = [_long_prompt(cfg)] + prompts, [LONG_NEW] + budgets
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    long_rid = rids[0]

    # host clocks around the engine's own calls (each ends in a host
    # copy or a synchronize): the long request's prefill segments, and
    # each decode chunk with whether the long request is in its batch
    spent = {"long_prefill": [], "prefill": [], "decode": []}
    prefill_fn, decode_fn = engine._prefill_segment, engine._decode_chunk

    def timed_prefill(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill_fn(*a, **k)
        torch.cuda.synchronize()
        key = "long_prefill" if k.get("rid") == long_rid else "prefill"
        spent[key].append(time.perf_counter() - t)

    def timed_decode(active, tables, n, *a):
        long_in = any(s.active and s.req_id == long_rid
                      for s in engine._slots)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_fn(active, tables, n, *a)
        spent["decode"].append((time.perf_counter() - t, n, long_in))
        return out

    engine._prefill_segment, engine._decode_chunk = timed_prefill, timed_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    torch.cuda.synchronize()
    peak, reported = torch.cuda.max_memory_allocated(), mem.device_peak_bytes()
    stats = dict(engine.stats)
    _check_budgets(engine, results, rids, budgets, cfg.vocab_size, "31a")
    _require(launches.pop("quantized_matmul_int4") == 0,
             "phase 31a: the int8 run launched the int4 matmul")
    want = {"paged_attention_decode": cfg.n_layers * stats["steps"],
            "quantized_matmul": (7 * cfg.n_layers + 1)
            * (stats["steps"] + stats["prefill_segments"])}
    for name, n in launches.items():
        _require(n > 0 and n == want[name],
                 f"phase 31a: {name} {n} launches, the engine's counts "
                 f"predict {want[name]}")
    long_segments = -(-LONG_PROMPT // LONG_PREFILL_CHUNK)
    _require(len(spent["long_prefill"]) == long_segments,
             f"phase 31a: the long prompt took {len(spent['long_prefill'])}"
             f" prefill segments, want {long_segments}")
    _require(reported == peak,
             f"phase 31a: observe.mem.device_peak_bytes() {reported}, "
             f"torch.cuda.max_memory_allocated() {peak}")
    with_long = [(t, n) for t, n, long_in in spent["decode"] if long_in]
    decode_s = sum(t for t, _, _ in spent["decode"])
    decoded = sum(len(results[r]) for r in rids) - len(rids)
    report = {
        "config": "llama31_8b", "rope_scaling": list(cfg.rope_scaling),
        "max_cache_len": cfg.max_cache_len, "n_layers": cfg.n_layers,
        "n_slots": LONG_SLOTS, "page_size": 64, "chunk": 16,
        "prefill_chunk": LONG_PREFILL_CHUNK, "max_pages": engine._max_pages,
        "n_pages": engine.cfg.n_pages,
        "prompt_tokens": [len(p) for p in prompts], "budgets": budgets,
        "wall_s": wall,
        "long_prefill_s": sum(spent["long_prefill"]),
        "long_prefill_segments": len(spent["long_prefill"]),
        "long_prefill_ms_max": 1e3 * max(spent["long_prefill"]),
        "other_prefill_s": sum(spent["prefill"]),
        "decode_s": decode_s,
        "decode_ms_per_step": 1e3 * decode_s / stats["steps"],
        "decode_ms_per_step_with_long": (
            1e3 * sum(t for t, _ in with_long) / sum(n for _, n in with_long)),
        "steps_with_long": sum(n for _, n in with_long),
        "decode_tokens_per_s": decoded / decode_s,
        "peak_mem_gb": peak / 1e9, "device_peak_bytes": reported,
        "stats": stats, "launches": launches,
    }
    del engine, served
    _log("long_serving " + json.dumps(report))
    return report


def long_vs_plain(torch, model):
    """Phase 31b: the same tensors at depth 2 under 31a's config, the
    long prompt in LONG_PREFILL_CHUNK-token segments and then 4 decode
    steps through one table of all its pages, through the kernels and
    through the plain versions, each on its own cache, call by call;
    every call's logits held to phase 4's tolerance."""
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama31_8b(max_cache_len=LONG_CACHE_LEN)
    max_pages = LONG_CACHE_LEN // 64
    small = _depth2(model, decode=True, page_size=64, n_pages=max_pages + 1,
                    max_cache_len=LONG_CACHE_LEN,
                    rope_scaling=cfg.rope_scaling)
    pages = np.random.default_rng(SEED + 31).permutation(
        np.arange(1, max_pages + 1))
    tables = torch.as_tensor(pages[None], dtype=torch.int32, device=DEVICE)
    prompt = torch.as_tensor(_long_prompt(cfg)[None], device=DEVICE)
    steps = torch.as_tensor(np.random.default_rng(SEED + 32).integers(
        0, cfg.vocab_size, (4, 1, 1)), device=DEVICE)
    calls = [(prompt[:, i:i + LONG_PREFILL_CHUNK],
              torch.arange(i, min(i + LONG_PREFILL_CHUNK, LONG_PROMPT),
                           device=DEVICE)[None], f"prefill at {i}")
             for i in range(0, LONG_PROMPT, LONG_PREFILL_CHUNK)]
    calls += [(steps[i], torch.full((1, 1), LONG_PROMPT + i, device=DEVICE),
               f"decode {i + 1}") for i in range(4)]
    kernel_cache, plain_cache = small.init_cache(), small.init_cache()
    rows = []
    with torch.no_grad():
        for tokens, positions, what in calls:
            got = small(tokens, positions, tables, kernel_cache).float()
            with plain_ops():
                ref = small(tokens, positions, tables, plain_cache).float()
            rows.append(_logits_row(torch, got, ref, f"long {what}"))
            del got, ref
    del small, kernel_cache, plain_cache
    prefill = rows[:-4]
    report = {
        "n_layers": 2, "segments": len(prefill),
        "worst_prefill": max(prefill, key=lambda r: r["max_abs_err"]
                             / r["logit_scale"]),
        "prefill_argmax_agree_min": min(r["argmax_agree"] for r in prefill),
        "decode": rows[-4:],
    }
    _log("long_vs_plain " + json.dumps(report))
    return report


def _versions():
    import importlib.metadata

    found = {}
    for pkg in ("tensorflow", "keras"):
        try:
            found[pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            found[pkg] = None
    return found


def frameworks_main(device):
    """Phase 30b and 30c inside ``HorovodRunner(np=-1)``: the port's
    interop and hvd on card tensors, then the framework shims through
    ``importlib`` (the names a main imports)."""
    import importlib

    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.utils import interop

    hvd.init()
    out = {"frameworks": _versions()}
    host = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    tmpl = torch.zeros(1, dtype=torch.bfloat16, device=device)
    back = interop.from_numpy_like(host, tmpl)
    f32 = torch.arange(6, dtype=torch.float32, device=device)
    bf = torch.full((5,), 1.5, dtype=torch.bfloat16, device=device)
    red = hvd.allreduce(f32)
    grouped = hvd.grouped_allreduce([f32, bf, f32[:2]])
    out["interop"] = {
        "from_numpy_like": [str(back.device), str(back.dtype)],
        "exact": bool(torch.equal(back.cpu(), torch.from_numpy(host).to(
            torch.bfloat16))),
        "allreduce": [str(red.device), str(red.dtype),
                      bool(torch.equal(red, f32))],
        "grouped": [[str(g.device), str(g.dtype), bool(torch.equal(g, x))]
                    for g, x in zip(grouped, [f32, bf, f32[:2]])]}

    refused = {}
    for name, pkg in (("horovod.tensorflow", "tensorflow"),
                      ("horovod.keras", "keras")):
        if out["frameworks"][pkg] is not None:
            refused[name] = None
            continue
        try:
            importlib.import_module(name)
            refused[name] = "imported"
        except ImportError as e:
            refused[name] = str(e)
    out["refused"] = refused
    if out["frameworks"]["keras"] is not None:
        out["keras"] = keras_mnist(device)
    return out


def keras_mnist(device):
    """BASELINE config 1's MNIST CNN (examples/tf_keras_mnist.py's
    layers) on Keras's torch backend through ``horovod.keras``."""
    import importlib

    os.environ["KERAS_BACKEND"] = "torch"
    hvd = importlib.import_module("horovod.keras")
    import keras

    rng = np.random.RandomState(hvd.rank())
    x = rng.rand(KERAS_ROWS, 28, 28, 1).astype("float32")
    y = rng.randint(0, 10, KERAS_ROWS)
    keras.utils.set_random_seed(SEED)
    model = keras.Sequential([
        keras.Input((28, 28, 1)),
        keras.layers.Conv2D(32, 3, activation="relu"),
        keras.layers.Conv2D(64, 3, activation="relu"),
        keras.layers.MaxPooling2D(2),
        keras.layers.Flatten(),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dense(10),
    ])
    model.compile(
        optimizer=hvd.DistributedOptimizer(
            keras.optimizers.SGD(0.05 * hvd.size())),
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True))
    with _StdoutCopy() as log:
        t = time.perf_counter()
        hist = model.fit(x, y, batch_size=KERAS_BATCH, epochs=KERAS_EPOCHS,
                         verbose=0, shuffle=False, callbacks=[
                             hvd.callbacks.BroadcastGlobalVariablesCallback(0),
                             hvd.LogCallback()])
        wall = time.perf_counter() - t
    steps = KERAS_EPOCHS * (KERAS_ROWS // KERAS_BATCH)
    return {"backend": keras.backend.backend(),
            "devices": sorted({str(v.value.device) for v in model.weights}),
            "losses": [float(v) for v in hist.history["loss"]],
            "lines": [ln for ln in log.seen().splitlines()
                      if ln.startswith("Epoch ")],
            "ms_a_step": 1e3 * wall / steps, "steps": steps}


def frameworks(torch, card):
    """Phase 30 (30a, 30b, 30c) in this process: none of B1-B6 may
    launch in it."""
    from sparkdl_tpu_torch import HorovodRunner

    _zero_launches()
    _zero_flash()
    t = time.perf_counter()
    pf = prefetch_card(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    t_bc = time.perf_counter()
    got = HorovodRunner(np=-1).run(frameworks_main, device=DEVICE)
    got["run_s"] = time.perf_counter() - t_bc
    _log("frameworks " + json.dumps(got["frameworks"]))
    ip = got["interop"]
    _require(ip["from_numpy_like"][0].startswith(DEVICE)
             and ip["from_numpy_like"][1] == "torch.bfloat16" and ip["exact"],
             f"phase 30b: from_numpy_like gave {ip}")
    _require(ip["allreduce"][0].startswith(DEVICE) and ip["allreduce"][2]
             and all(g[0].startswith(DEVICE) and g[2]
                     for g in ip["grouped"])
             and [g[1] for g in ip["grouped"]] == [
                 "torch.float32", "torch.bfloat16", "torch.float32"],
             f"phase 30b: hvd on card tensors left the card: {ip}")
    for name, pkg in (("horovod.tensorflow", "tensorflow"),
                      ("horovod.keras", "keras")):
        msg = got["refused"][name]
        _require(msg is None or f"{name} needs the {pkg} package" in msg,
                 f"phase 30c: {name} without {pkg}: {msg}")
    keras_run = got.get("keras")
    if keras_run is not None:
        losses = keras_run["losses"]
        _require(keras_run["backend"] == "torch"
                 and all(d.startswith(DEVICE) for d in keras_run["devices"]),
                 f"phase 30c: Keras on {keras_run['backend']}, variables on "
                 f"{keras_run['devices']}")
        _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                 f"phase 30c: the MNIST CNN's losses {losses}")
        _require(any(ln.startswith("Epoch 0 begin")
                     for ln in keras_run["lines"])
                 and any(ln.startswith(f"Epoch {KERAS_EPOCHS - 1} end")
                         for ln in keras_run["lines"]),
                 f"phase 30c: the LogCallback's lines {keras_run['lines']}")
    launches = {**_read_launches(), **_flash_launches()}
    _require(not any(launches.values()),
             f"phase 30 launched a kernel of B1-B6: {launches}")
    report = {"prefetch": pf, **got, "launches_b1_b6": launches,
              "wall_s": time.perf_counter() - t, "card": card}
    _log("frameworks_30bc " + json.dumps(
        {k: v for k, v in report.items() if k != "prefetch"}))
    return report


def _state_marks(model):
    """Each parameter and buffer of ``model``: the tensor, its storage
    and its version counter (which every in-place write moves)."""
    return {name: (id(t), t.data_ptr(), t._version)
            for name, t in model.state_dict(keep_vars=True).items()}


def graph_lint_step(torch, model, card):
    """Phase 32a: phase 5's LoRA step on ``model`` traced by
    ``lower_train_step`` and linted, then one real step measured
    (module docstring)."""
    from sparkdl_tpu_torch.analysis import lint_lowered
    from sparkdl_tpu_torch.analysis.core import Severity
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.parallel.train import (
        global_batch,
        lower_train_step,
        make_lm_loss_fn,
        make_train_step,
    )

    cfg = model.cfg
    mask = lora_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if mask[n]]
    for p in model.parameters():
        p.grad = None
    opt = torch.optim.AdamW([p for _, p in named], lr=1e-4,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device=DEVICE)
    batch = global_batch(np.random.default_rng(SEED), cfg.vocab_size,
                         TRAIN_BATCH, TRAIN_SEQ)
    gc.collect()
    torch.cuda.synchronize()
    marks = _state_marks(model)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trace = lower_train_step(step, batch, cost_name=None)
    trace_s = time.perf_counter() - t
    torch.cuda.synchronize()
    trace_added = torch.cuda.max_memory_allocated() - held
    t = time.perf_counter()
    findings = lint_lowered(trace)
    lint_s = time.perf_counter() - t
    _require(_state_marks(model) == marks and not opt.state,
             "phase 32a: the trace changed the model or its optimizer")

    # one real step: the peak above what the process held besides the
    # step's inputs (the model's parameters and buffers)
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    other = held - trace.argument_bytes
    torch.cuda.reset_peak_memory_stats()
    _zero_flash()
    t = time.perf_counter()
    loss = step(batch)["loss"].item()
    step_s = time.perf_counter() - t
    launches = _flash_launches()
    measured = torch.cuda.max_memory_allocated() - other
    analytic = _lora_step_flops(model, named, cfg, TRAIN_BATCH * TRAIN_SEQ,
                                TRAIN_SEQ)
    events = trace.kernel_counts()
    budget = trace.static_budget_bytes()
    donation_mode = _donation_mode_cost(torch, step, batch, len(trace.ops))
    report = {
        "phase": "32a", "trace_s": trace_s, "lint_s": lint_s,
        "ops": len(trace.ops), "kernel_events": events,
        "real_step_launches": launches, "complete": trace.complete,
        "traced_flops": trace.flops, "lora_step_flops": analytic,
        "flops_ratio": trace.flops / analytic,
        "bytes_accessed": trace.bytes_accessed,
        "memory": trace.memory_stats(), "static_budget_bytes": budget,
        "measured_peak_bytes": measured, "budget_ratio": budget / measured,
        "trace_added_card_bytes": trace_added, "real_step_s": step_s,
        "donation_mode": donation_mode,
        "loss": loss, "findings": [str(f)[:240] for f in findings],
        "card": card}
    _log("graph_lint " + json.dumps(report))
    _require(trace.complete, f"phase 32a: the trace ended at {trace.stopped}")
    for kernel, name in (("B1", "flash_fwd"), ("B2", "flash_bwd_dq"),
                         ("B3", "flash_bwd_dkv")):
        _require(events.get(kernel) == launches[name] == cfg.n_layers,
                 f"phase 32a: {kernel} {events.get(kernel)} trace events, "
                 f"{launches[name]} launches in one step")
    _require(abs(trace.flops / analytic - 1) <= 0.05,
             f"phase 32a: traced {trace.flops:.4g} FLOPs against "
             f"{analytic:.4g}")
    _require(abs(budget / measured - 1) <= 0.20,
             f"phase 32a: static budget {budget} B against the step's "
             f"peak {measured} B")
    _require(trace_added < 1 << 20,
             f"phase 32a: the trace added {trace_added} B of card memory")
    _require(not any(f.severity >= Severity.ERROR for f in findings),
             f"phase 32a: ERROR findings on the stock step: {findings}")
    return report


def _donation_mode_cost(torch, step, batch, n_ops):
    """The host cost of a donated step's dispatch mode
    (``analysis.fixes``) on ``step``: the step plainly, under the mode
    with a plan whose one write point no op matches (it counts every op
    to the end, as a donated step does before its last write), under the
    mode with its plan done (it only checks each op's inputs against the
    donated ones, as after the last write), and plainly again. Each
    run's seconds to return (the host's dispatch) and to its loss on the
    host; the mode's cost an op is its dispatch seconds over the plain
    runs' faster, over ``n_ops`` (the trace's ops)."""
    import weakref

    from sparkdl_tpu_torch.analysis import fixes

    card_batch = {k: torch.as_tensor(v, device=DEVICE)
                  for k, v in batch.items()}
    inputs = list(card_batch.values())
    never = fixes._Write(0, "probe", ("never", ()), 0, 0, 0, 0)
    runs = {}
    for name in ("plain", "counting", "checking", "plain_again"):
        mode = contextlib.nullcontext()
        if name == "counting":
            mode = fixes._Donating([never], inputs, cpu_run=False)
        elif name == "checking":
            mode = fixes._Donating([], inputs, cpu_run=False)
            mode.stale[id(never)] = weakref.ref(inputs[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mode:
            out = step(card_batch)
            host = time.perf_counter() - t
            loss = out["loss"].item()
        runs[name] = {"host_s": host, "s": time.perf_counter() - t,
                      "loss": loss}
    plain = min(runs["plain"]["host_s"], runs["plain_again"]["host_s"])
    return {"ops": n_ops, "runs": runs, **{
        f"{name}_us_per_op": 1e6 * (runs[name]["host_s"] - plain) / n_ops
        for name in ("counting", "checking")}}


def _diverging_step(x):
    """A 2-rank step whose rank 1 issues one more allreduce than rank 0."""
    from sparkdl_tpu_torch import hvd

    y = hvd.allreduce(x)
    if hvd.rank() == 1:
        y = hvd.allreduce(y)
    return y


def lint_refusal(torch, card):
    """Phase 32b: a launch refused for diverging collectives before any
    worker starts (module docstring)."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.analysis import preflight, register_preflight
    from sparkdl_tpu_torch.horovod import launcher

    spawned = []

    def tripwire(*a, **k):
        spawned.append(a[0] if a else None)
        raise CheckFailed("phase 32b: the launcher spawned a worker")

    refused = None
    with _attrs(preflight, ENABLED=True), \
            _attrs(launcher.subprocess, Popen=tripwire), \
            _launcher_settings():
        preflight.clear()
        register_preflight(_diverging_step,
                           torch.ones(1024, device=DEVICE),
                           mesh={"data": 2})
        t = time.perf_counter()
        try:
            HorovodRunner(np=2).run(_noop_main)
        except preflight.PreflightLintError as e:
            refused = e
        finally:
            preflight.clear()
        refused_ms = 1e3 * (time.perf_counter() - t)
    rules = sorted({f.rule_id for f in refused.findings}) if refused else []
    report = {"phase": "32b", "refused": type(refused).__name__,
              "rules": rules, "spawned": len(spawned),
              "refused_launch_ms": refused_ms,
              "finding": str(refused.findings[0])[:240] if refused else None,
              "card": card}
    _log("lint_refusal " + json.dumps(report))
    _require(refused is not None and "collective-consistency" in rules
             and not spawned,
             f"phase 32b: refused {refused!r}, rules {rules}, "
             f"{len(spawned)} spawn(s)")
    return report


# slice 26: the fix engine on a functional full-parameter step (33a)
FIX_DEPTH, FIX_SEQ, FIX_LR, FIX_MOMENTUM = 2, 2048, 1e-3, 0.9


def _functional_sgd_step(torch, model):
    """``step(params, moms, batch, lr) -> (params', moms', loss)``: SGD
    with momentum over every parameter of ``model``, written as a pure
    function (``return p - lr * m2, m2, loss``), so it returns new
    tensors of the state's shapes, and ``lr`` a Python float."""
    from sparkdl_tpu_torch.parallel.train import cross_entropy_loss

    def sgd_step(params, moms, batch, lr):
        live = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            logits = torch.func.functional_call(model, live,
                                                (batch["inputs"],))
            loss = cross_entropy_loss(logits, batch["targets"])
            grads = torch.autograd.grad(loss, list(live.values()))
        m2 = {n: FIX_MOMENTUM * moms[n] + g for n, g in zip(live, grads)}
        new = {n: params[n] - lr * m2[n] for n in params}
        return new, m2, loss.detach()

    return sgd_step


def fix_functional_step(torch, card):
    """Phase 33a: the fix engine over a functional SGD-with-momentum step
    at Llama-3-8B width, depth :data:`FIX_DEPTH`, bf16, 1 x
    :data:`FIX_SEQ` tokens (flash attention: B1-B3), ``lr`` a Python
    float (module docstring)."""
    from sparkdl_tpu_torch.analysis.fixes import fix_program, peak_bytes
    from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
    from sparkdl_tpu_torch.parallel.train import global_batch

    cfg = LlamaConfig.llama3_8b(n_layers=FIX_DEPTH, attention="flash")
    model = init_weights(Llama(cfg, device=DEVICE),
                         _seeded(torch, SEED + 33))
    params = dict(model.named_parameters())
    moms = {n: torch.zeros_like(p) for n, p in params.items()}
    host = global_batch(np.random.default_rng(SEED + 33), cfg.vocab_size, 1,
                        FIX_SEQ)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in host.items()}
    step = _functional_sgd_step(torch, model)
    n_elements = sum(p.numel() for p in params.values()) * 2 + FIX_SEQ * 2
    _zero_flash()
    t = time.perf_counter()
    res = fix_program(step, (params, moms, batch, FIX_LR), params=params,
                      name="sgd_step",
                      options={"fix_equiv_max_elements": n_elements})
    fix_s = time.perf_counter() - t
    by_action = {a.action: a for a in res.attempts}
    _require(set(by_action) == {"hoist-weak-scalar", "donate-step-buffers"}
             and all(a.verified and a.applied for a in res.attempts),
             "phase 33a: fixes " + json.dumps(
                 [(a.action, a.verified, a.degrade_reason)
                  for a in res.attempts]))
    donation = by_action["donate-step-buffers"]
    predicted = donation.fix.predicted_effect["peak_hbm_bytes_saved"]
    fixed, fixed_args = res.fn, res.example_args

    # one original step, then one fixed step (it updates the state in
    # place: both start from the same parameters), each peak reset first
    runs = {}
    for name, fn, args in (("original", step,
                            (params, moms, batch, FIX_LR)),
                           ("fixed", fixed, fixed_args)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = fn(*args)
        host = time.perf_counter() - t
        loss = float(out[2])
        runs[name] = {"s": time.perf_counter() - t, "host_s": host,
                      "loss": loss,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "held_bytes": held}
        del out
    launches = _flash_launches()
    drop = runs["original"]["peak_bytes"] - runs["fixed"]["peak_bytes"]
    budget = donation.proofs["budget_delta"]["memory"]
    hoist = by_action["hoist-weak-scalar"]
    report = {
        "phase": "33a", "n_layers": cfg.n_layers, "tokens": FIX_SEQ,
        "params": sum(p.numel() for p in params.values()),
        "fix_s": fix_s, "summary": res.report["summary"],
        "hoist": hoist.fix.description, "donation": donation.fix.description,
        "proofs": {a.action: {k: {kk: vv for kk, vv in v.items()
                                  if kk != "comms"}
                              for k, v in a.proofs.items()}
                   for a in res.attempts},
        "predicted_peak_drop_bytes": predicted,
        "traced_peak_bytes": [budget["peak_bytes_before"],
                              budget["peak_bytes_after"]],
        "traced_budget_bytes": peak_bytes(res.ctx.memory_stats),
        "measured_peak_drop_bytes": drop,
        "drop_over_predicted": drop / predicted if predicted else None,
        "runs": runs, "ops": len(res.ctx.trace.ops),
        "donated_us_per_op": 1e6 * (runs["fixed"]["host_s"]
                                    - runs["original"]["host_s"])
        / len(res.ctx.trace.ops),
        "launches": launches, "card": card}
    _log("fixit_step " + json.dumps(report))
    rel = abs(runs["fixed"]["loss"] - runs["original"]["loss"])
    _require(np.isfinite(runs["original"]["loss"])
             and rel <= 2.0 ** -10 * abs(runs["original"]["loss"]),
             f"phase 33a: losses {runs}")
    _require(predicted > 0 and abs(drop - predicted) <= 0.10 * predicted,
             f"phase 33a: the peak fell {drop} B, the report predicted "
             f"{predicted} B")
    if DEVICE == "cuda":
        # the trace launches nothing: 2 proof runs a fix, then 2 steps
        want = cfg.n_layers * 6
        _require(all(n == want for n in launches.values()),
                 f"phase 33a: flash launches {launches}, want {want} each")
    del res, fixed, fixed_args, step, model, params, moms
    return report


def graft_lint(torch, card):
    """Phase 33b: ``python -m sparkdl_tpu_torch.analysis --graft 8
    --comms --fix --dry-run --fixit-out ...`` in this process: the
    port's dp+tp+sp+pp+ep step traced as the 8 ranks of its mesh on
    ``meta`` (module docstring)."""
    import collections
    import io

    from sparkdl_tpu_torch.analysis import __main__ as cli

    root = tempfile.mkdtemp(prefix="chip-smoke-33b-")
    fixit_out = os.path.join(root, "fixit.json")
    comms_out = os.path.join(root, "comms.json")
    seen = {}
    real = cli._graft_context

    def keep(n):
        seen["ctx"], graft = real(n)
        return seen["ctx"], graft

    out = io.StringIO()
    t = time.perf_counter()
    with _attrs(cli, _graft_context=keep), contextlib.redirect_stdout(out):
        rc = cli.main(["--graft", "8", "--comms", "--comms-out", comms_out,
                       "--fix", "--dry-run", "--fixit-out", fixit_out,
                       "--format", "json"])
    seconds = time.perf_counter() - t
    doc = json.loads(out.getvalue())
    ctx = seen["ctx"]
    with open(fixit_out) as f:
        (fixit,) = json.load(f)["reports"]
    by_rule = collections.Counter(
        f"{f['rule_id']}/{f['severity']}" for f in doc["findings"])
    by_kind_axis = collections.Counter(
        f"{c.kind}/{c.axis}" for c in ctx.trace.collectives)
    report = {"phase": "33b", "rc": rc, "seconds": seconds,
              "ranks": len(ctx.traces), "ops": len(ctx.trace.ops),
              "findings_by_rule": dict(by_rule),
              "collectives_by_kind_axis": dict(by_kind_axis),
              "kernel_events": ctx.trace.kernel_counts(),
              "fixit_summary": fixit["summary"],
              "comms_totals": {k: v for k, v in
                               doc["comms_reports"][0]["totals"].items()
                               if k != "by_kind"}, "card": card}
    _log("graft_lint " + json.dumps(report))
    _require(rc == 0 and len(ctx.traces) == 8
             and all(t.complete for t in ctx.traces.values())
             and len({t.signature() for t in ctx.traces.values()}) == 1,
             f"phase 33b: rc {rc}, {len(ctx.traces)} ranks traced")
    _require(by_kind_axis["collective-permute/seq"] >= 1
             and by_kind_axis["collective-permute/model"] >= 1
             and by_kind_axis["all-reduce/data"] >= 1,
             f"phase 33b: collectives {dict(by_kind_axis)}")
    _require(not any(f["severity"] == "ERROR" for f in doc["findings"])
             and fixit["schema"] == "sparkdl_tpu.analysis.fixit_report/1",
             f"phase 33b: findings {dict(by_rule)}")
    return report


def graft_dryrun(torch, card):
    """Phase 33c: ``graft_entry.dryrun_multichip(1)``: the graft
    program's step once, in this process (local mode), on the card, its
    ring of one through the flash kernels."""
    from sparkdl_tpu_torch.graft_entry import dryrun_multichip

    _zero_flash()
    t = time.perf_counter()
    (rank,) = dryrun_multichip(1, device=None if DEVICE == "cuda"
                               else DEVICE)
    seconds = time.perf_counter() - t
    launches = _flash_launches()
    report = {"phase": "33c", "seconds": seconds, "loss": rank["loss"],
              "device": rank["device"], "launches": launches, "card": card}
    _log("graft_dryrun " + json.dumps(report))
    _require(np.isfinite(rank["loss"]) and rank["shapes_kept"]
             and rank["device"].startswith(DEVICE),
             f"phase 33c: {rank}")
    if DEVICE == "cuda":
        _require(all(n == 2 for n in launches.values()),
                 f"phase 33c: flash launches {launches}, want 2 each")
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
    use_bytecode_cache()
    from sparkdl_tpu_torch.models.llama import LlamaConfig
    from sparkdl_tpu_torch.ops import _build
    from sparkdl_tpu_torch.ops import flash_attention as fa

    # the plain versions' fp32 products are full fp32, as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = _card_line(torch)
    _log(f"card: {card}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    ptxas = start_ptxas_report()
    _timed("1", _build.build, _build.sources())
    _log(f"build: {time.perf_counter() - t:.1f} s for {_build.sources()}")
    resources = finish_ptxas_report(ptxas)
    flash_kernels = PTXAS_KERNELS["flash_attention"]
    for name, row in resources.items():
        kernel, arg = name.rstrip(">").split("<")
        if kernel in flash_kernels:
            row["dynamic_smem_bytes"] = fa._library().flash_smem_bytes(
                flash_kernels.index(kernel), int(arg))
    _log("ptxas " + json.dumps(resources))

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    timer = Timer(torch)
    qmm_rows, qmm_tp_rows, qmm_moe_rows = _timed(
        "2", check_quantized_matmul, torch, timer, gen)
    paged_row = _timed("2_paged", check_paged_attention, torch, timer, gen)
    q4_rows = _timed("2c", check_quantized_matmul_int4, torch, timer, gen)
    del timer

    cfg = LlamaConfig.llama3_8b(max_cache_len=2048, quant="int8")
    t = time.perf_counter()
    # a generator of its own: phase 13's ranks draw the same weights
    model = _timed("3_weights", random_quant_llama, torch, cfg,
                   _seeded(torch, SEED))
    _log(f"weights: {time.perf_counter() - t:.1f} s")
    serving, phase3_tokens = _timed("3", serve, torch, model)
    model_rows = _timed("4", kernel_vs_plain_model, torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    dense = _timed("10", serve_dense, torch, model, phase3_tokens)
    gc.collect()
    torch.cuda.empty_cache()
    fleet = _timed("14", serve_fleet, torch, model, serving)
    gc.collect()
    torch.cuda.empty_cache()
    # slice 17, on phase 3's int8 model: ServingTelemetry behind HTTP
    telemetry_serving = _timed("24c", serve_telemetry, torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    # slice 18, on phase 3's int8 model: a fleet on /statusz
    fleet_live = _timed("25b", fleet_statusz, torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    # slice 24, on phase 3's int8 tensors: Llama-3.1-8B past its window
    long_serving = _timed("31a", serve_long, torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    long_logits = _timed("31b", long_vs_plain, torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the ranks need the card's memory: this process holds no model.
    # slice 20: phase 13's ranks are the first gang of 27b's replica
    tp, fleet_tp = _timed("13_27b", serve_tp_fleet, torch, serving,
                          phase3_tokens)
    torch.cuda.reset_peak_memory_stats()

    cfg4 = LlamaConfig.llama3_8b(max_cache_len=2048, quant="int4",
                                 quant_group=Q4_GROUP)
    t = time.perf_counter()
    model = _timed("7_weights", random_quant_llama, torch, cfg4, gen)
    _log(f"int4 weights: {time.perf_counter() - t:.1f} s")
    http = _timed("7", serve_http, torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    prefix = _timed("7b", prefix_sharing, torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    prefix["logits"] = _timed("7b_logits", prefix_logits, torch, model)
    q4_model_rows = _timed("8", kernel_vs_plain_model, torch, model,
                           name="model_int4")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    timer = Timer(torch)
    flash_rows = _timed("2b", check_flash, torch, timer, gen)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    training, trained = _timed("5", train, torch, gen)
    gc.collect()
    torch.cuda.empty_cache()
    multi = _timed("11", serve_multi_lora, torch, trained, gen, serving)
    gc.collect()
    torch.cuda.empty_cache()
    spec = _timed("12", serve_speculative, torch, trained)
    gc.collect()
    torch.cuda.empty_cache()
    # slice 25: the graph lints over phase 5's step, in this process
    lint_step = _timed("32a", graph_lint_step, torch, trained, card)
    lint_refused = _timed("32b", lint_refusal, torch, card)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    # slice 26: the fix engine and the port's own multichip program
    fix_step = _timed("33a", fix_functional_step, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    graft = _timed("33b", graft_lint, torch, card)
    graft_run = _timed("33c", graft_dryrun, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_rows = _timed("6", kernel_vs_plain_train, torch, gen)
    gc.collect()
    torch.cuda.empty_cache()
    remat_rows = _timed("6b", remat_memory, torch, gen)
    # the gang's workers need the card's memory: the driver holds no model
    gc.collect()
    torch.cuda.empty_cache()
    gang = _timed("9a", gang_train, torch, training)
    gang_shared = _timed("9b", gang_shared_card, torch)
    gc.collect()
    torch.cuda.empty_cache()
    gang_resumed = _timed("9c", gang_resume, torch, gang)
    gc.collect()
    torch.cuda.empty_cache()
    seq = _timed("15", seq_parallel, torch)
    gc.collect()
    torch.cuda.empty_cache()
    pipe = _timed("16", pipeline, torch)
    # slice 12: this process holds no model from here on
    gc.collect()
    torch.cuda.empty_cache()
    moe_serving = _timed("17", serve_moe, torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_training = _timed("18", train_moe, torch, gen)
    gc.collect()
    torch.cuda.empty_cache()
    moe_ep = _timed("19", expert_parallel, torch)
    # slice 13: tensor-parallel training; this process holds no model
    gc.collect()
    torch.cuda.empty_cache()
    tp_training = _timed("20", tp_train, torch)
    # slice 14: ZeRO-3 training and serving; this process holds no model
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_training = _timed("21a", fsdp_train, torch)
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_serving = _timed("21b", fsdp_serve, torch)
    # slice 15: HorovodRunner on Spark, the slot registry, a remote rank
    gc.collect()
    torch.cuda.empty_cache()
    spark = _timed("22a", spark_gang, torch, gang)
    slots = _timed("22c", slot_wait, torch)
    remote = _timed("22d", remote_rank, torch)
    # slice 16: the model zoo through HorovodRunner, the HF conversion
    gc.collect()
    torch.cuda.empty_cache()
    zoo_runs = {}
    for phase, family in (("23a", "mnist"), ("23b", "resnet50"),
                          ("23c", "bert")):
        zoo_runs[phase] = _timed(phase, zoo, torch, phase, family)
        gc.collect()
        torch.cuda.empty_cache()
    hf = _timed("23d", hf_convert, torch)
    # slice 21: the autotuner's serve trials (28a), their profile applied
    # to 24a's rank and the sanitizer on its driver and rank (28b, 28c)
    gc.collect()
    torch.cuda.empty_cache()
    tuned = _timed("28a", autotune_serve, torch, card)
    # slice 17: 9a's fine-tune with the telemetry on, then a hang
    gc.collect()
    torch.cuda.empty_cache()
    telemetry = _timed("24a", telemetry_gang, torch, gang, tuned)
    refusal = _timed("28d", preflight_refusal, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    hang = _timed("24b", hang_gang, torch)
    # slice 18: 9a's fine-tune slowed down, caught, profiled and diffed
    gc.collect()
    torch.cuda.empty_cache()
    alerted = _timed("25a", alert_gang, torch)
    # slice 19: an elastic round trip of 9b's fine-tune
    gc.collect()
    torch.cuda.empty_cache()
    elastic_run = _timed("26", elastic_gang, torch)
    # slice 20: 23c's BERT-base tensor-parallel and ZeRO-3 on two ranks
    gc.collect()
    torch.cuda.empty_cache()
    bert_run = _timed("27a", bert_mesh, torch, zoo_runs["23c"])
    # slice 22: the GBDT estimators; this process holds no model
    gc.collect()
    torch.cuda.empty_cache()
    gbdt_run = _timed("29", gbdt, torch, card)
    # slice 23: the frameworks, in this process
    gc.collect()
    torch.cuda.empty_cache()
    frameworks_run = _timed("30", frameworks, torch, card)
    # 28c's cost: 24a's steps under the sanitizer beside 25a's healthy
    # steps (the same fine-tune with the telemetry on, no sanitizer)
    sanitizer_cost = {
        "phase": "28c", "on_24a_step_ms_median": telemetry["step_ms_median"],
        "off_25a_healthy_ms_median": alerted["healthy_ms_median"],
        "off_9a_step_ms_median": gang["step_ms_median"],
        "on_over_off": (telemetry["step_ms_median"]
                        / alerted["healthy_ms_median"]), "card": card}
    _log("locksan_cost " + json.dumps(sanitizer_cost))

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
        kernel_id = {"fwd": "B1", "dq": "B2", "dkv": "B3"}[kind]
        t = main_flash[kind]
        by_phase = {"5": training["launches"][name],
                    "9a": gang["launches"][name],
                    "9b": sum(r["launches"][name]
                              for r in gang_shared["ranks"]),
                    "9c": gang_resumed["launches"][name],
                    "15": seq["launches"][name],
                    "16": pipe["launches"][name],
                    "18": moe_training["launches"][name],
                    "20": tp_training["launches"][name],
                    "21a": fsdp_training["launches"][name],
                    "22a": spark["launches"][name],
                    "22c": slots["launches"][name],
                    "22d": remote["launches"][name],
                    "24a": telemetry["launches"][name],
                    "24b": hang["launches"][name],
                    "25a": alerted["launches"][name],
                    "26": elastic_run["launches"][name],
                    "33a": fix_step["launches"][name],
                    "33c": graft_run["launches"][name]}
        return {"name": name, "route": "cuda",
                "source": "sparkdl_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": f"sparkdl_tpu/ops/pallas/flash_attention.py:"
                            f"{body_line}",
                "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase,
                # kernel events of 32a's trace: no launch, none counted
                "traced_32a": lint_step["kernel_events"][kernel_id],
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

    # each serving path's own run, counters zeroed just before it
    qmm_by_phase = {"3": serving["launches"]["quantized_matmul"],
                    "10": dense["launches"]["quantized_matmul"],
                    "10_generate":
                        dense["generate"]["launches"]["quantized_matmul"],
                    "12": spec["launches"]["quantized_matmul"],
                    # phase 13 is the first burst of 27b's fleet
                    "13_27b": fleet_tp["launches"]["quantized_matmul"],
                    "27b_respawned": fleet_tp["launches_respawned"][
                        "quantized_matmul"],
                    "14_one_replica": fleet["one_replica"]["launches"][
                        "quantized_matmul"],
                    "14": fleet["launches"]["quantized_matmul"],
                    "17": moe_serving["launches"]["quantized_matmul"],
                    "21b": sum(r["launches"]["quantized_matmul"]
                               for r in fsdp_serving["ranks"]),
                    "23d": hf["launches"]["quantized_matmul"],
                    "24c_off": telemetry_serving["launches_off"][
                        "quantized_matmul"],
                    "24c": telemetry_serving["launches"][
                        "quantized_matmul"],
                    "25b": fleet_live["launches"]["quantized_matmul"],
                    "31a": long_serving["launches"]["quantized_matmul"],
                    # every trial of the autotuner's search, each its
                    # own process, counted there over its traffic
                    "28a": tuned["launches"]["quantized_matmul"]}
    paged_by_phase = {"3": serving["launches"]["paged_attention_decode"],
                      "7": http["launches"]["paged_attention_decode"],
                      "11": multi["launches"]["paged_attention_decode"],
                      "12_plain": spec["plain"]["launches"][
                          "paged_attention_decode"],
                      "13_27b": fleet_tp["launches"][
                          "paged_attention_decode"],
                      "27b_respawned": fleet_tp["launches_respawned"][
                          "paged_attention_decode"],
                      "14_one_replica": fleet["one_replica"]["launches"][
                          "paged_attention_decode"],
                      "14": fleet["launches"]["paged_attention_decode"],
                      "17": moe_serving["launches"][
                          "paged_attention_decode"],
                      "21b": sum(r["launches"]["paged_attention_decode"]
                                 for r in fsdp_serving["ranks"]),
                      "23d": hf["launches"]["paged_attention_decode"],
                      "24c_off": telemetry_serving["launches_off"][
                          "paged_attention_decode"],
                      "24c": telemetry_serving["launches"][
                          "paged_attention_decode"],
                      "25b": fleet_live["launches"][
                          "paged_attention_decode"],
                      "31a": long_serving["launches"][
                          "paged_attention_decode"],
                      "28a": tuned["launches"]["paged_attention_decode"]}
    kernels = [
        {"name": "quantized_matmul", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/quantized_matmul.cu",
         "replaces": "sparkdl_tpu/ops/pallas/quantized_matmul.py:79",
         "launches": sum(qmm_by_phase.values()),
         "launches_by_phase": qmm_by_phase,
         "max_abs_err": max(r["max_abs_err"]
                            for r in qmm_rows + qmm_tp_rows + qmm_moe_rows),
         "ms": per_step(qmm_rows, "ms"),
         "plain_ms": per_step(qmm_rows, "plain_ms"),
         "bound_ms": per_step(qmm_rows, "bound_ms"),
         "bound_by": "bytes", "library_ms": per_step(qmm_rows, "library_ms"),
         # Mixtral's head (N = 32000, fp32 x) at decode and prefill M
         "moe_head_rows": [{k: r[k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "library_ms")}
             for r in qmm_moe_rows]},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/paged_attention.cu",
         "replaces": "sparkdl_tpu/ops/pallas/paged_attention.py:46",
         "launches": sum(paged_by_phase.values()),
         "launches_by_phase": paged_by_phase,
         "max_abs_err": paged_row["max_abs_err"],
         "ms": per_step([paged_row], "ms"),
         "plain_ms": per_step([paged_row], "plain_ms"),
         "bound_ms": per_step([paged_row], "bound_ms"),
         "bound_by": paged_row["bound_by"], "library_ms": None,
         # phase 31a's decode step: the 16,000-token row in 256 pages
         "long_shape": {k: paged_row["long"][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by",
             "max_abs_err")}},
        {"name": "quantized_matmul_int4", "route": "cuda",
         "source": "sparkdl_tpu_torch/ops/csrc/quantized_matmul_int4.cu",
         "replaces": "sparkdl_tpu/ops/pallas/quantized_matmul.py:291",
         "launches": http["launches"]["quantized_matmul_int4"],
         "launches_by_phase": {"7": http["launches"][
             "quantized_matmul_int4"]},
         "max_abs_err": max(r["max_abs_err"] for r in q4_rows),
         "ms": per_step(q4_rows, "ms"),
         "plain_ms": per_step(q4_rows, "plain_ms"),
         "bound_ms": per_step(q4_rows, "bound_ms"),
         "bound_by": "bytes", "library_ms": per_step(q4_rows, "library_ms")},
        flash_line("flash_fwd", "fwd", 45),
        flash_line("flash_bwd_dq", "dq", 158),
        flash_line("flash_bwd_dkv", "dkv", 206),
    ]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"card": card, "kernels": kernels, "qmm": qmm_rows,
                       "qmm_tp": qmm_tp_rows, "qmm_moe": qmm_moe_rows,
                       "paged": paged_row, "q4mm": q4_rows,
                       "serving": serving, "model": model_rows,
                       "dense": dense, "fleet": fleet, "tp": tp,
                       "multi_lora": multi,
                       "speculative": spec,
                       "http": http, "prefix": prefix,
                       "model_int4": q4_model_rows, "flash": flash_rows,
                       "train": training, "train_vs_plain": train_rows,
                       "remat": remat_rows, "gang": gang,
                       "gang_shared": gang_shared,
                       "gang_resume": gang_resumed,
                       "seq_parallel": seq, "pipeline": pipe,
                       "moe_serving": moe_serving,
                       "moe_training": moe_training,
                       "expert_parallel": moe_ep,
                       "tp_train": tp_training,
                       "fsdp_train": fsdp_training,
                       "fsdp_serve": fsdp_serving,
                       "spark": spark, "slot_wait": slots,
                       "remote_rank": remote, "zoo": zoo_runs,
                       "hf_convert": hf,
                       "telemetry_serving": telemetry_serving,
                       "telemetry_gang": telemetry, "hang_gang": hang,
                       "fleet_statusz": fleet_live, "alert_gang": alerted,
                       "elastic_gang": elastic_run,
                       "fleet_tp": fleet_tp, "bert_mesh": bert_run,
                       "autotune": tuned, "preflight": refusal,
                       "sanitizer_cost": sanitizer_cost, "gbdt": gbdt_run,
                       "frameworks": frameworks_run,
                       "long_serving": long_serving,
                       "long_vs_plain": long_logits,
                       "graph_lint": lint_step, "lint_refusal": lint_refused,
                       "fixit_step": fix_step, "graft_lint": graft,
                       "graft_dryrun": graft_run,
                       "phase_s": PHASE_S,
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
