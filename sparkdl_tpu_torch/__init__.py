"""sparkdl_tpu_torch: the PyTorch + CUDA port of ``sparkdl_tpu``.

The JAX package stays the reference; this package mirrors its paths
(``ops/``, ``models/``, ``parallel/``, ``observe/``) and imports nothing
of it. Three slices are ported: paged, weight-only int8 or int4,
continuous-batching serving of the Llama decoder
(``models.serving.ContinuousBatchingEngine``, with chunked prefill and
shared prefixes) behind an HTTP front-end (``models.server.
ServingFrontend``), and single-card LoRA fine-tuning of it
(``parallel.train.make_train_step`` over ``models.lora``), with
hand-written CUDA kernels (``ops/csrc/``) for the paged decode
attention, the int8 and int4 matmuls and flash attention (forward, dq,
dk/dv). Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
