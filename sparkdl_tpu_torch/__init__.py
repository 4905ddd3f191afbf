"""sparkdl_tpu_torch: the PyTorch + CUDA port of ``sparkdl_tpu``.

The JAX package stays the reference; this package mirrors its paths
(``ops/``, ``models/``, ``parallel/``) and imports nothing of it. Two
slices are ported: paged, weight-only int8, continuous-batching serving
of the Llama decoder (``models.serving.ContinuousBatchingEngine``), and
single-card LoRA fine-tuning of it (``parallel.train.make_train_step``
over ``models.lora``), with hand-written CUDA kernels (``ops/csrc/``)
for the paged decode attention, the int8 matmul and flash attention
(forward, dq, dk/dv). Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
