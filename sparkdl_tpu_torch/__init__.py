"""sparkdl_tpu_torch: the PyTorch + CUDA port of ``sparkdl_tpu``.

The JAX package stays the reference; this package mirrors its paths
(``ops/``, ``models/``) and imports nothing of it. The ported slice is
paged, weight-only int8, continuous-batching serving of the Llama
decoder (``models.serving.ContinuousBatchingEngine``), with hand-written
CUDA kernels for the paged decode attention and the int8 matmul
(``ops/csrc/``). Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
