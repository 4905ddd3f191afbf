"""sparkdl_tpu_torch: the PyTorch + CUDA port of ``sparkdl_tpu``.

The JAX package stays the reference; this package mirrors its paths
(``ops/``, ``models/``, ``parallel/``, ``observe/``, ``hvd/``,
``horovod/``, ``utils/``, ``compat/``) and imports nothing of it. Ported
so far: weight-only int8 or int4, continuous-batching serving of the
Llama decoder over a paged or a dense slot cache
(``models.serving.ContinuousBatchingEngine``, with chunked prefill,
shared prefixes and multi-LoRA adapters chosen per request), speculative
decoding (``models.serving.SpeculativeBatchingEngine``,
``models.speculative.speculative_generate``) and ``models.generate``,
behind an HTTP front-end (``models.server.ServingFrontend``) or as
replicas behind one admission-controlled front-end
(``models.fleet.FleetFrontend``), and tensor-parallel on the ranks of
a gang (``mesh=`` from ``parallel.mesh.make_mesh``); LoRA
fine-tuning of it
(``parallel.train.make_train_step`` over ``models.lora``); and the
HorovodRunner contract over ``torch.distributed`` (``HorovodRunner``,
the ``hvd`` collectives and ``hvd.DistributedOptimizer``), which runs
that fine-tuning data-parallel on a gang of workers, or
sequence-parallel (``parallel.ring_attention``: ring and ring-flash
attention, a rank a sequence shard) and stage by stage
(``parallel.pipeline``: the GPipe pipeline), with train
checkpoints (``utils.checkpoint.TrainCheckpointer``) and supervised
restarts (``horovod.supervisor``, ``horovod.restart_context``): a gang
that loses a worker is launched again and resumes from its latest
checkpoint. Hand-written CUDA
kernels (``ops/csrc/``) do the paged decode attention, the int8 and int4
matmuls and flash attention (forward, dq, dk/dv). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``;
``HorovodRunner(np>=1)`` runs one worker a card, as a Spark barrier
job under an active SparkSession or from this host, waiting while other
gangs hold its cards and starting the ranks of other hosts of a hosts
spec through a remote shell; a gang's ``import horovod.torch as hvd``
is the port's, and so are ``horovod.tensorflow``,
``horovod.tensorflow.keras``, ``horovod.keras`` (Keras 3 on its torch
backend first) and ``sparkdl.horovod.tensorflow.keras.LogCallback``
(``compat.horovod_torch``); ``utils.data.prefetch_to_device`` stages a
main's host batches onto its card.

Public surface as ``sparkdl_tpu/__init__.py``: ``HorovodRunner`` at the
package root.
"""

from sparkdl_tpu_torch.horovod.runner_base import HorovodRunner
from sparkdl_tpu_torch.version import __version__

__all__ = ["HorovodRunner", "__version__"]
