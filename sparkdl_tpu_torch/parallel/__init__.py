"""Training of the port: the train step, the losses, the data-parallel
helpers of a HorovodRunner gang (``shard_batch``, ``replicate``), the
parallel forms of a gang's ranks (ring and ring-flash attention over a
sharded sequence, the GPipe pipeline over a ``stage`` axis) and the
dense attention oracle; the mesh of a gang (``parallel.mesh``, with the
differentiable Megatron collectives of tensor-parallel training) and the
sharding rules and helpers (``parallel.sharding``), imported by path."""

from sparkdl_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline,
    pipeline_apply,
    stage_slice,
)
from sparkdl_tpu_torch.parallel.ring_attention import (  # noqa: F401
    attention_reference,
    make_ring_attention,
    ring_flash_attention,
    ring_self_attention,
)
from sparkdl_tpu_torch.parallel.train import (  # noqa: F401
    cross_entropy_loss,
    fused_cross_entropy,
    global_batch,
    instrument_step,
    make_lm_loss_fn,
    make_train_step,
    param_count,
    replicate,
    shard_batch,
)
