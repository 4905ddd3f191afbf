"""Training of the port: the train step, the losses, the data-parallel
helpers of a HorovodRunner gang (``shard_batch``, ``replicate``) and the
dense attention oracle; the mesh of a gang (``parallel.mesh``) and the
sharding rules (``parallel.sharding``) of tensor-parallel serving,
imported by path. Training under a mesh, sequence sharding and ring
attention of the JAX package's ``parallel`` are not ported yet."""

from sparkdl_tpu_torch.parallel.train import (  # noqa: F401
    cross_entropy_loss,
    fused_cross_entropy,
    global_batch,
    make_lm_loss_fn,
    make_train_step,
    param_count,
    replicate,
    shard_batch,
)
