"""Training of the port: the single-card train step, the losses and the
dense attention oracle. The mesh, sharding and ring attention of the JAX
package's ``parallel`` are not ported yet."""

from sparkdl_tpu_torch.parallel.train import (  # noqa: F401
    cross_entropy_loss,
    fused_cross_entropy,
    global_batch,
    make_lm_loss_fn,
    make_train_step,
    param_count,
)
