"""Drop-in import names for the port's gangs
(:mod:`~sparkdl_tpu_torch.compat.horovod_torch`)."""
