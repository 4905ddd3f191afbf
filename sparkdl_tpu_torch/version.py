"""Version of the port: the JAX package's own, from
``sparkdl_tpu/version.py``, kept here as a copy (the port imports
nothing of the JAX package)."""

__version__ = "0.1.0"
