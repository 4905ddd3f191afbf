"""Utilities of the port (``checkpoint``: train-state checkpoints;
``data``: a gang main's input; ``interop``: framework tensors)."""
