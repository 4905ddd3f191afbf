"""Utilities of the port (``checkpoint``: train-state checkpoints)."""
