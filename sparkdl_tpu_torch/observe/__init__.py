"""Observability of the port: the serving box's metrics registry."""
