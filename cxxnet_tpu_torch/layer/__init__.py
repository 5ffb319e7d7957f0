"""Layers of the port (counterpart of cxxnet_tpu/layer)."""

from .extern import ExternLayer, get_extern, register_extern  # noqa: F401
