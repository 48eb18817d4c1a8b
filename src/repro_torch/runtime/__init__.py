"""Fault tolerance and elasticity of the port (``fault``)."""
from . import fault  # noqa: F401
