"""Checkpoints of the port (``repro.checkpoint``): atomic, versioned, in the
JAX package's on-disk layout."""
from . import ckpt

__all__ = ["ckpt"]
