"""Optimizer of the port (``repro.optim``): AdamW with fp32 moments."""
from . import adamw
from .adamw import clip_by_global_norm, cosine_schedule, global_norm

__all__ = ["adamw", "clip_by_global_norm", "cosine_schedule", "global_norm"]
