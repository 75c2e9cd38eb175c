"""Optimizer and schedule of the port's training path (``repro/optim``)."""

from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm, tree_leaves
from .schedule import warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "tree_leaves", "warmup_cosine",
]
