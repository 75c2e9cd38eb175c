"""Optimizer, schedule and gradient compression of the port's training
path (``repro/optim``)."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm, tree_leaves,
                    tree_unflatten)
from .compress import CompressState, compress_grads, init_compress
from .schedule import warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "CompressState", "adamw_init", "adamw_update",
    "compress_grads", "global_norm", "init_compress", "tree_leaves", "tree_unflatten",
    "warmup_cosine",
]
