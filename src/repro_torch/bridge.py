"""Parameters from the JAX package, as nested dicts of numpy arrays.

``params_from_numpy`` takes ``repro``'s parameter tree (``init_lm``'s
nested dicts, units stacked on a leading axis) with every leaf already a
numpy array, and returns the port's tree of tensors on ``device``.  It
imports no jax: the caller converts leaves with ``np.asarray``.  Because
``torch.from_numpy`` cannot take ``ml_dtypes.bfloat16``, callers hand bf16
leaves over as float32; the bridge casts each weight back to
``cfg.dtype`` (bf16 → f32 → bf16 is lossless).  Norm scales stay f32,
as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig
from repro_torch.models.layers import dtype_of


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    dev = resolve_device(device)
    dt = dtype_of(cfg)

    def conv(node, name: str):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"leaf {name!r} has dtype {arr.dtype}; pass float arrays")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
        return t.to(device=dev, dtype=torch.float32 if name == "scale" else dt)

    return conv(tree, "")
