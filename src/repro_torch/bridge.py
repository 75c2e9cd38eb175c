"""Parameters and paged caches from the JAX package, as numpy arrays.

``params_from_numpy`` takes ``repro``'s parameter tree (``init_lm``'s
nested dicts, units stacked on a leading axis, or ``init_fcnn``'s flat
``{"w0", "b0", ...}``, f32 by the FCNN config's dtype) with every leaf
already a numpy array, and returns the port's tree of tensors on
``device``.  It
imports no jax: the caller converts leaves with ``np.asarray``.  Because
``torch.from_numpy`` cannot take ``ml_dtypes.bfloat16``, callers hand bf16
leaves over as float32; the bridge casts each weight back to
``cfg.dtype`` (bf16 → f32 → bf16 is lossless).  Norm scales stay f32,
as in the reference.

``paged_cache_from_numpy`` carries a paged decode cache across the same
way (pages, an int8 pool's scale planes, ``pos`` and ``quant_step``), so
tests can run both packages' layers on identical pools.

``train_state_from_numpy`` carries a training state across, of either
family: parameters (made trainable), AdamW's moments in the optimizer's
state dtype, the step counters and the threefry key data, so both
packages step from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import AdamWState, tree_leaves
from repro_torch.train import TrainState


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


def paged_cache_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """``repro``'s ``init_paged_decode_cache`` dict, leaves already numpy,
    as the port's cache on ``device``: int8 pages stay int8, float pages
    become ``cfg.dtype`` (bf16 leaves handed over as float32, as for
    params), scale planes f32, ``pos`` and ``quant_step`` int32."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        arr = np.asarray(leaf)
        if name in ("pos", "quant_step"):
            t = torch.from_numpy(np.array(arr, dtype=np.int32))
        elif arr.dtype == np.int8:
            t = torch.from_numpy(np.array(arr))
        elif name.endswith("_scale_pages"):
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
        elif name in ("k_pages", "v_pages"):
            t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype_of(cfg))
        else:
            raise KeyError(f"no paged-cache leaf {name!r} in a decoder_lm cache")
        out[name] = t.to(dev)
    return out


def train_state_from_numpy(
    params: dict, m: dict, v: dict, opt_step: int, step: int, rng,
    cfg: ModelConfig, train_cfg, device=None,
):
    """The reference's ``TrainState`` (``params``, ``opt.m``, ``opt.v``,
    ``opt.step``, ``step``, ``rng`` key data; leaves as numpy, bf16 ones
    handed over as float32) as the port's ``TrainState`` on ``device``."""
    dev = resolve_device(device)
    p = params_from_numpy(params, cfg, dev)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    sdt = getattr(torch, train_cfg.opt.state_dtype)

    def moments(tree):
        return {
            k: moments(x) if isinstance(x, dict)
            else torch.from_numpy(np.array(x, dtype=np.float32)).to(device=dev, dtype=sdt)
            for k, x in tree.items()
        }

    key = np.asarray(rng, dtype=np.uint32).reshape(-1)
    return TrainState(
        params=p, opt=AdamWState(step=int(opt_step), m=moments(m), v=moments(v)),
        compress=None, step=int(step), rng=(int(key[0]), int(key[1])),
    )
