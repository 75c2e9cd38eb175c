"""Parameters and paged caches from the JAX package, as numpy arrays.

``params_from_numpy`` takes ``repro``'s parameter tree (``init_lm``'s
nested dicts, units stacked on a leading axis, ``init_encdec``'s ``enc``
and ``dec`` stacks beside ``embed`` and ``dec_pos``, or ``init_fcnn``'s
flat ``{"w0", "b0", ...}``, f32 by the FCNN config's dtype) with every leaf
already a numpy array, and returns the port's tree of tensors on
``device``.  It
imports no jax: the caller converts leaves with ``np.asarray``.  Because
``torch.from_numpy`` cannot take ``ml_dtypes.bfloat16``, callers hand bf16
leaves over as float32; the bridge casts each weight back to
``cfg.dtype`` (bf16 → f32 → bf16 is lossless).  Norm scales, an RG-LRU
block's gate biases and decay (``ba``, ``bx``, ``lam``), a Mamba-2
mixer's ``a_log``, ``d_skip`` and ``dt_bias`` and an MoE block's
``router`` stay f32, as in the reference.

``paged_cache_from_numpy`` carries a paged decode cache across the same
way (pages, an int8 pool's scale planes, ``pos``, ``quant_step`` and a
hybrid or ssm model's state), so tests can run both packages' layers on
identical pools; ``encdec_cache_from_numpy`` carries the encoder-decoder's
dense cache (``k``, ``v``, ``ck``, ``cv``, ``pos``), so they can run both
packages' decode steps on one cache.

``train_state_from_numpy`` carries a training state across, of any
family's tree: parameters (made trainable), AdamW's moments in the optimizer's
state dtype, the step counters and the threefry key data, so both
packages step from the same state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import AdamWState, CompressState, tree_leaves
from repro_torch.train import TrainState


# leaves the reference keeps in f32 whatever the model's dtype
F32_LEAVES = ("scale", "ba", "bx", "lam", "a_log", "d_skip", "dt_bias", "router")


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
        return t.to(device=dev, dtype=torch.float32 if name in F32_LEAVES else dt)

    return conv(tree, "")


def paged_cache_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """``repro``'s ``init_paged_decode_cache`` dict, leaves already numpy,
    as the port's cache on ``device``: int8 pages stay int8, float pages
    become ``cfg.dtype`` (bf16 leaves handed over as float32, as for
    params), scale planes f32, ``pos`` and ``quant_step`` int32; a hybrid
    model's ``rec_conv`` and an ssm model's ``ssm_conv`` become
    ``cfg.dtype``, ``rec_h`` and ``ssm_state`` f32."""
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
        elif name in ("k_pages", "v_pages", "rec_conv", "ssm_conv"):
            t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype_of(cfg))
        elif name in ("rec_h", "ssm_state"):
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
        else:
            raise KeyError(f"no paged-cache leaf {name!r} in a decoder_lm, hybrid or ssm cache")
        out[name] = t.to(dev)
    return out


def encdec_cache_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """``repro``'s ``init_encdec_cache`` dict (or a prefill's or decode
    step's cache), leaves already numpy, as the port's on ``device``:
    ``k``, ``v``, ``ck``, ``cv`` in ``cfg.dtype`` (bf16 leaves handed over
    as float32), ``pos`` int32."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        arr = np.asarray(leaf)
        if name == "pos":
            t = torch.from_numpy(np.array(arr, dtype=np.int32))
        elif name in ("k", "v", "ck", "cv"):
            t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype_of(cfg))
        else:
            raise KeyError(f"no leaf {name!r} in an encdec decode cache")
        out[name] = t.to(dev)
    return out


def train_state_from_numpy(
    params: dict, m: dict, v: dict, opt_step: int, step: int, rng,
    cfg: ModelConfig, train_cfg, device=None, compress_error: Optional[dict] = None,
):
    """The reference's ``TrainState`` (``params``, ``opt.m``, ``opt.v``,
    ``opt.step``, ``step``, ``rng`` key data, and ``compress.error`` when
    it compresses; leaves as numpy, bf16 ones handed over as float32) as
    the port's ``TrainState`` on ``device``."""
    dev = resolve_device(device)
    p = params_from_numpy(params, cfg, dev)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    sdt = getattr(torch, train_cfg.opt.state_dtype)

    def tensors(tree, dtype):
        return {
            k: tensors(x, dtype) if isinstance(x, dict)
            else torch.from_numpy(np.array(x, dtype=np.float32)).to(device=dev, dtype=dtype)
            for k, x in tree.items()
        }

    key = np.asarray(rng, dtype=np.uint32).reshape(-1)
    comp = (None if compress_error is None
            else CompressState(error=tensors(compress_error, torch.float32)))
    return TrainState(
        params=p, opt=AdamWState(step=int(opt_step), m=tensors(m, sdt), v=tensors(v, sdt)),
        compress=comp, step=int(step), rng=(int(key[0]), int(key[1])),
    )
