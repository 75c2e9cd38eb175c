"""int8 gradient compression with error feedback (``repro/optim/compress.py``).

Each gradient leaf, plus the residual its last compression left, is
quantized to int8 on a per-leaf absmax grid with unbiased stochastic
rounding (the paper's programming primitive), and the new residual is
carried into the next call, so the compressed trajectory tracks the
uncompressed one.  The training step applies it to each microbatch's
gradients before they are summed: a model of a compressed cross-replica
reduction.

The rounding draws are the reference's: leaf ``i`` in jax's tree-flatten
order (:func:`repro_torch.optim.tree_leaves`) draws ``uniform(fold_in(key,
i), leaf.shape)`` with the port's threefry, in flat slices of ``CHUNK``
elements (the same bits; bounded int64 temporaries).  ``scale = max|g| /
127 + 1e-30`` is divided on the tensor's device by a 0-d tensor there,
never by a Python scalar, which CUDA would turn into a multiply by the
reciprocal; so on equal inputs the output and the residual are bit-equal
to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import random as R

from .adamw import CHUNK, tree_leaves, tree_unflatten


class CompressState(NamedTuple):
    error: dict  # error-feedback residual per leaf, f32


def init_compress(params: dict) -> CompressState:
    return CompressState(error=tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_leaves(params)
    ]))


def _quantize_leaf(g: torch.Tensor, key: R.Key) -> torch.Tensor:
    """``g`` (f32) on its stochastically rounded int8 grid, dequantized."""
    gf = g.to(torch.float32)
    scale = gf.abs().amax() / torch.full((), 127.0, device=gf.device) + 1e-30
    t = (gf / scale).reshape(-1)
    q = torch.empty_like(t)
    for a in range(0, t.numel(), CHUNK):
        b = min(a + CHUNK, t.numel())
        floor = torch.floor(t[a:b])
        bits = R.random_bits(key, (), gf.device, start=a, count=b - a)
        up = R.uniform_from_bits(bits, 0.0, 1.0) < t[a:b] - floor
        q[a:b] = torch.clamp(floor + up.to(torch.float32), -127, 127)
    return q.reshape(g.shape) * scale


def compress_grads(
    grads: dict, state: CompressState, key: Optional[R.Key]
) -> tuple[dict, CompressState]:
    """Returns (compressed grads in their own dtypes, new error state).
    With ``key=None`` the residual is added back and nothing is rounded."""
    out_g, out_e = [], []
    for i, (g, e) in enumerate(zip(tree_leaves(grads), tree_leaves(state.error))):
        corrected = g.to(torch.float32) + e
        q = corrected if key is None else _quantize_leaf(corrected, R.fold_in(key, i))
        out_g.append(q.to(g.dtype))
        out_e.append(corrected - q)
    return tree_unflatten(grads, out_g), CompressState(error=tree_unflatten(grads, out_e))
