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

On a mesh the gradients and the residual are DTensors of the parameters'
placements (``launch/sharding.state_partition_specs``): each rank
quantizes its own block, on the leaf's ``max|g|`` (a max over the ranks
the leaf is split across) and with the bits the whole draw has at the
block's global flat indices, so the sharded output is the unsharded one,
block by block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import parallel as PX
from repro_torch import random as R

from .adamw import CHUNK, tree_leaves, tree_unflatten


class CompressState(NamedTuple):
    error: dict  # error-feedback residual per leaf, f32


def init_compress(params: dict) -> CompressState:
    """A zero residual per leaf, f32, placed as its parameter (a DTensor
    leaf gives a DTensor of the same placements)."""
    return CompressState(error=tree_unflatten(params, [
        torch.zeros_like(p, dtype=torch.float32, requires_grad=False) for p in tree_leaves(params)
    ]))


def _quantize_leaf(g: torch.Tensor, key: R.Key, like=None) -> torch.Tensor:
    """``g`` (f32) on its stochastically rounded int8 grid, dequantized.
    ``like`` is the leaf when ``g`` is its DTensor block's local tensor."""
    gf = g.to(torch.float32)
    amax = PX.reduce_over_shards(gf.abs().amax(), like, "max")
    scale = amax / torch.full((), 127.0, device=gf.device) + 1e-30
    t = (gf / scale).reshape(-1)
    q = torch.empty_like(t)
    blk = PX.block(like)
    for a in range(0, t.numel(), CHUNK):
        b = min(a + CHUNK, t.numel())
        floor = torch.floor(t[a:b])
        at = PX.flat_index(blk, a, b, gf.device)
        if isinstance(at, torch.Tensor):
            bits = R.random_bits(key, (), gf.device, index=at)
        else:
            bits = R.random_bits(key, (), gf.device, start=at, count=b - a)
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
        corrected = PX.local(g).to(torch.float32) + PX.local(e)
        q = corrected if key is None else _quantize_leaf(corrected, R.fold_in(key, i), g)
        out_g.append(_like(q.to(g.dtype), g))
        out_e.append(_like(corrected - q, g))
    return tree_unflatten(grads, out_g), CompressState(error=tree_unflatten(grads, out_e))


def _like(t: torch.Tensor, leaf) -> torch.Tensor:
    """A local block ``t`` as a DTensor of ``leaf``'s placements, or ``t``
    itself where ``leaf`` is a plain tensor."""
    blk = PX.block(leaf)
    if blk is None:
        return t
    return PX.place_local(t, PX.Sharding(leaf.device_mesh, tuple(leaf.placements)), blk[0])
