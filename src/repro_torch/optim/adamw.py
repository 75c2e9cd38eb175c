"""AdamW with bf16 moments written by stochastic rounding
(``repro/optim/adamw.py``).

The moments are stored in ``state_dtype`` (bf16 by default) through
unbiased stochastic rounding: the f32 bit pattern plus uniform 16-bit
noise, truncated to its top 16 bits.  The noise is the reference's
``jax.random.randint(k, shape, 0, 2**16, uint32)`` under the reference's
keys (leaf ``i`` in jax's tree-flatten order draws under
``split(fold_in(rng, i))``), drawn by the port's threefry, so identical
inputs round to identical bits.

On a mesh, parameters, gradients and moments are DTensors of the
parameters' placements, and each rank updates its own block (its local
tensor, in place).  A block's rounding bits are the ones the whole draw
has at the block's global flat indices (``parallel.flat_index``), so a
sharded update rounds with the unsharded bits; :func:`global_norm` sums
each leaf's squares once over the mesh.

Memory: every leaf is updated in flat slices of ``CHUNK`` elements, and
parameters and moments are overwritten in place (the reference builds new
trees; the caller's state is consumed, as the reference's donated state
is).  So the f32 temporaries and the threefry draw's int64 temporaries
stay bounded: the stacked ``w_up`` of stablelm-3b alone holds 566 M
elements, whose int64 temporaries would take 4.5 GB each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import parallel as PX
from repro_torch import random as R

CHUNK = 1 << 25  # elements per slice of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "bfloat16"   # moment storage dtype
    stochastic_rounding: bool = True


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """The leaves of a nested dict in jax's tree-flatten order (keys
    sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(tree: dict, leaves: list) -> dict:
    """``tree``'s nested dicts with its leaves replaced by ``leaves``, in
    :func:`tree_leaves` order.  No closure that refers to itself: such a
    cycle would keep ``leaves`` (a step's gradients) alive until Python's
    cyclic collector runs."""
    return _build(tree, iter(leaves))


def _build(node: dict, it) -> dict:
    return {k: _build(node[k], it) if isinstance(node[k], dict) else next(it) for k in sorted(node)}


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def adamw_init(params: dict, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return AdamWState(step=0, m=_map(zeros, params), v=_map(zeros, params))


def _slices(n: int):
    for a in range(0, n, CHUNK):
        yield a, min(a + CHUNK, n)


def _sround(x: torch.Tensor, dt: torch.dtype, key, start=0) -> torch.Tensor:
    """Unbiased stochastic rounding f32 → ``dt``: add uniform noise below
    bf16's precision to the f32 bit pattern, then truncate.  ``x`` sits at
    the flat indices ``start`` of a leaf whose noise is drawn under
    ``key``: an int, the first of ``x.numel()`` contiguous ones, or an int64
    tensor of them (``parallel.flat_index``)."""
    if dt == torch.float32 or key is None:
        return x.to(dt)
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & R.MASK
    if isinstance(start, torch.Tensor):
        noise = R.randint(key, (), 0, 1 << 16, x.device, index=start)
    else:
        noise = R.randint(key, (), 0, 1 << 16, x.device, start=start, count=x.numel())
    rounded = (bits + noise.reshape(x.shape)) & 0xFFFF0000
    signed = rounded - ((rounded >> 31) << 32)        # uint32 → int32 value
    return signed.to(torch.int32).view(torch.float32).to(dt)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves (tree-flatten order) of each leaf's f32
    sum of squares.  A DTensor leaf's sum is its blocks' local sums added
    over the mesh axes it is split on (one all-reduce per set of such
    axes), so each leaf counts once; the result is a plain tensor."""
    sums, groups = [], {}
    for i, x in enumerate(tree_leaves(tree)):
        flat = PX.local(x).reshape(-1)
        sums.append(sum(flat[a:b].float().square().sum() for a, b in _slices(flat.numel())))
        if PX.split(x):
            groups.setdefault((id(x.device_mesh), tuple(map(str, x.placements))), []).append((i, x))
    for members in groups.values():
        vec = PX.reduce_over_shards(torch.stack([sums[i] for i, _ in members]), members[0][1])
        for j, (i, _) in enumerate(members):
            sums[i] = vec[j]
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: dict,
    grads: dict,
    state: AdamWState,
    lr_scale: float = 1.0,
    rng=None,
) -> tuple[dict, AdamWState, dict]:
    """One AdamW step over the parameter tree, in place; returns (params,
    state, metrics).  ``grads`` has ``params``' structure (any float
    dtype; on a mesh, DTensors of the parameters' placements);
    ``lr_scale`` and the bias corrections are f32 host scalars."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), max=1.0)
    dt = getattr(torch, cfg.state_dtype)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    bc1 = float(1.0 - f32(cfg.b1) ** f32(float(step)))
    bc2 = float(1.0 - f32(cfg.b2) ** f32(float(step)))
    lr = float(f32(cfg.lr) * f32(lr_scale))
    use_sr = cfg.stochastic_rounding and rng is not None

    flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v))
    for i, (p, g, m, v) in enumerate(flat):
        k1 = k2 = None
        if use_sr:
            k1, k2 = R.split(R.fold_in(rng, i))
        blk = PX.block(p)
        pv, gv, mv, vv = (PX.local(t).view(-1) for t in (p, g, m, v))
        for a, b in _slices(pv.numel()):
            at = PX.flat_index(blk, a, b, pv.device)
            gf = gv[a:b].float() * clip
            mf = cfg.b1 * mv[a:b].float() + (1 - cfg.b1) * gf
            vf = cfg.b2 * vv[a:b].float() + (1 - cfg.b2) * gf.square()
            upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            pf = pv[a:b].float()
            if p.dim() >= 2:  # decay matrices only
                upd = upd + cfg.weight_decay * pf
            pv[a:b] = (pf - lr * upd).to(p.dtype)
            mv[a:b] = _sround(mf, dt, k1, at)
            vv[a:b] = _sround(vf, dt, k2, at)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
