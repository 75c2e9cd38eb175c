"""Mixture-of-Experts FFN with GShard capacity dispatch
(``repro/models/moe.py``).

Each sequence of a (B, S, D) input is one token group.  A group's tokens
take slots in an (E, C) buffer by a cumulative count over its flat
assignments, token-major and then in rank order, so the first ``C``
assignments an expert gets are kept and the rest are dropped (the
capacity ``C = max(int(S·k·cf/E), k)``); a slot left empty points at the
zero pad row ``S``.  The experts run as batched matrix products over the
gathered tokens, and each token sums its kept experts' outputs, weighted
by its router gates.  The dispatch, the products and the combine are jnp
in the reference, with no Pallas kernel, so they are plain PyTorch here
on every device; the router's WTA race in ``analog_stochastic`` mode
runs on the card as the ``wta_sample`` kernel (``core.wta.wta_topk``).

Numerics kept from the reference: the router is an f32 product (torch's
default: TF32 off); the digital top-k is ``jax.lax.top_k``'s, equal
values to the lower index; a gate is cast to the expert output's dtype
before the product; and a token's outputs are summed in that dtype in
ascending expert id, the order of the reference's scatter-add over the
(E, C) updates.  The combine is a gather of each token's k slots, never a
scatter-add: on the card ``index_add_`` sums duplicates with atomics, in
another order on every launch.  The dispatch has fixed shapes and reads
nothing back to the host, so a decode step that holds it can be captured
as a CUDA graph; only its writes of dropped assignments collide, in the
dump column ``C`` that is cut off.

Slot buffers and the gathered tokens are expert-major, ``(E, B, C, ·)``,
the layout of the batched products; ``idx`` and ``gate_slot`` are handed
back as the reference's ``(B, E, C)``.  The reference's ``shard_map``
over a mesh's batch axes is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import parallel as PX
from repro_torch.core import analog as A
from repro_torch.core import wta
from .config import ModelConfig
from .layers import dtype_of, normal_init


def _expert_init(gen: torch.Generator, shape: tuple, fan: int, dtype) -> torch.Tensor:
    """``normal_init`` one expert matrix at a time into a stacked leaf of
    ``shape`` (..., E, a, b): the f32 draw of a whole stacked leaf would
    take four times its bf16 bytes besides (grok-1-314b's ``w_up`` holds
    1.6 G values a layer)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for m in out.view((-1,) + shape[-2:]):
        m.copy_(normal_init(gen, shape[-2:], fan, dtype))
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int] = ()) -> dict:
    """Seeded parameters with the reference's leaves, drawn in its key
    order: ``router`` (d, E) in f32 (drawn in the model's dtype, then
    widened), ``w_up`` and ``w_gate`` (E, d, f), ``w_down`` (E, f, d)
    (``lead`` is the stacked units' axis)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    lead = tuple(lead)
    p = {
        "router": normal_init(gen, lead + (d, e), d, dt).to(torch.float32),
        "w_up": _expert_init(gen, lead + (e, d, f), d, dt),
        "w_down": _expert_init(gen, lead + (e, f, d), f, dt),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = _expert_init(gen, lead + (e, d, f), d, dt)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.moe_topk * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.moe_topk)


class Dispatch(NamedTuple):
    xg: torch.Tensor          # (E, B, C, D) the slots' tokens, pad rows 0
    idx: torch.Tensor         # (B, E, C) int64 token of each slot, S if empty
    gate_slot: torch.Tensor   # (B, E, C) f32 gate of each slot, 0 if empty
    frac: Optional[torch.Tensor]  # (B, E) share of a group's tokens routed to e
    pos: torch.Tensor         # (B, S·k) slot of each assignment in its expert
    kept: torch.Tensor        # (B, S·k) bool: pos < C


def _dispatch_group(x: torch.Tensor, gates: torch.Tensor, expert_ids: torch.Tensor, cap: int,
                    cfg: ModelConfig, with_frac: bool = True) -> Dispatch:
    """Slot assignment and gather for every token group (sequence) of
    ``x`` (B, S, D) at once; ``gates`` and ``expert_ids`` (B, S, k).  An
    assignment's slot is the count of the group's earlier assignments to
    its expert (token-major, then rank); past ``cap`` it is written to the
    dump column ``cap`` and dropped."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_topk
    dev = x.device
    flat_e = expert_ids.reshape(b, t * k).long()
    onehot = (flat_e[..., None] == torch.arange(e, device=dev)).to(torch.int32)  # (B, T·k, E)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]
    kept = pos < cap
    dest = flat_e * (cap + 1) + torch.where(kept, pos, cap)
    tok = (torch.arange(t * k, device=dev) // k).expand(b, t * k)
    idx_buf = torch.full((b, e * (cap + 1)), t, dtype=torch.int64, device=dev)
    idx_buf.scatter_(1, dest, tok)
    gate_buf = torch.zeros((b, e * (cap + 1)), dtype=torch.float32, device=dev)
    gate_buf.scatter_(1, dest, gates.reshape(b, t * k).to(torch.float32))
    idx = idx_buf.view(b, e, cap + 1)[:, :, :cap]
    gate_slot = gate_buf.view(b, e, cap + 1)[:, :, :cap]
    # rows of the groups' padded tokens, flat: group g's pad row is g·(T+1)+T
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1).reshape(b * (t + 1), d)
    rows = idx + (torch.arange(b, device=dev) * (t + 1))[:, None, None]
    xg = xpad.index_select(0, rows.transpose(0, 1).reshape(-1)).view(e, b, cap, d)
    frac = None
    if with_frac:
        frac = (onehot.view(b, t, k, e).sum(2) > 0).to(torch.float32).mean(1)
    return Dispatch(xg, idx, gate_slot, frac, pos, kept)


def _experts(p: dict, xg: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's FFN over its slots, (E, B, C, D) -> (E, B, C, D):
    ``silu`` for swiglu, tanh-``gelu`` for geglu and for an ungated MLP."""
    e, b, c, d = xg.shape
    xe = PX.shard(xg, ("experts", "batch", None, "embed")).reshape(e, b * c, d)
    up = PX.shard(torch.bmm(xe, p["w_up"].to(xg.dtype)), ("experts", "batch", "ffn"))
    if "w_gate" in p:
        gt = torch.bmm(xe, p["w_gate"].to(xg.dtype))
        act = F.silu if cfg.mlp == "swiglu" else (lambda v: F.gelu(v, approximate="tanh"))
        h = act(gt) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, p["w_down"].to(h.dtype)).view(e, b, c, d)


def _combine_group(out_e: torch.Tensor, gate_slot: torch.Tensor, expert_ids: torch.Tensor,
                   pos: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """(B, S, D): each token's kept expert outputs (its slot's row of
    ``out_e`` (E, B, C, D) times the slot's ``gate_slot``, cast to
    ``out_e``'s dtype first), summed in that dtype by ascending expert id;
    a dropped assignment adds nothing.  A gather of the token's k slots, so
    the sum's order is fixed on every device, and only those k·S rows are
    scaled, not the padded buffer."""
    e, b, cap, d = out_e.shape
    t, k = expert_ids.shape[1:]
    order = torch.sort(expert_ids, dim=-1).indices   # ascending expert id
    eid = expert_ids.long().gather(2, order)
    kept = kept.view(b, t, k).gather(2, order)
    pos = pos.view(b, t, k).gather(2, order)
    cell = torch.where(kept, eid * cap + pos, 0)   # the slot in its group's (E, C)
    g = gate_slot.reshape(b, e * cap).gather(1, cell.view(b, t * k)).to(out_e.dtype)
    group = torch.arange(b, device=out_e.device)[:, None, None]
    row = torch.where(kept, (eid * b + group) * cap + pos, 0)   # the slot's row of out_e
    rows = out_e.reshape(e * b * cap, d).index_select(0, row.reshape(-1)).view(b, t, k, d)
    rows = torch.where(kept[..., None], rows * g.view(b, t, k, 1), 0)
    y = rows[:, :, 0]
    for j in range(1, k):
        y = y + rows[:, :, j]
    return y


def route(p: dict, x: torch.Tensor, cfg: ModelConfig, key=None):
    """(probs, gates, expert_ids): the softmax of the f32 router logits,
    (B, S, E); each token's k experts and normalized gates, (B, S, k).  ``analog_stochastic`` with a key races the k-winner WTA
    (``core.analog.wta_router_topk``: vote shares, which carry no
    gradient), else the top-k of the softmax."""
    k = cfg.moe_topk
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    if key is not None and cfg.analog.mode == "analog_stochastic":
        gates, expert_ids = A.wta_router_topk(cfg.analog, key, logits, k)
    else:
        gates, expert_ids = wta.top_k(probs, k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, expert_ids


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, key=None,
              with_aux: bool = True) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(output (B, S, D), aux loss) of the MoE FFN over ``x`` (B, S, D),
    each sequence one group of capacity ``_capacity(S)``.  The aux loss is
    the Switch load-balancing term ``coef·E·Σ_e frac_e·mean_prob_e`` in
    f32; ``with_aux=False`` (the serving paths, which drop it) skips it
    and returns None in its place."""
    b, s, d = x.shape
    e = cfg.n_experts
    cap = _capacity(s, cfg)
    probs, gates, expert_ids = route(p, x, cfg, key)
    # per sequence: on a mesh each rank dispatches and combines its own rows
    disp = PX.batch_local(
        lambda x, g, i: _dispatch_group(x, g, i, cap, cfg, with_frac=with_aux),
        (x, gates, expert_ids), (0, 0, 0), Dispatch(1, 0, 0, 0 if with_aux else None, 0, 0))
    out_e = _experts(p, disp.xg, cfg)
    y = PX.batch_local(_combine_group, (out_e, disp.gate_slot, expert_ids, disp.pos, disp.kept),
                       (1, 0, 0, 0, 0), 0)
    y = PX.shard(y, ("batch", "seq", "embed"))
    if not with_aux:
        return y, None
    aux = cfg.router_aux_coef * e * torch.sum(disp.frac.mean(0) * probs.mean((0, 1)))
    return y, aux
