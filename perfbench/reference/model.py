"""The decoder LM of the benchmark's configurations, plain, in float32.

A pre-norm decoder: token embedding; per layer RMSNorm (``x·rsqrt(mean
x² + eps)·(1 + scale)``), causal multi-head attention with grouped KV
heads and half-split rotary embeddings on every dimension, the output
projection and a residual add; RMSNorm and a SwiGLU MLP
(``silu(x·W_gate)·(x·W_up)·W_down``) or a mixture of SwiGLU experts, and
a residual add; a final RMSNorm and the LM head (the embedding's
transpose when tied).

The mixture of experts is GShard's capacity routing, as the configuration
states it: the router's f32 logits, their softmax, each token's top-k
experts (ties to the lower id) with the top-k probabilities renormalised
as gates.  Each call of the served model is a token group: a prefill
chunk, or one decode token.  A group of S tokens gives each expert
``C = max(int(S·k·cf/E), k)`` slots, filled by the group's assignments in
token order and then rank order; an assignment past its expert's C slots
is dropped and adds nothing.

``quant="fp8"`` computes every product of the model's (bf16) weights in
fp8 e4m3 instead, weights and inputs each scaled per tensor: the control
that a lower precision than the configuration states must fail.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm_eps: float
    rope_theta: float
    tie_embeddings: bool
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    @classmethod
    def from_config(cls, c: dict) -> "Sizes":
        """From a configuration file's keys (``perfbench/configs``).  Refuses
        an MLP other than SwiGLU and a layer kind other than global
        attention, which this reference does not implement."""
        if c["hidden_act"] != "silu":
            raise NotImplementedError(f"hidden_act {c['hidden_act']!r}: this reference has SwiGLU only")
        if tuple(c.get("layer_pattern", ("global",))) != ("global",):
            raise NotImplementedError(f"layer_pattern {c['layer_pattern']}: global attention only")
        d, h = c["hidden_size"], c["num_attention_heads"]
        return cls(
            n_layers=c["num_hidden_layers"], d_model=d, n_heads=h,
            n_kv_heads=c["num_key_value_heads"], head_dim=c.get("head_dim") or d // h,
            d_ff=c["intermediate_size"], vocab=c["vocab_size"],
            norm_eps=c.get("rms_norm_eps", c.get("norm_eps")), rope_theta=c["rope_theta"],
            tie_embeddings=c["tie_word_embeddings"], n_experts=c.get("num_local_experts", 0),
            top_k=c.get("num_experts_per_tok", 0), capacity_factor=c.get("capacity_factor", 1.25),
        )


F8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp_min(1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Mat:
    """Products by the model's weights, in f32 or in the control's fp8."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.q = quant

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        return _fp8(t) if self.q else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x) if self.q else x) @ self.w(w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh) at positions pos (S,): half-split rotation by
    ``pos·theta^(−i/(Dh/2))``."""
    half = x.shape[-1] // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                      -torch.arange(half, dtype=torch.float32) / half).to(x.device)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal attention, (S, H, Dh) queries over (S, Hkv, Dh) keys/values;
    query head i reads kv head ``i // (H / Hkv)``."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    sc = torch.einsum("shd,thd->hst", q, k) * dh**-0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~mask, -torch.inf), dim=-1)
    return torch.einsum("hst,thd->shd", p, v)


def capacity_keep(experts: torch.Tensor, groups: Sequence[tuple[int, int]], n_experts: int,
                  cf: float) -> torch.Tensor:
    """(S, k) bool: which of each token's k assignments its group keeps.
    ``groups`` are the token ranges of the calls; tokens past the last
    range are one-token groups."""
    s, k = experts.shape
    keep = torch.ones(s, k, dtype=torch.bool, device=experts.device)
    for a, b in groups:
        cap = max(int((b - a) * k * cf / n_experts), k)
        flat = experts[a:b].reshape(-1)
        onehot = F.one_hot(flat, n_experts)
        slot = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
        keep[a:b] = (slot < cap).view(b - a, k)
    return keep


def moe(p: dict, u: int, x: torch.Tensor, sz: Sizes, groups, m: _Mat) -> torch.Tensor:
    logits = x @ p["router"][u].float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, : sz.top_k], ids[:, : sz.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = gates * capacity_keep(ids, groups, sz.n_experts, sz.capacity_factor)
    out = torch.zeros_like(x)
    for e in range(sz.n_experts):
        tok, rank = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x[tok]
        y = m.mm(F.silu(m.mm(h, p["w_gate"][u, e])) * m.mm(h, p["w_up"][u, e]), p["w_down"][u, e])
        out.index_add_(0, tok, y * gates[tok, rank][:, None])
    return out


@torch.no_grad()
def logits(params: dict, sz: Sizes, tokens: Sequence[int], first: int,
           groups: Sequence[tuple[int, int]] = (), quant: Optional[str] = None) -> torch.Tensor:
    """f32 logits (len(tokens) − first, V) at positions ``first ..`` of one
    sequence, positions from 0.  ``groups``: the MoE token groups of the
    prefill calls (later tokens are one-token groups)."""
    m = _Mat(quant)
    emb = params["embed"]["embedding"]
    dev = emb.device
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(tok.numel(), device=dev)
    x = m.w(emb[tok])
    unit = params["units"]["l0"]
    s = tok.numel()
    for u in range(sz.n_layers):
        a = unit["attn"]
        h = rmsnorm(x, unit["ln1"]["scale"][u], sz.norm_eps)
        q = m.mm(h, a["wq"][u]).view(s, sz.n_heads, sz.head_dim)
        k = m.mm(h, a["wk"][u]).view(s, sz.n_kv_heads, sz.head_dim)
        v = m.mm(h, a["wv"][u]).view(s, sz.n_kv_heads, sz.head_dim)
        o = attention(rope(q, pos, sz.rope_theta), rope(k, pos, sz.rope_theta), v)
        x = x + m.mm(o.reshape(s, -1), a["wo"][u])
        h = rmsnorm(x, unit["ln2"]["scale"][u], sz.norm_eps)
        if sz.n_experts:
            x = x + moe(unit["moe"], u, h, sz, groups, m)
        else:
            f = unit["ffn"]
            x = x + m.mm(F.silu(m.mm(h, f["w_gate"][u])) * m.mm(h, f["w_up"][u]), f["w_down"][u])
    x = rmsnorm(x[first:], params["final_norm"]["scale"], sz.norm_eps)
    head = emb.T if sz.tie_embeddings else params["head"]["w"]
    return m.mm(x, head)
