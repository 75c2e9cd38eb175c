"""Kernel dispatch (``repro/kernels/ops.py``): attention (:386-512), WTA
vote counts (:316-358) and the int8 KV quantizer (:581-642).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version, and nothing else happens in between: no fallback, no
try.  The kernels return f32; callers cast to the model dtype, as the
reference does.  Seeds are uint32 values held in int64 tensors (see
``prng.py``), on the device of the data they round.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import paged_attention as PA
from . import prefill_attention as PF
from . import prng, ref
from . import stoch_round as SR
from . import wta_counts as WTA


def paged_attention(
    q: torch.Tensor,         # (B, H, Dh)
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) cache dtype or int8 codes
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (B, W) int32
    pos: torch.Tensor,       # (B,) int32
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Block-table decode attention: (B, H, Dh) f32."""
    fn = PA.paged_attention_cuda if q.is_cuda else ref.paged_attention_ref
    return fn(
        q, k_pages, v_pages, table, pos, kind=kind, local_window=local_window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale,
    )


def paged_prefill_attention(
    q: torch.Tensor,         # (S, H, Dh) one request's suffix-chunk queries
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (W,) int32 the request's block-table row
    q0: int,                 # absolute position of the first query
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prefix-aware chunked-prefill attention: (S, H, Dh) f32."""
    fn = PF.paged_prefill_attention_cuda if q.is_cuda else ref.prefill_attention_ref
    return fn(
        q, k_pages, v_pages, table, q0, kind=kind, local_window=local_window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale,
    )


# ---------------------------------------------------------------------------
# Stochastic rounding and the int8 KV quantizer.
# ---------------------------------------------------------------------------


def _seed_tensor(seed, device: torch.device) -> torch.Tensor:
    """A uint32 seed (Python int or int64 tensor) as a 1-D int64 tensor on
    ``device``; a tensor already there is used as it is (no host sync)."""
    return torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(-1)


def stoch_round_serving(
    x: torch.Tensor, seeds, *, step: float, lo: float, hi: float
) -> torch.Tensor:
    """Stochastic rounding of ``x`` (..., N) over its rows ``x.reshape(-1,
    N)``; returns f32 of ``x``'s shape.  ``seeds`` (G,) splits the rows into
    G equal groups, each drawing under its own seed with its counter
    restarting at row 0, exactly as G separate calls of the reference's
    ``stoch_round_serving`` (whose padding to 512 columns sets the counter's
    row stride)."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).to(torch.float32).contiguous()
    seeds = _seed_tensor(seeds, x.device)
    fn = SR.stoch_round_cuda if x.is_cuda else ref.stoch_round_ref
    return fn(x2d, seeds, step=step, lo=lo, hi=hi).reshape(shape)


def quantize_kv_int8(x: torch.Tensor, seeds) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization with unbiased stochastic
    rounding: ``x`` (..., Dh) → (codes int8 (..., Dh), scale f32 (...,)),
    ``scale = max(max|x|, 1e-6)`` and codes ≈ ``x / scale · 127``.  ``seeds``
    as in :func:`stoch_round_serving`."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6)
    t = xf / scale[..., None] * 127.0   # a divide, then a multiply, as the reference
    q = stoch_round_serving(t, seeds, step=1.0, lo=-127.0, hi=127.0)
    return q.to(torch.int8), scale


def quantize_kv_pair_int8(k: torch.Tensor, v: torch.Tensor, seeds):
    """Quantize a K/V pair from one seed (per row group), the v stream's
    seed offset by the golden-ratio constant so k and v never share
    rounding draws.  Returns (k_codes, k_scale, v_codes, v_scale)."""
    seeds = _seed_tensor(seeds, k.device)
    k8, ks = quantize_kv_int8(k, seeds)
    v8, vs = quantize_kv_int8(v, (seeds + prng.GOLDEN) & prng.MASK)
    return k8, ks, v8, vs


# ---------------------------------------------------------------------------
# WTA vote counts.
# ---------------------------------------------------------------------------


def wta_counts(
    z: torch.Tensor, seed, *, n_trials: int, vth0: float, sigma_z: float
) -> torch.Tensor:
    """Winner counts over ``n_trials`` WTA trials: z (..., C) → counts
    (..., C) f32, under a uint32 ``seed``.  The counter layout is the
    reference Sim backend's (``ops.wta_counts_sim``): rows are the global
    rows of ``z.reshape(-1, C)``, the class width is padded to a multiple
    of 128, and the trial stride uses the fixed 128-row block."""
    lead, c = z.shape[:-1], z.shape[-1]
    z2d = z.reshape(-1, c).to(torch.float32).contiguous()
    seed = _seed_tensor(seed, z.device)
    fn = WTA.wta_counts_cuda if z.is_cuda else ref.wta_counts_ref
    out = fn(z2d, seed, n_trials=n_trials, vth0=vth0, sigma_z=sigma_z)
    return out.reshape(lead + (c,))
