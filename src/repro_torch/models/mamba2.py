"""Mamba-2 (SSD, state-space duality) mixer block (arXiv:2405.21060;
``repro/models/mamba2.py``).

The chunked SSD algorithm: within a chunk of ``cfg.ssm_chunk`` steps the
interactions take a quadratic, attention-like form; across chunks a
state (B, H, P, N) is carried, by a Python loop over chunks where the
reference scans.  Attention-free: decode keeps an O(1) state per slot,
the conv tail (B, K-1, C) and the SSM state (B, H, P, N) in f32.

The scan, the conv and the decode recurrence have no Pallas kernel in the
reference (they are jnp code), so plain PyTorch is their path on every
device.  The in and out projections route through ``core.analog``
(``analog_stochastic`` projects linearly, as in the reference), so an
analog training step reads the crossbar twice a layer.

Numerics kept from the reference: the conv accumulates its taps in f32 in
the reference's order and a zero ``conv_cache`` is exactly the zero pad;
the within-chunk decay is masked *before* ``exp`` (the upper triangle's
positive exponents overflow, and inf·0 would give NaN in the backward);
a sequence not divisible by the chunk is padded with identity dynamics;
``softplus`` is ``logaddexp(x, 0)``, jax's form; :func:`mamba_prefill` IS
:func:`mamba_prefill_chunk` from a zero carry (the dense-vs-paged identity
rests on it); the decode step rounds the conv output through the
activation dtype, as the prefill's is rounded; ``a_log``, ``d_skip`` and
``dt_bias`` are f32 leaves in a bf16 model.  The three-operand einsums
contract over the state (or the chunk) first and scale after, which is
the order XLA picks; ``exp`` is torch's (a few ulps from XLA's on the
CPU), so states and outputs agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.core import analog as A
from .config import ModelConfig
from .layers import dtype_of, init_rmsnorm, normal_init, randn, rmsnorm


def conv_channels(cfg: ModelConfig) -> int:
    """x, B and C all go through the causal conv."""
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int] = ()) -> dict:
    """Seeded parameters with the reference's leaves, shapes and dtypes
    (``lead`` is the stacked units' axis)."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    dt = dtype_of(cfg)
    lead = tuple(lead)
    dev = gen.device
    proj_out = 2 * di + 2 * cfg.ssm_state + h  # z, x, B, C, dt
    conv_w = randn(gen, lead + (cfg.ssm_conv, conv_channels(cfg)))

    def f32(values: torch.Tensor) -> torch.Tensor:
        return values.to(torch.float32).expand(lead + (h,)).clone()

    return {
        "in_proj": normal_init(gen, lead + (d, proj_out), d, dt),
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": torch.zeros(lead + (conv_channels(cfg),), dtype=dt, device=dev),
        "a_log": f32(torch.log(torch.linspace(1.0, 16.0, h, device=dev))),
        "d_skip": f32(torch.ones((h,), device=dev)),
        "dt_bias": f32(torch.zeros((h,), device=dev)),
        "out_norm": init_rmsnorm(di, lead, dev),
        "out_proj": normal_init(gen, lead + (di, d), di, dt),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, (di, di, n, n, cfg.ssm_nheads), dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of u (B, S, C) with taps w (K, C), accumulated
    in f32 tap by tap, then ``silu`` and rounded to u's dtype.  ``cache``
    (B, K-1, C), when given, replaces the zero left pad with the conv
    inputs preceding the chunk; a zero cache gives exactly the zero pad."""
    k = w.shape[0]
    uf = u.float()
    if cache is None:
        pad = F.pad(uf, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([cache.float(), uf], dim=1)
    s = u.shape[1]
    out = torch.zeros_like(uf)
    wf = w.float()
    for i in range(k):
        out = out + pad[:, i : i + s, :] * wf[i]
    return F.silu(out + b.float()).to(u.dtype)


def ssd_chunked(x: torch.Tensor, a_step: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence over chunks, for x (B, S, H, P) already scaled by
    dt, the per-step log-decay a_step (B, S, H), bmat and cmat (B, S, N),
    from ``h0`` (B, H, P, N) or zero.  Returns (y (B, S, H, P), the final
    state (B, H, P, N)).  A sequence not divisible by ``chunk`` is padded
    with identity dynamics (log-decay 0, zero input), which leaves the
    outputs and the final state as they are."""
    s_orig = x.shape[1]
    pad = (-s_orig) % chunk
    if pad:
        x, a_step, bmat, cmat = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                 for t in (x, a_step, bmat, cmat))
    bsz, s, nh, pd = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, nh, pd)
    ac = a_step.reshape(bsz, nc, chunk, nh)
    bc = bmat.reshape(bsz, nc, chunk, n)
    cc = cmat.reshape(bsz, nc, chunk, n)
    h = torch.zeros((bsz, nh, pd, n), dtype=torch.float32, device=x.device) if h0 is None else h0
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    neg_inf = torch.tensor(float("-inf"), dtype=ac.dtype, device=x.device)
    ys = []
    for c in range(nc):
        xi, ai, bi, ci = xc[:, c], ac[:, c], bc[:, c], cc[:, c]
        cum = torch.cumsum(ai, dim=1)                                  # (B, Q, H)
        # off-diagonal: the carried state's contribution
        y_off = torch.einsum("bqn,bhpn->bqhp", ci, h) * torch.exp(cum)[..., None]
        # within the chunk; masked BEFORE exp (the upper triangle overflows)
        diff = cum[:, :, None, :] - cum[:, None, :, :]                 # (B, Q, K, H)
        li = torch.exp(torch.where(tri, diff, neg_inf))
        scores = torch.einsum("bqn,bkn->bqk", ci, bi)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores[..., None] * li, xi)
        # h' = decay_total·h + Σ_j exp(cum_Q − cum_j) B_j x_j
        dec_last = torch.exp(cum[:, -1, :])                            # (B, H)
        dec_rest = torch.exp(cum[:, -1:, :] - cum)                     # (B, Q, H)
        h_add = torch.einsum("bqhp,bqn->bhpn", xi * dec_rest[..., None], bi)
        h = h * dec_last[:, :, None, None] + h_add
        ys.append(y_off + y_diag)
    y = torch.stack(ys, dim=1).reshape(bsz, s, nh, pd)
    return y[:, :s_orig], h


def _ssm_inputs(p: dict, conv_out: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig):
    """(x (…, H, P) f32, B, C f32, dt after softplus (…, H), log-decay) from
    the conv output and the dt branch."""
    di, n = cfg.d_inner, cfg.ssm_state
    x = conv_out[..., :di]
    bmat = conv_out[..., di : di + n].float()
    cmat = conv_out[..., di + n :].float()
    xh = x.reshape(x.shape[:-1] + (cfg.ssm_nheads, cfg.ssm_headdim)).float()
    dtf = _softplus(dt.float() + p["dt_bias"])
    log_decay = dtf * -torch.exp(p["a_log"])
    return xh, bmat, cmat, dtf, log_decay


def _gated_out(p: dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The D skip, ``y·silu(z)`` in the activation dtype, then the gated
    RMS norm; returns the out projection's input."""
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(y.shape[:-2] + (cfg.d_inner,)).to(z.dtype)
    return rmsnorm(p["out_norm"], y * F.silu(z), cfg.norm_eps)


def mamba_apply(p: dict, u: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    """The block over a whole sequence u (B, S, D), the training path's.
    In the analog modes both projections read the crossbar, ``in_proj``
    under ``k1`` and ``out_proj`` under ``k2`` (``k1, k2 = split(key)``);
    ``analog_stochastic`` projects linearly (``analog_linear``)."""
    acfg = cfg.analog
    pcfg = acfg.with_mode("analog_linear") if acfg.mode == "analog_stochastic" else acfg
    k1 = k2 = None
    if key is not None:
        k1, k2 = R.split(key)
    z, x, bmat, cmat, dt = _split_proj(A.analog_matmul(pcfg, k1, u, p["in_proj"]), cfg)
    conv_out = _causal_conv(torch.cat([x, bmat, cmat], dim=-1), p["conv_w"], p["conv_b"])
    xh, bmat, cmat, dtf, log_decay = _ssm_inputs(p, conv_out, dt, cfg)
    y, _ = ssd_chunked(xh * dtf[..., None], log_decay, bmat, cmat, cfg.ssm_chunk)
    out = A.analog_matmul(pcfg, k2, _gated_out(p, y, xh, z, cfg), p["out_proj"])
    return PX.shard(out, ("batch", "seq", "embed"))


def mamba_prefill(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """Forward that also returns the decode state: (out (B, S, D), conv
    input tail (B, K-1, C), final SSM state (B, H, P, N) f32).  It is
    :func:`mamba_prefill_chunk` from a zero carry, so the two cannot drift
    apart."""
    b = u.shape[0]
    return mamba_prefill_chunk(
        p, u,
        torch.zeros((b, cfg.ssm_conv - 1, conv_channels(cfg)), dtype=u.dtype, device=u.device),
        torch.zeros((b, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), dtype=torch.float32,
                    device=u.device),
        cfg,
    )


def mamba_prefill_chunk(p: dict, u: torch.Tensor, conv_cache: torch.Tensor,
                        state0: torch.Tensor, cfg: ModelConfig):
    """One chunk u (B, S, D) of a resumable prefill, carried in from
    ``conv_cache`` (B, K-1, C), the raw conv inputs before the chunk, and
    ``state0`` (B, H, P, N) f32.  Returns new tensors: (out (B, S, D), new
    conv tail (B, K-1, C), final SSM state (B, H, P, N))."""
    z, x, bmat, cmat, dt = _split_proj(u @ p["in_proj"].to(u.dtype), cfg)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    new_tail = torch.cat([conv_cache.to(conv_in.dtype), conv_in], dim=1)[:, -(cfg.ssm_conv - 1):]
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"], cache=conv_cache)
    xh, bmat, cmat, dtf, log_decay = _ssm_inputs(p, conv_out, dt, cfg)
    y, state = ssd_chunked(xh * dtf[..., None], log_decay, bmat, cmat, cfg.ssm_chunk,
                           h0=state0.float())
    y = _gated_out(p, y, xh, z, cfg)
    return y @ p["out_proj"].to(y.dtype), new_tail.contiguous(), state


def mamba_decode_step(p: dict, u: torch.Tensor, conv_cache: torch.Tensor, state: torch.Tensor,
                      cfg: ModelConfig):
    """One token u (B, 1, D) from the carried ``conv_cache`` (B, K-1, C) and
    ``state`` (B, H, P, N) f32; returns new tensors (out (B, 1, D),
    conv_cache', state').  The caller writes the state back in place."""
    z, x, bmat, cmat, dt = _split_proj(u[:, 0, :] @ p["in_proj"].to(u.dtype), cfg)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)                        # (B, C)
    window = torch.cat([conv_cache, conv_in[:, None, :]], dim=1)
    wf = p["conv_w"].float()
    acc = torch.zeros_like(conv_in, dtype=torch.float32)
    for k in range(window.shape[1]):
        acc = acc + window[:, k, :].float() * wf[k]
    # round through the activation dtype, as the prefill's conv output is
    conv_out = F.silu(acc + p["conv_b"].float()).to(u.dtype).float()
    xh, bmat, cmat, dtf, log_decay = _ssm_inputs(p, conv_out, dt, cfg)
    decay = torch.exp(log_decay)                                        # (B, H)
    xdt = xh * dtf[..., None]
    state = state * decay[:, :, None, None] + xdt[..., None] * bmat[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, cmat)
    y = _gated_out(p, y, xh, z, cfg)
    return (y @ p["out_proj"].to(y.dtype))[:, None, :], window[:, 1:, :], state
