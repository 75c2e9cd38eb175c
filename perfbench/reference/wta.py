"""The paper's WTA sampler (binary stochastic SoftMax), plain: T trials
per token; in trial t every vocabulary neuron's voltage is ``v = z + σ·n``
(``n`` jax's threefry ``normal`` at the counter ``t·V + c`` under the
request's key with its token index folded in), the neurons above
``vth0 = σ²`` fire, the highest fired wins the trial (the lowest id on a
tie), and the token is the most-voted neuron (the lowest id on a tie).

:func:`vote_gap` judges a served token by the vote, not by one trial: the
least logit error ``g`` (each logit of the program within ``g/2`` of the
reference's, under the same noise) with which the served token could win
the vote at all."""

from __future__ import annotations

import torch

from .threefry import normal_at

PROBIT_SCALE = 1.702   # σ of the calibrated comparator at β = 1, in z-units


def sigma_vth(beta: float) -> tuple[float, float]:
    sigma = PROBIT_SCALE / beta
    return sigma, sigma * sigma


@torch.no_grad()
def race(z: torch.Tensor, keys: torch.Tensor, n_trials: int, beta: float,
         served: torch.Tensor, rows_per_block: int = 8) -> dict:
    """Each trial of each row of logits ``z`` (N, V) f32 under keys (N, 2)
    int64, as (N, T) tensors: ``top`` the highest voltage, ``second`` the
    next highest (fired or not), ``win`` the winner (its id; meaningful
    where ``top`` fired), ``vs`` the voltage of the served token
    ``served`` (N,); and ``vth``."""
    n, v = z.shape
    dev = z.device
    sigma, vth = sigma_vth(beta)
    sig = torch.tensor(sigma, dtype=torch.float32, device=dev)
    idx = (torch.arange(n_trials, device=dev, dtype=torch.int64)[:, None] * v
           + torch.arange(v, device=dev, dtype=torch.int64)[None])          # (T, V)
    out = {k: torch.empty((n, n_trials), dtype=torch.float32, device=dev) for k in ("top", "second", "vs")}
    out["win"] = torch.empty((n, n_trials), dtype=torch.int64, device=dev)
    for r0 in range(0, n, rows_per_block):
        r1 = min(r0 + rows_per_block, n)
        k1 = keys[r0:r1, 0].to(dev)[:, None, None]
        k2 = keys[r0:r1, 1].to(dev)[:, None, None]
        volt = z[r0:r1, None, :].float() + normal_at(k1, k2, idx[None]) * sig   # (r, T, V)
        top, win = volt.max(dim=-1)
        s = served[r0:r1].to(dev).long()
        out["vs"][r0:r1] = volt.gather(2, s[:, None, None].expand(-1, n_trials, 1))[..., 0]
        out["second"][r0:r1] = volt.scatter_(2, win[..., None], -torch.inf).max(dim=-1).values
        out["top"][r0:r1], out["win"][r0:r1] = top, win
    out["vth"] = vth
    return out


def vote_winner(r: dict) -> torch.Tensor:
    """(N,): the token these logits elect (``r`` from :func:`race`)."""
    n, t = r["win"].shape
    v = int(r["win"].max()) + 1
    counts = torch.zeros((n, v), dtype=torch.float32, device=r["win"].device)
    counts.scatter_add_(1, r["win"], (r["top"] > r["vth"]).float())
    return counts.argmax(dim=-1)


def vote_gap(r: dict, served: torch.Tensor, rows_per_block: int = 64) -> torch.Tensor:
    """(N,): for each served token ``s``, the least ``g`` at which it could
    win the vote of a program whose voltages lie within ``g/2`` of these.

    At ``g``, ``s`` can win trial t only if its voltage lies within ``g`` of
    the trial's top and within ``g/2`` of firing; so at most ``A(g)`` trials
    vote for it.  A trial whose winner ``w`` leads the runner-up by more
    than ``g`` and fires by more than ``g/2`` is decided: it votes for
    ``w`` in every such program, so ``w`` has at least ``D_w(g)`` votes.
    ``s`` can win only if ``A(g) ≥ 1``, ``A(g) > D_x(g)`` for every
    ``x < s`` and ``A(g) ≥ D_x(g)`` for every ``x > s`` (ties go to the
    lowest id).  ``A`` grows with ``g`` and each ``D`` shrinks, so the least
    such ``g`` is one of the values where they change.  0 where ``s`` is
    the reference's choice with nothing undecided; a token that could not
    have won reads the logit error it would need."""
    s = served.to(r["win"].device).long()[:, None]                         # (N, 1)
    vth, top, second, vs, win = r["vth"], r["top"], r["second"], r["vs"], r["win"]
    gap = torch.where(win == s, torch.zeros_like(vs), top - vs)
    fire_s = 2.0 * (vth - vs)              # s fires at g ≥ this
    lead = top - second                    # decided at g < lead ...
    fire_w = 2.0 * (top - vth)             # ... and g < this
    cands = torch.cat([torch.zeros_like(gap[:, :1]), gap, fire_s, lead, fire_w], dim=1).clamp_min(0)
    out = torch.empty(s.shape[0], dtype=torch.float32, device=s.device)
    for r0 in range(0, s.shape[0], rows_per_block):
        sl = slice(r0, r0 + rows_per_block)
        g = cands[sl][:, :, None]                                              # (n, C, 1)
        a = ((gap[sl][:, None] <= g) & (fire_s[sl][:, None] <= g)).sum(-1)     # (n, C)
        dec = (lead[sl][:, None] > g) & (fire_w[sl][:, None] > g) & (win[sl] != s[sl])[:, None]
        same = (win[sl][:, :, None] == win[sl][:, None, :]).float()            # (n, T, T)
        d = torch.einsum("nct,nts->ncs", dec.float(), same)                    # votes of trial s's winner
        below = torch.where((win[sl] < s[sl])[:, None], d, 0.0).amax(-1)
        above = torch.where((win[sl] > s[sl])[:, None], d, 0.0).amax(-1)
        ok = (a >= 1) & (a > below) & (a >= above)
        out[sl] = torch.where(ok, cands[sl], torch.inf).amin(-1)
    return out
