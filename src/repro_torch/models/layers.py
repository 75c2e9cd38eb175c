"""Shared layers: norms, embeddings, RoPE, the MLP (``repro/models/layers.py``).

Parameters are plain dicts of tensors with the reference's leaf names and
layouts, so a parameter tree bridged from ``repro`` drops in unchanged.
Init functions draw from a caller-owned ``torch.Generator`` on the target
device (:func:`init_generator`); they give other numbers than
``jax.random`` from the same seed, which is why the tests bridge the
reference's parameters instead.  On the ``meta`` device, which has no
generator, an init builds every leaf's shape and dtype and draws nothing
(the dry run's parameter specs).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.core import analog as A
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class MetaGenerator:
    """What an init draws from on the ``meta`` device, where torch has no
    generator: :func:`randn` then allocates and draws nothing."""

    device = torch.device("meta")


def init_generator(seed: int, device: torch.device):
    """The init's generator on ``device``, seeded; a :class:`MetaGenerator`
    on ``meta``."""
    if device.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def randn(gen, shape: Sequence[int]) -> torch.Tensor:
    """f32 N(0, 1) of ``shape`` from ``gen`` on its device; on ``meta`` the
    shape alone."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)


def normal_init(gen, shape: Sequence[int], fan: int, dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/fan) drawn in f32, then cast (the reference's init rule)."""
    return (randn(gen, shape) * fan**-0.5).to(dtype)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, lead: Sequence[int], device) -> dict:
    return {"scale": torch.zeros(tuple(lead) + (d,), dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + p["scale"])).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings + logits.
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    return {"embedding": normal_init(gen, (vocab, d), d, dtype)}


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = PX.take_rows(p["embedding"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    return PX.shard(x, ("batch", "seq", "embed"))


def logits_out(
    p_emb: dict, p_head: Optional[dict], x: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    w = p_emb["embedding"].T if p_head is None else p_head["w"]
    logits = x @ w.to(x.dtype)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return PX.shard(logits, ("batch", "seq", "vocab"))


def init_lm_head(gen: torch.Generator, d: int, vocab: int, dtype) -> dict:
    return {"w": normal_init(gen, (d, vocab), d, dtype)}


# ---------------------------------------------------------------------------
# RoPE (half-split, f32 angles).
# ---------------------------------------------------------------------------


# (head_dim, theta, device) -> the frequencies, computed once per process
_ROPE_FREQS: dict = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``theta ** (-i / (head_dim/2))`` in f32, computed once per
    (head_dim, theta, device).  The base is a 0-dim CPU tensor, which a
    CUDA kernel takes by value: nothing is copied to the device, so the
    decode step can be captured as a CUDA graph.  A call made while a
    graph is being captured is not kept, since its result would exist
    only in the graph's replays."""
    dev = torch.device("cpu" if device is None else device)
    key = (head_dim, float(theta), dev)
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        half = head_dim // 2
        exps = -torch.arange(0, half, dtype=torch.float32, device=dev) / half
        freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
        if dev.type != "cuda" or not torch.cuda.is_current_stream_capturing():
            _ROPE_FREQS[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int]) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    lead = tuple(lead)
    p = {
        "w_up": normal_init(gen, lead + (d, f), d, dt),
        "w_down": normal_init(gen, lead + (f, d), f, dt),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = normal_init(gen, lead + (d, f), d, dt)
    return p


def _activation(cfg: ModelConfig):
    if cfg.mlp == "swiglu":
        return F.silu
    if cfg.mlp == "relu2":
        return lambda v: F.relu(v).square()
    return lambda v: F.gelu(v, approximate="tanh")  # geglu / gelu


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    """MLP, with RACA analog execution when ``key`` is given and the config
    is analog (keys: ``split(key)`` for up and gate, ``fold_in(k2, 7)`` for
    down, as the reference derives them).

    ``analog_stochastic``: the up and gate crossbars' comparator banks emit
    binary stochastic activations, so the comparator IS the activation and
    the gate is a binary AND (b_up·b_gate); the down projection feeds the
    residual stream through a linear readout.  ``analog_linear`` keeps the
    activation and adds quantization and noise to every matmul."""
    acfg = cfg.analog
    k1 = k2 = k3 = None
    if key is not None and acfg.mode != "digital":
        k1, k2 = R.split(key)
        k3 = R.fold_in(k2, 7)
    up = PX.shard(A.analog_matmul(acfg, k1, x, p["w_up"]), ("batch", "seq", "ffn"))
    if acfg.mode == "analog_stochastic":
        h = up
        if "w_gate" in p:
            h = h * PX.shard(A.analog_matmul(acfg, k2, x, p["w_gate"]), ("batch", "seq", "ffn"))
        down_cfg = acfg.with_mode("analog_linear")
    else:
        act = _activation(cfg)
        if "w_gate" in p:
            gate = PX.shard(A.analog_matmul(acfg, k2, x, p["w_gate"]), ("batch", "seq", "ffn"))
            h = act(gate) * up
        else:
            h = act(up)
        down_cfg = acfg
    return PX.shard(A.analog_matmul(down_cfg, k3, h, p["w_down"]), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Rematerialisation (``cfg.remat_policy``: what a unit saves for the backward).
# ---------------------------------------------------------------------------

# jax.checkpoint_policies.dots_with_no_batch_dims_saveable: a product without
# batch dimensions.  Attention's batched einsums (aten.bmm) are not such a
# product, and a custom autograd.Function (the crossbar read, the stochastic
# Sigmoid) is not a product at all: XLA sees the reference's Pallas calls so.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    # a custom Function's forward runs with grad mode off: its own products
    # (the CPU plain version's) are the Function's, not the unit's
    if func in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(policy: str, fn, *args):
    """``fn(*args)`` under the reference's ``remat_policy``: ``"full"``
    saves every activation; ``"nothing"`` saves the inputs alone and runs
    ``fn`` again in the backward; ``"dots"`` saves the outputs of its
    products without batch dimensions (``aten.mm``, ``aten.addmm``) and
    recomputes the rest.  The recompute draws the same analog noise (every
    draw is threefry on a key passed in ``args``, none comes from torch's
    generator, whose state is therefore not stashed), so no number moves;
    a kernel ``fn`` launches is launched again in the backward.  Under
    ``no_grad`` ``fn`` simply runs."""
    if policy not in ("full", "dots", "nothing"):
        raise ValueError(f"remat_policy must be 'full', 'dots' or 'nothing', got {policy!r}")
    if policy == "full" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
