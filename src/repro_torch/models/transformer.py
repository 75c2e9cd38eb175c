"""Decoder LM stack: init, the full-sequence forward and loss of the
training path, the decode step over a dense or a paged cache, the dense
layout's monolithic prefill and the chunked paged prefill
(``repro/models/transformer.py``, the ``decoder_lm`` family, the
``moe_lm`` one: attention blocks whose MLP is a mixture of experts
(``moe.py``), the ``hybrid`` one: units that mix RG-LRU blocks,
``"rec"``, with attention, the attention-free ``ssm`` one: Mamba-2
mixers, ``"ssm"``, and the ``vlm`` one: a decoder LM whose forward, loss
and dense prefill take precomputed patch embeddings before the tokens;
its paged prefill and its decode step serve it as a token LM, as the
reference's engine does).

Parameters keep the reference's tree: units stacked on a leading
``n_units`` axis (``params["units"]["l0"]["attn"]["wq"]`` is
``(n_units, d, H*Dh)``), so a bridged JAX tree and a native one are the
same structure.  The depth loop is a Python loop over units; each unit's
leaves are views into the stacked tensors.

The paged pool is updated in place: :func:`lm_decode_step` and
:func:`lm_prefill_chunk` write K/V rows into the pool tensors they are
given (see ``attention.py`` for why the writes never collide).  So is the
dense cache (``init_decode_cache``: one ``max_len`` window per slot):
the decode step writes each slot's row at its ``pos``, and
:func:`lm_prefill` fills a cache it allocates or one it is given.  An
int8 dense cache holds nearest-rounded codes and per-(slot, position,
head) scales (``attention.quantize_kv``), the reference's deterministic
quantizer, not the paged pool's stochastic rounding.

With ``cfg.kv_cache_dtype == "int8"`` the pools hold stochastically
rounded int8 codes plus f32 scale planes.  Every write's rounding seed is
computed on the device from a device counter or from device seeds, so a
step never waits on the host for it: decode seeds from ``quant_step``
(+1 per decode step, never reset), prefill seeds from the engine's
content-derived per-block seeds, each folded with the unit and sublayer
index exactly as the reference folds them (wrapping uint32 arithmetic,
held in int64).

Recurrent sublayers keep their O(1) state per slot in two dense leaves of
every cache layout: ``rec_conv`` (nu, n_rec, B, 3, W) in the model's dtype
(the conv inputs before the next token) and ``rec_h`` (nu, n_rec, B, W) in
f32; Mamba-2 mixers in ``ssm_conv`` (nu, n_ssm, B, K-1, C) and
``ssm_state`` (nu, n_ssm, B, H, P, N) in f32.  The decode step writes them
in place, as it writes ``pos``; the chunked prefill threads them through a
one-slot ``state`` and returns new tensors, so a state the engine stashed
as a prefix snapshot is never written again.  K/V leaves count attention
sublayers only (``n_attn``), and a model without attention (mamba2) has
none at all, nor an int8 pool's ``quant_step``, as in the reference;
an int8 write's rounding seed folds in the sublayer's index in the whole
pattern, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.device import resolve_device
from repro_torch.kernels.prng import MASK, mul32
from . import attention as ATT
from . import mamba2 as M2
from . import moe as MOE
from . import rglru as RG
from .config import ModelConfig
from .layers import (
    apply_rope,
    dtype_of,
    embed,
    init_embedding,
    init_generator,
    init_lm_head,
    init_mlp,
    init_rmsnorm,
    logits_out,
    mlp_apply,
    remat,
    rmsnorm,
)

# shared-pool cache leaves (block-table addressed); everything else in a
# paged cache is dense per-slot state
PAGE_POOL_LEAVES = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")


ATTN_KINDS = ("global", "local")
# the layer kinds each family of this stack may hold in its units
_FAMILY_KINDS = {"decoder_lm": ATTN_KINDS, "moe_lm": ATTN_KINDS, "vlm": ATTN_KINDS,
                 "hybrid": ATTN_KINDS + ("rec",), "ssm": ("ssm",)}


def _check_family(cfg: ModelConfig) -> None:
    """The decoder stack runs the token LMs alone: an ``encdec`` model is
    ``encdec.py``'s, an ``fcnn`` one ``fcnn.py``'s."""
    kinds = _FAMILY_KINDS.get(cfg.family)
    if kinds is None or any(k not in kinds for k in cfg.layer_pattern):
        raise NotImplementedError(
            f"the decoder stack runs decoder_lm, moe_lm, vlm, hybrid (rec + attention) and ssm "
            f"models, got {cfg.family} {cfg.layer_pattern}"
            + ("; an encdec model is models/encdec.py's" if cfg.family == "encdec" else "")
        )


def _n_kind(cfg: ModelConfig, kinds: tuple) -> int:
    return sum(1 for k in cfg.layer_pattern if k in kinds)


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded random parameters on ``device`` (the card unless ``"cpu"``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = init_generator(seed, dev)
    dt = dtype_of(cfg)
    lead = (cfg.n_units,)
    params: dict = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt),
        "final_norm": init_rmsnorm(cfg.d_model, (), dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, cfg.d_model, cfg.vocab, dt)
    params["units"] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == "ssm":
            params["units"][f"l{i}"] = {
                "ln1": init_rmsnorm(cfg.d_model, lead, dev),
                "mixer": M2.init_mamba(gen, cfg, lead),
            }
            continue
        if kind == "rec":
            params["units"][f"l{i}"] = {
                "ln1": init_rmsnorm(cfg.d_model, lead, dev),
                "rec": RG.init_rglru_block(gen, cfg, lead),
                "ln2": init_rmsnorm(cfg.d_model, lead, dev),
                "ffn": init_mlp(gen, cfg, lead),
            }
            continue
        sub = {
            "ln1": init_rmsnorm(cfg.d_model, lead, dev),
            "attn": ATT.init_attn(gen, cfg, lead),
            "ln2": init_rmsnorm(cfg.d_model, lead, dev),
        }
        if cfg.n_experts > 0:
            sub["moe"] = MOE.init_moe(gen, cfg, lead)
        else:
            sub["ffn"] = init_mlp(gen, cfg, lead)
        if cfg.post_norms:
            sub["post_ln1"] = init_rmsnorm(cfg.d_model, lead, dev)
            sub["post_ln2"] = init_rmsnorm(cfg.d_model, lead, dev)
        params["units"][f"l{i}"] = sub
    return params


# every block's output projection: the attention's, the MLP's (an MoE
# block's experts' too), the RG-LRU block's and the Mamba-2 mixer's
BLOCK_OUTPUTS = ("wo", "w_down", "w_out", "out_proj")


def scale_block_outputs(params: dict, gain: float) -> None:
    """Every block's output projection (``BLOCK_OUTPUTS``) times ``gain``, in
    place.  recurrentgemma-2b is served so on the card and in its engine
    tests: at the plain init its tied, scaled embedding dominates the
    residual stream, and every greedy stream repeats its prompt's last
    token whatever the recurrent state holds."""
    for sub in params["units"].values():
        for blk in sub.values():
            for name in BLOCK_OUTPUTS:
                if isinstance(blk, dict) and name in blk:
                    blk[name].mul_(gain)


def unbind_units(units: dict) -> list[dict]:
    """Every unit's parameter views, from one ``unbind`` per stacked leaf:
    its backward stacks the units' gradients once, where per-unit indexing
    would add a zero-filled full-size gradient per unit."""
    if not isinstance(units, dict):
        return units.unbind(0)
    parts = {k: unbind_units(v) for k, v in units.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[u] for k, p in parts.items()} for u in range(n)]


def unit_params(units: dict, u: int) -> dict:
    """Unit ``u``'s parameter views out of the stacked tree."""
    return {
        k: unit_params(v, u) if isinstance(v, dict) else v[u]
        for k, v in units.items()
    }


# ---------------------------------------------------------------------------
# Forward (full sequence) and loss: the training path.
# ---------------------------------------------------------------------------


def _attn_block(sub: dict, x: torch.Tensor, a: torch.Tensor, cfg: ModelConfig,
                key=None, with_aux: bool = False) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Residual add of the attention output, then the norm + MLP tail (its
    analog draws under ``key``); returns (x, aux).  An MoE block's tail is
    ``moe.moe_apply`` and ``aux`` its load-balancing loss when
    ``with_aux``, else None (the serving paths drop it, as the reference's
    do); a dense MLP's ``aux`` is None.  With ``cfg.post_norms`` the
    attention output and the MLP output are each normed (``post_ln1``,
    ``post_ln2``) before their residual adds, as gemma2's blocks are."""
    if cfg.post_norms:
        a = rmsnorm(sub["post_ln1"], a, cfg.norm_eps)
    x = x + a
    h = rmsnorm(sub["ln2"], x, cfg.norm_eps)
    aux = None
    if "moe" in sub:
        f, aux = MOE.moe_apply(sub["moe"], h, cfg, key=key, with_aux=with_aux)
    else:
        f = mlp_apply(sub["ffn"], h, cfg, key=key)
    if cfg.post_norms:
        f = rmsnorm(sub["post_ln2"], f, cfg.norm_eps)
    return x + f, aux


def _rec_block(sub: dict, x: torch.Tensor, o: torch.Tensor, cfg: ModelConfig,
               key=None) -> torch.Tensor:
    """Residual add of a recurrent block's output, then the norm + MLP
    tail (its analog draws under ``key``); no post-norms, as the
    reference's ``rec`` sublayer has none."""
    x = x + o
    return x + mlp_apply(sub["ffn"], rmsnorm(sub["ln2"], x, cfg.norm_eps), cfg, key=key)


def _unit_fwd(x: torch.Tensor, up: dict, positions: torch.Tensor, cfg: ModelConfig, key):
    """One unit of ``cfg.layer_pattern``; returns (x, the unit's aux loss:
    its MoE blocks' in f32, summed in order, or None without any; the
    reference's ``0 + a`` is ``a``).  Sublayer ``i`` draws
    under ``ki = fold_in(key, i)``, its attention under ``fold_in(ki, 0)``
    (a recurrent block or a Mamba-2 mixer under ``ki`` itself) and its MLP
    or MoE router under ``fold_in(ki, 1)``, as the reference folds them."""
    aux = None
    for i, kind in enumerate(cfg.layer_pattern):
        sub = up[f"l{i}"]
        ki = None if key is None else R.fold_in(key, i)
        if kind == "ssm":
            x = x + M2.mamba_apply(sub["mixer"], rmsnorm(sub["ln1"], x, cfg.norm_eps), cfg, ki)
            x = PX.shard(x, ("batch", "seq", "embed"))
            continue
        if kind == "rec":
            o = RG.rglru_block_apply(sub["rec"], rmsnorm(sub["ln1"], x, cfg.norm_eps), cfg, ki)
            x = _rec_block(sub, x, o, cfg, key=None if ki is None else R.fold_in(ki, 1))
            x = PX.shard(x, ("batch", "seq", "embed"))
            continue
        a = ATT.self_attention(
            sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps), positions, cfg,
            kind=kind, key=None if ki is None else R.fold_in(ki, 0),
        )
        x, aux_i = _attn_block(sub, x, a, cfg, key=None if ki is None else R.fold_in(ki, 1),
                               with_aux=True)
        x = PX.shard(x, ("batch", "seq", "embed"))
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    return x, aux


def backbone(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, key=None):
    """All units, unit ``u`` under ``fold_in(key, u)``; returns (final-norm
    hidden states, aux loss: the units' f32 sums added in order from 0, as
    the reference's scan carries it; 0 without MoE blocks).  Each unit runs
    under ``cfg.remat_policy`` (``layers.remat``), as the reference's scan
    body: under ``"nothing"`` and ``"dots"`` the backward runs the unit's
    forward again, and every crossbar read of it is launched twice a
    step.  It changes no number."""
    aux = None
    for u, up in enumerate(unbind_units(params["units"])):
        ku = None if key is None else R.fold_in(key, u)
        x, aux_u = remat(cfg.remat_policy, _unit_fwd, x, up, positions, cfg, ku)
        if aux_u is not None:
            aux = aux_u if aux is None else aux + aux_u
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _with_prefix(x: torch.Tensor, prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """A ``vlm`` model's patch embeddings (B, P, D), cast to the stream's
    dtype, before the token embeddings (B, S, D)."""
    if prefix_embeds is None:
        return x
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)


def lm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, key=None,
               prefix_embeds: Optional[torch.Tensor] = None):
    """(logits (B, S', V), aux) for tokens (B, S); S' = P + S with a
    ``vlm`` patch prefix (B, P, D), positions running over all S'."""
    _check_family(cfg)
    x = _with_prefix(embed(params["embed"], tokens, cfg), prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, aux = backbone(params, x, positions, cfg, key)
    return logits_out(params["embed"], params.get("head"), x, cfg), aux


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask=None, z_loss: float = 1e-4
) -> tuple[torch.Tensor, dict]:
    """Mean token cross-entropy plus ``z_loss·lse²``, in f32."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(lf - m).sum(dim=-1))
    ll = PX.pick_last(lf, labels.long())
    per_tok = (lse - ll) + z_loss * lse.square()
    if mask is not None:
        w = mask.float()
        loss = (per_tok * w).sum() / torch.clamp_min(w.sum(), 1.0)
    else:
        loss = per_tok.mean()
    return loss, {"nll": loss, "lse_mean": lse.mean()}


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, key=None) -> tuple[torch.Tensor, dict]:
    """(loss, metrics) for a batch {"tokens", "labels", optional "mask" and
    "patches"}; analog projections draw under ``key`` (digital when
    ``None``).  With patches the loss is taken on the text positions, the
    last ``labels.shape[1]``."""
    patches = batch.get("patches")
    logits, aux = lm_forward(params, batch["tokens"], cfg, key, patches)
    labels = batch["labels"]
    if patches is not None:
        logits = logits[:, -labels.shape[1]:, :]
    loss, metrics = cross_entropy(logits, labels, batch.get("mask"))
    total = loss + aux
    metrics["aux"] = aux
    metrics["loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# Caches.
# ---------------------------------------------------------------------------


def _state_cache_leaves(cfg: ModelConfig, batch: int, dev) -> dict:
    """Recurrent and SSM per-slot state, O(1) a token, so it stays dense
    (slot addressed) in the dense and the paged layouts alike: ``rec_conv``
    (nu, n_rec, B, 3, W) in the model's dtype, ``rec_h`` (nu, n_rec, B, W)
    in f32; ``ssm_conv`` (nu, n_ssm, B, K-1, C) in the model's dtype,
    ``ssm_state`` (nu, n_ssm, B, H, P, N) in f32.  Empty for a model
    without such sublayers."""
    out = {}
    n_rec, n_ssm = _n_kind(cfg, ("rec",)), _n_kind(cfg, ("ssm",))
    if n_rec:
        w = cfg.lru_width or cfg.d_model
        lead = (cfg.n_units, n_rec, batch)
        out["rec_conv"] = torch.zeros(lead + (RG.CONV_WIDTH - 1, w), dtype=dtype_of(cfg),
                                      device=dev)
        out["rec_h"] = torch.zeros(lead + (w,), dtype=torch.float32, device=dev)
    if n_ssm:
        lead = (cfg.n_units, n_ssm, batch)
        out["ssm_conv"] = torch.zeros(lead + (cfg.ssm_conv - 1, M2.conv_channels(cfg)),
                                      dtype=dtype_of(cfg), device=dev)
        out["ssm_state"] = torch.zeros(
            lead + (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), dtype=torch.float32,
            device=dev)
    return out


def new_cache(make, cfg: ModelConfig, batch: int, device) -> dict:
    """``make(device)``, a cache initialiser's result; on a mesh (a
    ``parallel`` context installed: the dry run's prefill) each leaf is
    allocated as this rank's block of its placement under the cache rules
    (``launch/sharding.cache_shardings``), the scale planes at one and
    every other leaf at zero, as the initialisers make them."""
    ctx = PX.current()
    if ctx is None:
        return make(device)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import sharding as SH

    with FakeTensorMode():   # the leaves' shapes and dtypes, nothing allocated
        shapes = make("meta")
    sh = SH.cache_shardings(shapes, ctx[0], cfg, batch)
    out = {}
    for k, v in shapes.items():
        fill = torch.ones if k.endswith("_scale") else torch.zeros
        local = fill(sh[k].local_shape(v.shape), dtype=v.dtype, device=device)
        out[k] = PX.place_local(local, sh[k], v.shape)
    return out


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The dense layout's cache: ``pos`` (B,) int32 and, per K/V, one
    ``max_len`` window per slot, ``(nu, n_attn, B, max_len, Hkv, Dh)``
    (``n_attn`` counts a unit's attention sublayers).  An int8 cache
    (``cfg.kv_cache_dtype == "int8"``) holds int8 codes and the ``(nu,
    n_attn, B, max_len, Hkv)`` f32 scales ``k_scale`` / ``v_scale`` (ones
    until written).  A hybrid or ssm model adds its state leaves
    (:func:`_state_cache_leaves`); a model without attention has no K/V
    leaves, as in the reference."""
    _check_family(cfg)
    if cfg.kv_cache_dtype not in ("same", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'same' or 'int8', got {cfg.kv_cache_dtype!r}")
    dev = resolve_device(device)
    n_attn = _n_kind(cfg, ATTN_KINDS)
    shape = (cfg.n_units, n_attn, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if n_attn and cfg.kv_cache_dtype == "int8":
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["k_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        cache["v_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
    elif n_attn:
        cache["k"] = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
    cache.update(_state_cache_leaves(cfg, batch, dev))
    return cache


def init_paged_decode_cache(
    cfg: ModelConfig, batch: int, n_pages: int, block_size: int, device=None
) -> dict:
    """Shared pool of KV blocks, ``(nu, n_attn, P, bs, Hkv, Dh)`` per K/V,
    plus the per-slot ``pos``.  Which pages a slot owns is the engine's
    host-side block table; a page may back several slots' tables at once
    (prefix sharing), and the engine forks a shared page before any slot
    writes into it.

    int8 pools (``cfg.kv_cache_dtype == "int8"``) hold int8 codes, the
    ``(nu, n_attn, P, bs, Hkv)`` f32 scale planes ``k_scale_pages`` /
    ``v_scale_pages``, and ``quant_step``, the device decode-step counter
    that seeds the decode writes' rounding.  A hybrid or ssm model's state
    keeps the dense slot layout (:func:`_state_cache_leaves`): it is never
    shared, and is inserted per admission.  A model without attention
    (mamba2) has no pool leaves and no ``quant_step``, as in the reference:
    its cache is ``pos`` and its state, whatever ``kv_cache_dtype`` says."""
    _check_family(cfg)
    if cfg.kv_cache_dtype not in ("same", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'same' or 'int8', got {cfg.kv_cache_dtype!r}")
    dev = resolve_device(device)
    n_attn = _n_kind(cfg, ATTN_KINDS)
    shape = (cfg.n_units, n_attn, n_pages, block_size, cfg.n_kv_heads, cfg.head_dim)
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if n_attn and cfg.kv_cache_dtype == "int8":
        cache["k_pages"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["v_pages"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["k_scale_pages"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        cache["v_scale_pages"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        cache["quant_step"] = torch.zeros((), dtype=torch.int32, device=dev)
    elif n_attn:
        cache["k_pages"] = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
        cache["v_pages"] = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
    cache.update(_state_cache_leaves(cfg, batch, dev))
    return cache


def _layer_seeds(base: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``(base + u·40503 + i·1299721) mod 2**32`` for every unit ``u`` and
    sublayer ``i`` (its index in the whole pattern, recurrent sublayers
    counted): (nu, n_layers, *base.shape) int64, built on base's device in
    a few launches (the reference folds one layer at a time)."""
    dev = base.device
    off = (
        torch.arange(cfg.n_units, device=dev, dtype=torch.int64)[:, None] * 40503
        + torch.arange(len(cfg.layer_pattern), device=dev, dtype=torch.int64)[None] * 1299721
    )
    return (base.reshape((1, 1) + tuple(base.shape)) + off.reshape(off.shape + (1,) * base.dim())) & MASK


def _int8_kw(pool: dict, u: int, ia: int, seed: torch.Tensor, name: str) -> dict:
    """An int8 pool's scale-plane views for unit ``u``'s attention
    sublayer ``ia`` (its index among the attention sublayers), and the
    rounding seed(s) ``seed`` of that sublayer."""
    return {
        "k_scale_pages": pool["k_scale_pages"][u, ia],
        "v_scale_pages": pool["v_scale_pages"][u, ia],
        name: seed,
    }


def _rec_decode(sub: dict, x: torch.Tensor, cache: dict, u: int, ir: int,
                cfg: ModelConfig) -> torch.Tensor:
    """One recurrent sublayer of a decode step: its state read from and
    written back to ``cache``'s ``rec_conv`` / ``rec_h`` in place."""
    conv, hst = cache["rec_conv"][u, ir], cache["rec_h"][u, ir]
    o, new_conv, new_h = RG.rglru_decode_step(
        sub["rec"], rmsnorm(sub["ln1"], x, cfg.norm_eps), conv, hst, cfg)
    PX.write(conv, new_conv)
    PX.write(hst, new_h)
    return _rec_block(sub, x, o, cfg)


def _ssm_decode(sub: dict, x: torch.Tensor, cache: dict, u: int, ism: int,
                cfg: ModelConfig) -> torch.Tensor:
    """One Mamba-2 sublayer of a decode step: its state read from and
    written back to ``cache``'s ``ssm_conv`` / ``ssm_state`` in place."""
    conv, st = cache["ssm_conv"][u, ism], cache["ssm_state"][u, ism]
    o, new_conv, new_st = M2.mamba_decode_step(
        sub["mixer"], rmsnorm(sub["ln1"], x, cfg.norm_eps), conv, st, cfg)
    PX.write(conv, new_conv)
    PX.write(st, new_st)
    return x + o


def lm_decode_step(
    params: dict,
    cache: dict,
    token: torch.Tensor,   # (B,) int last emitted token
    cfg: ModelConfig,
    table: Optional[torch.Tensor] = None,   # (B, W) int32 block table (paged)
    kv_write: bool = True,
    split_batch: Optional[int] = None,
) -> tuple[dict, torch.Tensor]:
    """One decode step; returns (cache, logits (B, V)).

    A paged cache (``k_pages`` leaves) is read and written through the
    block ``table``; a dense cache (``k`` leaves, :func:`init_decode_cache`)
    through each slot's own window (``attention.decode_self_attention``),
    and ``table`` is not used.  The rest of the step is the same code on
    both layouts.  A cache without K/V leaves (mamba2's, either layout)
    holds only ``pos`` and state, and ``table`` is not used either.

    Everything is updated in place: the cache leaves are written, and
    ``pos`` (and an int8 pool's ``quant_step``) advance by one in their own
    storage after their last read, so a captured step (``specs.DecodeGraphs``,
    ``specs.DenseGraphs``) reads the values the engine writes there between
    steps.  A recurrent sublayer's ``rec_conv`` / ``rec_h`` rows and a
    Mamba-2 sublayer's ``ssm_conv`` / ``ssm_state`` rows are written in
    place too.  The returned cache is the same dict.  An int8
    pool's write of unit ``u``, sublayer ``i`` rounds under
    ``quant_step·2654435761 + u·40503 + i·1299721 mod 2**32``; an int8
    dense cache rounds to nearest.

    ``kv_write=False`` is the speculative verify's step: the same math over
    the pool as the draft left it, which stays untouched, and no
    ``quant_step`` tick; ``pos`` still advances, so the caller passes a
    cache view with a ``pos`` of its own.  ``split_batch`` is handed to
    decode attention (``attention.paged_decode_self_attention``)."""
    pos = cache["pos"]
    paged = "k_pages" in cache
    int8_pool = "k_scale_pages" in cache
    int8_dense = "k_scale" in cache
    if paged and table is None:
        raise ValueError("a paged cache's decode step needs its block table")
    if int8_pool and kv_write:
        qstep = cache["quant_step"]
        seeds = _layer_seeds(mul32(qstep.long() & MASK, 2654435761), cfg)
    x = embed(params["embed"], token[:, None], cfg)
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        ia = ir = ism = 0
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            if kind == "ssm":
                x = PX.shard(_ssm_decode(sub, x, cache, u, ism, cfg), ("batch", "seq", "embed"))
                ism += 1
                continue
            if kind == "rec":
                x = PX.shard(_rec_decode(sub, x, cache, u, ir, cfg), ("batch", "seq", "embed"))
                ir += 1
                continue
            hin = rmsnorm(sub["ln1"], x, cfg.norm_eps)
            if not paged:
                kw = {n: cache[n][u, ia] for n in ("k_scale", "v_scale")} if int8_dense else {}
                a = ATT.decode_self_attention(sub["attn"], hin, cache["k"][u, ia],
                                              cache["v"][u, ia], pos, cfg, kind=kind, **kw)
            else:
                kw = {}
                if int8_pool and kv_write:
                    kw = _int8_kw(cache, u, ia, seeds[u, i], "quant_seed")
                elif int8_pool:
                    kw = {n: cache[n][u, ia] for n in ("k_scale_pages", "v_scale_pages")}
                a = ATT.paged_decode_self_attention(
                    sub["attn"], hin, cache["k_pages"][u, ia], cache["v_pages"][u, ia],
                    table, pos, cfg, kind=kind, write=kv_write, split_batch=split_batch, **kw,
                )
            x, _ = _attn_block(sub, x, PX.shard(a, ("batch", "seq", "embed")), cfg)
            x = PX.shard(x, ("batch", "seq", "embed"))
            ia += 1
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    pos.add_(1)
    if int8_pool and kv_write:
        qstep.add_(1)
    return cache, logits[:, 0, :]


def lm_prefill(
    params: dict,
    tokens: torch.Tensor,   # (B, S)
    cfg: ModelConfig,
    max_len: int,
    cache: Optional[dict] = None,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> tuple[dict, torch.Tensor]:
    """The dense layout's monolithic prefill: run the whole prompt and fill
    a dense cache (:func:`init_decode_cache`) with its K/V, padded to
    ``max_len``; returns (cache, last-token logits (B, V)).  Attention is
    ``attention.attend_full``, w_o a plain matmul, as in the reference.
    An int8 cache stores :func:`attention.quantize_kv` of the padded rows.

    ``cache``, when given (B slots, ``max_len`` wide), is written in place
    and returned, every leaf overwritten whole, ``pos`` included: a
    captured decode step that holds its addresses then serves the prompt
    (the static engine's waves); otherwise a new cache is allocated.  A
    recurrent sublayer runs :func:`rglru.rglru_prefill` and leaves its conv
    tail and last hidden state in ``rec_conv`` / ``rec_h``; a Mamba-2
    sublayer runs :func:`mamba2.mamba_prefill` and leaves its conv tail and
    final SSM state in ``ssm_conv`` / ``ssm_state``.  A ``vlm`` patch
    prefix (B, P, D) runs before the tokens: the cache holds P + S rows
    and ``pos`` is P + S."""
    _check_family(cfg)
    if cache is None:
        cache = new_cache(lambda dev: init_decode_cache(cfg, tokens.shape[0], max_len, dev), cfg,
                          tokens.shape[0], tokens.device)
    x = _with_prefix(embed(params["embed"], tokens, cfg), prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    int8 = cfg.kv_cache_dtype == "int8"
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        ia = ir = ism = 0
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            if kind == "ssm":
                o, conv, st = M2.mamba_prefill(sub["mixer"], rmsnorm(sub["ln1"], x, cfg.norm_eps),
                                               cfg)
                x = PX.shard(x + o, ("batch", "seq", "embed"))
                PX.write(cache["ssm_conv"][u, ism], conv)
                PX.write(cache["ssm_state"][u, ism], st)
                ism += 1
                continue
            if kind == "rec":
                o, conv, h_last = RG.rglru_prefill(
                    sub["rec"], rmsnorm(sub["ln1"], x, cfg.norm_eps), cfg)
                x = PX.shard(_rec_block(sub, x, o, cfg), ("batch", "seq", "embed"))
                PX.write(cache["rec_conv"][u, ir], conv)
                PX.write(cache["rec_h"][u, ir], h_last)
                ir += 1
                continue
            q, k, v = ATT.qkv(sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps), cfg)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            o = ATT.attend_full(q, k, v, positions[0], positions[0], kind, cfg)
            a = PX.shard(o.reshape(b, s, -1) @ sub["attn"]["wo"].to(x.dtype), ("batch", "seq", "embed"))
            x, _ = _attn_block(sub, x, a, cfg)
            x = PX.shard(x, ("batch", "seq", "embed"))
            for name, rows in (("k", k), ("v", v)):
                padded = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, max_len - s))
                if int8:
                    codes, scale = ATT.quantize_kv(padded)
                    PX.write(cache[name][u, ia], codes)
                    PX.write(cache[f"{name}_scale"][u, ia], scale)
                else:
                    PX.write(cache[name][u, ia], padded)
            ia += 1
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    cache["pos"].fill_(s)
    return cache, logits[:, 0, :]


def init_prefill_state(cfg: ModelConfig, device=None) -> dict:
    """Zeroed B=1 per-slot state entering a chunked prefill: ``pos`` and,
    for a hybrid or ssm model, the state leaves, exactly what
    :func:`lm_prefill_chunk` threads between chunks and the engine's state
    insert writes at the slot."""
    dev = resolve_device(device)
    state = {"pos": torch.zeros((1,), dtype=torch.int32, device=dev)}
    state.update(_state_cache_leaves(cfg, 1, dev))
    return state


def lm_prefill_chunk(
    params: dict,
    tokens: torch.Tensor,     # (1, c) one request's suffix chunk
    cfg: ModelConfig,
    pool: dict,               # page-pool leaves k_pages / v_pages (in place)
    state: dict,              # B=1 per-slot leaves incl. "pos"
    table_row: torch.Tensor,  # (Wp,) int32 blocks covering the prompt bucket
    q0: int,                  # absolute position of the chunk start
    quant_seeds: torch.Tensor | None = None,  # (nbc,) int64, int8 pools only
) -> tuple[dict, dict, torch.Tensor]:
    """One chunk of a resumable paged prefill; returns (pool, state',
    last-token logits (1, V)).  Attention writes the chunk's K/V into the
    request's own pages and attends over the whole table row at absolute
    positions, so a suffix that starts mid-prompt sees exactly what a
    whole-prompt prefill would.  int8 pools round the chunk's i-th block
    under ``quant_seeds[i] + u·40503 + i_layer·1299721 mod 2**32`` (the
    engine's content-derived block seeds, on the device).

    Recurrent sublayers advance from ``state``'s ``rec_conv`` / ``rec_h``
    (:func:`rglru.rglru_prefill_chunk`), Mamba-2 sublayers from its
    ``ssm_conv`` / ``ssm_state`` (:func:`mamba2.mamba_prefill_chunk`), into
    new tensors: ``state`` itself is never written, so the boundary
    snapshot the engine stashes in its prefix index stays as it was.  An
    attention-free model's ``pool`` is empty."""
    b, c = tokens.shape
    int8_pool = "k_scale_pages" in pool
    if int8_pool:
        if quant_seeds is None:
            raise ValueError("an int8 pool's prefill needs quant_seeds")
        seeds = _layer_seeds(quant_seeds.to(torch.int64), cfg)
    new_state = {n: v.clone() for n, v in state.items() if n != "pos"}
    x = embed(params["embed"], tokens, cfg)
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        ia = ir = ism = 0
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            if kind == "ssm":
                conv, st = new_state["ssm_conv"][u, ism], new_state["ssm_state"][u, ism]
                o, new_conv, new_st = M2.mamba_prefill_chunk(
                    sub["mixer"], rmsnorm(sub["ln1"], x, cfg.norm_eps), conv, st, cfg)
                conv.copy_(new_conv)
                st.copy_(new_st)
                x = x + o
                ism += 1
                continue
            if kind == "rec":
                conv, hst = new_state["rec_conv"][u, ir], new_state["rec_h"][u, ir]
                o, new_conv, new_h = RG.rglru_prefill_chunk(
                    sub["rec"], rmsnorm(sub["ln1"], x, cfg.norm_eps), conv, hst, cfg)
                conv.copy_(new_conv)
                hst.copy_(new_h)
                x = _rec_block(sub, x, o, cfg)
                ir += 1
                continue
            kw = _int8_kw(pool, u, ia, seeds[u, i], "quant_seeds") if int8_pool else {}
            o = ATT.paged_prefill_self_attention(
                sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps),
                pool["k_pages"][u, ia], pool["v_pages"][u, ia],
                table_row, q0, cfg, kind=kind, **kw,
            )
            x, _ = _attn_block(sub, x, o, cfg)
            ia += 1
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    new_state["pos"] = torch.full((b,), q0 + c, dtype=torch.int32, device=tokens.device)
    return pool, new_state, logits[:, 0, :]
