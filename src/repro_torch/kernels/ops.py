"""Kernel dispatch (``repro/kernels/ops.py``): the crossbar read with its
straight-through backward (:75-260), attention (:386-512), WTA vote
counts (:316-358), the int8 KV quantizer (:581-642), the int8 KV
pool's fused write (the quantizer and the page scatters of
``repro/models/attention.py``), and two threefry draws the reference
leaves to XLA: the WTA trials of ``repro/core/wta.py`` (:50-83) and the
stochastic Sigmoid neurons of ``repro/core/neurons.py`` (:52-84).

The public ``crossbar_mac``, ``wta_counts``, ``stoch_round``,
``stoch_round_serving``, ``paged_attention`` and
``paged_prefill_attention`` ask the process-wide
device backend first (``backend.get_backend()``, ``ops.py:183-195,
316-331, 386-406, 450-470, 571-580`` of the reference), whose Sim routes
to the ``*_sim`` functions below; a fault backend perturbs their
arguments or weights and calls the same functions.  Behind the seam, a
CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version, and nothing else happens in between: no fallback, no
try.  The kernels return f32; callers cast to the model dtype, as the
reference does.  Seeds are uint32 values held in int64 tensors (see
``prng.py``), on the device of the data they round.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import parallel as PX
from repro_torch.core.physics import BOLTZMANN_K, PROBIT_SCALE
from . import backend as _backend
from . import crossbar_mac as CB
from . import paged_attention as PA
from . import prefill_attention as PF
from . import prng, ref
from . import sigmoid_sample as SS
from . import stoch_round as SR
from . import wta_counts as WTA
from . import wta_sample as WS


# every kernel wrapper's launch counter: name -> (module, attribute)
_COUNTERS = {
    "paged_attention": (PA, "launches"),
    "paged_prefill_attention": (PF, "launches"),
    "stoch_round": (SR, "launches"),
    "write_kv_int8": (SR, "write_launches"),
    "wta_counts": (WTA, "launches"),
    "wta_sample": (WS, "launches"),
    "sigmoid_sample": (SS, "launches"),
    "crossbar_mac": (CB, "launches"),
    "crossbar_prepass": (CB, "prepass_launches"),
}


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta`` to the wrappers' launch counts.  A wrapper counts when
    its Python runs; a CUDA graph runs none, so a replay adds what its
    capture counted, and the capture itself, which launches nothing,
    takes its count back."""
    for name, n in delta.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


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
    split_batch: Optional[int] = None,
) -> torch.Tensor:
    """Block-table decode attention: (B, H, Dh) f32, through the active
    device backend.  ``split_batch``: the batch width whose cluster split
    the kernel takes (``paged_attention.paged_attention_cuda``)."""
    return _backend.get_backend().paged_attention(
        q, k_pages, v_pages, table, pos, kind=kind, local_window=local_window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale, split_batch=split_batch,
    )


def paged_attention_sim(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table: torch.Tensor,
    pos: torch.Tensor,
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    split_batch: Optional[int] = None,
) -> torch.Tensor:
    """The Sim backend's decode attention: the kernel on the card, the
    plain version on the CPU (whose rows do not depend on the batch, so it
    takes no ``split_batch``)."""
    kw = dict(kind=kind, local_window=local_window, softcap=softcap, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return PA.paged_attention_cuda(q, k_pages, v_pages, table, pos, split_batch=split_batch,
                                       **kw)
    return ref.paged_attention_ref(q, k_pages, v_pages, table, pos, **kw)


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
    """Prefix-aware chunked-prefill attention: (S, H, Dh) f32, through the
    active device backend."""
    return _backend.get_backend().paged_prefill_attention(
        q, k_pages, v_pages, table, q0, kind=kind, local_window=local_window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale,
    )


def paged_prefill_attention_sim(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table: torch.Tensor,
    q0: int,
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The Sim backend's prefill attention: the kernel on the card, the
    plain version on the CPU."""
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
    """:func:`stoch_round_serving_sim` through the active device backend."""
    return _backend.get_backend().stoch_round_serving(x, seeds, step=step, lo=lo, hi=hi)


def stoch_round_serving_sim(
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


class _StochRound(torch.autograd.Function):
    """Forward: the kernel on the card, its plain version on the CPU.
    Backward: straight through inside the range, ``g·[lo ≤ x ≤ hi]``
    (``repro/kernels/ops.py:533-535``)."""

    @staticmethod
    def forward(ctx, x2d, seed, step, lo, hi):
        ctx.save_for_backward(x2d)
        ctx.lo, ctx.hi = lo, hi
        fn = SR.stoch_round_cuda if x2d.is_cuda else ref.stoch_round_ref
        return fn(x2d, _seed_tensor(seed, x2d.device), step=step, lo=lo, hi=hi)

    @staticmethod
    def backward(ctx, g):
        (x2d,) = ctx.saved_tensors
        return g * ((x2d >= ctx.lo) & (x2d <= ctx.hi)).to(g.dtype), None, None, None, None


def stoch_round(x: torch.Tensor, key, *, step: float, lo: float, hi: float) -> torch.Tensor:
    """Unbiased stochastic rounding of ``x`` onto ``{lo + k·step} ∩ [lo,
    hi]`` under the threefry ``key``, with a straight-through gradient;
    through the active device backend (:func:`stoch_round_sim`)."""
    return _backend.get_backend().stoch_round(x, key, step=step, lo=lo, hi=hi)


def stoch_round_sim(x: torch.Tensor, key, *, step: float, lo: float, hi: float) -> torch.Tensor:
    """The Sim backend's rounding: f32 of ``x``'s shape over its rows
    ``x.reshape(-1, N)``, under ``key_to_seed(key)`` at the counter ``row ·
    n_padded + col`` (``n_padded``: N rounded up to 512), as the
    reference's padded ``stoch_round_pallas`` draws it
    (``repro/kernels/stoch_round.py:93``); one launch on the card."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).to(torch.float32).contiguous()
    return _StochRound.apply(x2d, prng.key_to_seed(key), step, lo, hi).reshape(shape)


def stoch_round_reference(x: torch.Tensor, key, *, step: float, lo: float,
                          hi: float) -> torch.Tensor:
    """The reference's ``stoch_round_reference``: rows padded to 256 and
    columns to 512, the plain version on the padded array, cut back; on
    any device, no kernel and no gradient.  What the card's kernel is held
    against."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).to(torch.float32)
    m, n = x2d.shape
    xp = torch.nn.functional.pad(x2d, (0, -n % 512, 0, -m % 256))
    out = ref.stoch_round_ref(xp, _seed_tensor(prng.key_to_seed(key), x.device),
                              step=step, lo=lo, hi=hi)
    return out[:m, :n].reshape(shape)


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


def write_kv_int8(
    k: torch.Tensor,          # decode (B, 1, Hkv, Dh); chunk (1, c, Hkv, Dh)
    v: torch.Tensor,
    k_pages: torch.Tensor,    # (P, bs, Hkv, Dh) int8, written in place
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,    # (P, bs, Hkv) f32, written in place
    v_scale: torch.Tensor,
    seeds,                    # decode: one seed; chunk: one per block
    *,
    table: Optional[torch.Tensor] = None,      # decode: (B, W) int32
    pos: Optional[torch.Tensor] = None,        # decode: (B,) int32
    table_row: Optional[torch.Tensor] = None,  # chunk: (Wp,) int32
    b0: int = 0,                               # chunk: its first block
) -> None:
    """One layer's int8 KV write: :func:`quantize_kv_pair_int8` of the
    rows, then the scatter of codes and scales into the pools, in place
    (``ref.write_kv_int8_ref`` states the layout).  One kernel launch on
    the card."""
    seeds = _seed_tensor(seeds, k.device)
    fn = SR.write_kv_int8_cuda if k.is_cuda else ref.write_kv_int8_ref
    fn(k, v, k_pages, v_pages, k_scale, v_scale, seeds,
       table=table, pos=pos, table_row=table_row, b0=b0)


# ---------------------------------------------------------------------------
# WTA vote counts.
# ---------------------------------------------------------------------------


def wta_counts(
    z: torch.Tensor, seed, *, n_trials: int, vth0: float, sigma_z: float
) -> torch.Tensor:
    """:func:`wta_counts_sim` through the active device backend (a fault
    backend shifts the comparator's operating point first)."""
    return _backend.get_backend().wta_counts(
        z, seed, n_trials=n_trials, vth0=vth0, sigma_z=sigma_z
    )


def wta_counts_sim(
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


def wta_counts_reference(
    z: torch.Tensor, seed, *, n_trials: int, vth0: float, sigma_z: float
) -> torch.Tensor:
    """:func:`wta_counts_sim`'s counts by the plain version on any device,
    no kernel (``repro/kernels/ops.py:361-378``): what the card's kernel is
    held against."""
    lead, c = z.shape[:-1], z.shape[-1]
    z2d = z.reshape(-1, c).to(torch.float32).contiguous()
    out = ref.wta_counts_ref(z2d, _seed_tensor(seed, z.device), n_trials=n_trials, vth0=vth0,
                             sigma_z=sigma_z)
    return out.reshape(lead + (c,))


def wta_trial_counts(
    z: torch.Tensor,
    keys: torch.Tensor,
    folds: Optional[torch.Tensor],
    n_trials: int,
    vth0: float,
    sigma_z: float,
    layout: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """WTA trials under jax's threefry ``normal``: z (N, C) → (counts (N,
    C) f32, n_decisions (N,) f32).  Row n draws under ``keys[n]`` (N, 2)
    with the words of ``folds[n]`` (N, F ≤ 2, or None) folded in, at the
    flat counter ``t·layout[0] + n·layout[1] + c``: ``(C, 0)`` is the
    reference's ``vmap`` of per-slot keys over ``normal(k, (T, C))``, ``(N·C,
    C)`` one key's ``normal(k, (T, N, C))``.  bf16 and f32 rows are read as
    they are (the reference's ``z.astype(f32)``); keys and words are uint32
    values in int64 tensors on z's device.  On a mesh it runs on whole
    operands (``parallel.on_whole``)."""
    return PX.on_whole(functools.partial(_wta_trial_counts, n_trials=n_trials, vth0=vth0,
                                         sigma_z=sigma_z, layout=layout), z, keys, folds)


def _wta_trial_counts(z, keys, folds, *, n_trials, vth0, sigma_z, layout):
    if z.dtype not in (torch.float32, torch.bfloat16):
        z = z.to(torch.float32)
    z = z.contiguous()
    keys = keys.to(device=z.device, dtype=torch.int64).contiguous()
    if folds is not None:
        folds = folds.to(device=z.device, dtype=torch.int64).contiguous()
    fn = WS.wta_sample_cuda if z.is_cuda else ref.wta_trial_counts_ref
    return fn(z, keys, folds, n_trials=n_trials, vth0=vth0, sigma_z=sigma_z, layout=layout)


def sigmoid_sample(
    acc: torch.Tensor, bias: Optional[torch.Tensor], beta: float, key, offset: int = 0
) -> torch.Tensor:
    """Binary stochastic Sigmoid neurons: ``acc`` (..., N) → y f32 of its
    shape, 1 where jax's threefry ``uniform(key, acc.shape)`` (from the
    flat counter ``offset``) lies below ``sigmoid(β·(acc + bias))``.
    ``bias`` is (N,) or None; ``key`` a threefry key of Python ints.
    Forward only: the straight-through backward is ``core.neurons``'.  On a
    mesh it runs on whole operands (``parallel.on_whole``)."""
    return PX.on_whole(functools.partial(_sigmoid_sample, beta=beta, key=key, offset=offset),
                       acc, bias)


def _sigmoid_sample(acc, bias, *, beta, key, offset):
    n = acc.shape[-1]
    a2d = acc.reshape(-1, n).to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=acc.device, dtype=torch.float32).contiguous()
    fn = SS.sigmoid_sample_cuda if a2d.is_cuda else ref.sigmoid_sample_ref
    return fn(a2d, bias, beta=beta, key=key, offset=offset).reshape(acc.shape)


# ---------------------------------------------------------------------------
# crossbar_mac: the RACA crossbar read, with the QAT/STE backward.
# ---------------------------------------------------------------------------


def range_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-layer dynamic-range scale ``s = max(max|W|, 1e-6)``: a 0-d tensor
    on ``w``'s device (read by the kernel there, never by the host)."""
    return w.detach().abs().amax().clamp_min(1e-6)


def _qstep(dp) -> float:
    return (dp.w_max - dp.w_min) / max(dp.n_levels - 1, 1)


def _noise_params(dp, k_rows: int) -> tuple:
    return (
        4.0 * BOLTZMANN_K * dp.temperature * dp.delta_f,
        dp.g0, dp.g_ref, dp.v_read, float(k_rows),
    )


def _crossbar_forward(x2d, wf, seed: int, cfg, binarize: bool, fn) -> torch.Tensor:
    """The reference's ``_crossbar_fwd_impl`` without its padding: with the
    calibrated read, devices hold W/s and the comparator's noise absorbs s
    (σ = 1.702 / (β·s) realizes P = sigmoid(β·z)); the linear readout is
    scaled back by s."""
    dp = cfg.device
    dev = x2d.device
    s = None
    if cfg.calibrated:
        s = range_scale(wf)
        w_in = wf / s
        if binarize:
            # filled on the device: a host tensor copied there would wait
            # for the stream, one sync a comparator read
            sigma = torch.full((), PROBIT_SCALE, dtype=torch.float32, device=dev) / (cfg.beta * s)
        else:
            sigma = torch.full((), cfg.linear_sigma, dtype=torch.float32, device=dev)
    else:  # physical noise: σ comes from ΣWq, this one is not read
        w_in = wf
        sigma = torch.full((), PROBIT_SCALE / cfg.beta, dtype=torch.float32, device=dev)
    out = fn(
        x2d.contiguous(), w_in.contiguous(), seed, sigma,
        binarize=binarize, physical_noise=not cfg.calibrated,
        noise_params=_noise_params(dp, x2d.shape[1]), quantize=cfg.quantize,
        qstep=_qstep(dp), w_min=dp.w_min, w_max=dp.w_max,
    )
    if s is not None and not binarize:
        out = out * s
    return out


def _crossbar_backward(cfg, binarize: bool, x2d, w, g):
    """The reference's ``_crossbar_bwd`` (``ops.py:140-177``).

    binarize: y ~ Bern(sigmoid(β z)); the STE surrogate E[y] gives
    dz = g·β·p(1−p), with p recomputed from z = x·Wq.  Linear: dz = g.  The
    quantizer is straight-through; the physical path keeps the clip mask.
    Both products are plain matmuls, as the reference leaves them to XLA."""
    dp = cfg.device
    wq = w
    if cfg.quantize:
        step = _qstep(dp)
        if cfg.calibrated:
            s = range_scale(w)
            wq = s * ref.crossbar_quantize(w / s, step, dp.w_min, dp.w_max)
        else:
            wq = ref.crossbar_quantize(w, step, dp.w_min, dp.w_max)
    if binarize:
        p = torch.sigmoid(cfg.beta * (x2d @ wq))
        dz = g * cfg.beta * p * (1.0 - p)
    else:
        dz = g
    dx = dz @ wq.T
    dw = x2d.T @ dz
    if cfg.quantize and not cfg.calibrated:
        dw = dw * ((w >= dp.w_min) & (w <= dp.w_max)).to(dw.dtype)
    return dx, dw


class _CrossbarMAC(torch.autograd.Function):
    """Forward: the kernel (or its plain version on the CPU).  Backward: the
    STE surrogate.  It saves W in its stored dtype (bf16 parameters) and
    casts again in the backward: an f32 copy of every projection's weights
    would hold ≈ 10 GB at stablelm-3b's full width."""

    @staticmethod
    def forward(ctx, x2d, w, seed, cfg, binarize):
        ctx.save_for_backward(x2d, w)
        ctx.cfg, ctx.binarize = cfg, binarize
        if x2d.is_meta:  # the dry run's shapes: no read
            return x2d.new_empty((x2d.shape[0], w.shape[1]), dtype=torch.float32)
        fn = CB.crossbar_mac_cuda if x2d.is_cuda else ref.crossbar_mac_ref
        return _crossbar_forward(x2d, w.to(torch.float32), seed, cfg, binarize, fn)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        dx, dw = _crossbar_backward(ctx.cfg, ctx.binarize, x2d, w.to(torch.float32), g)
        return dx, dw.to(w.dtype), None, None, None


def crossbar_mac(x: torch.Tensor, w: torch.Tensor, key, cfg, binarize: bool = True) -> torch.Tensor:
    """Fused RACA matmul: x (..., K) f32, w (K, N) → (..., N) f32, under the
    threefry key ``key``, through the active device backend (a fault
    backend perturbs the weights or the read first).  On a mesh it runs on
    whole operands (``parallel.on_whole``): the range scale is the whole
    weight's and the noise counter spans the whole output."""
    return PX.on_whole(lambda x, w: _backend.get_backend().crossbar_mac(x, w, key, cfg, binarize),
                       x, w)


def crossbar_mac_sim(x: torch.Tensor, w: torch.Tensor, key, cfg, binarize: bool = True) -> torch.Tensor:
    """The Sim backend's read: ``key`` folded into the kernel's uint32 seed
    as the reference folds it; differentiable through the STE backward."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(torch.float32)
    y = _CrossbarMAC.apply(x2d, w, prng.key_to_seed(key), cfg, binarize)
    return y.reshape(lead + (w.shape[1],))


def crossbar_mac_reference(
    x: torch.Tensor, w: torch.Tensor, key, cfg, binarize: bool = True
) -> torch.Tensor:
    """The same normalization and seed pipeline through the plain version,
    on any device and without autograd: what ``chip_smoke.py`` holds
    :func:`crossbar_mac` against on the card."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(torch.float32)
    y = _crossbar_forward(
        x2d, w.to(torch.float32), prng.key_to_seed(key), cfg, binarize, ref.crossbar_mac_ref
    )
    return y.reshape(lead + (w.shape[1],))


# ---------------------------------------------------------------------------
# The canary: a fixed known-answer crossbar read for drift detection.
# ---------------------------------------------------------------------------

_CANARY_ROWS, _CANARY_COLS = 128, 8


@functools.lru_cache(maxsize=1)
def _canary_operands() -> tuple[np.ndarray, np.ndarray]:
    """x (1, 128), w (128, 8) f32, drawn as the reference draws them."""
    rng = np.random.default_rng(0xCA9A31)
    x = rng.uniform(-1.0, 1.0, (1, _CANARY_ROWS)).astype(np.float32)
    w = rng.uniform(-1.0, 1.0, (_CANARY_ROWS, _CANARY_COLS)).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def _canary_tensors(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands on ``device``, copied there once."""
    return tuple(torch.from_numpy(a).to(device) for a in _canary_operands())


@functools.lru_cache(maxsize=1)
def _canary_cfg():
    # an unquantized calibrated linear read: the healthy answer is x @ w
    # plus a small zero-mean read noise, so drift and stuck cells separate
    # from the noise floor by a relative-error threshold
    from repro_torch.core.analog import AnalogConfig

    return AnalogConfig(mode="analog_linear", quantize=False, calibrated=True, linear_sigma=0.01)


def canary_expected() -> np.ndarray:
    """The canary's known answer on the host: (1, 8) f32."""
    x, w = _canary_operands()
    return x @ w


def canary_mac(key, device: torch.device) -> torch.Tensor:
    """Fire the canary: the fixed (1, 128) × (128, 8) linear crossbar read
    of :func:`crossbar_mac`, on ``device``, through the active backend.
    Healthy, it is :func:`canary_expected` plus ≈ ``linear_sigma`` of read
    noise; drift scales it and stuck cells and a comparator offset shift
    it, so a relative-error check against the known answer detects a
    degraded substrate without touching live traffic."""
    x, w = _canary_tensors(torch.device(device))
    return crossbar_mac(x, w, key, _canary_cfg(), binarize=False)
