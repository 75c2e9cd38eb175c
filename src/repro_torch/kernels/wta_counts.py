"""Winner-take-all vote counts: the CUDA kernel's wrapper and its plain
version.

Replaces ``wta_counts_pallas`` (``repro/kernels/wta_kernel.py``), the
paper's binary stochastic SoftMax (§III-B).  The kernel
(``csrc/wta_counts.cu``) draws only the columns that can still win: a
column's voltage is bounded before its noise is drawn, first by the
largest radius of its first uniform's bucket (:func:`radius_table`), then
by its own radius, and a column that cannot fire or is strictly below a
fired voltage already seen skips the rest of the draw.  At wide rows a (row, trial) is a
cluster of CTAs that share the trial's best fired voltage through
distributed shared memory; at narrow rows one warp runs one (row, trial)
and draws every column.  Its plain PyTorch
version is :func:`wta_counts_ref`; ``ops.wta_counts`` sends CPU tensors
there and CUDA tensors here.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from .ref import wta_counts_ref, wta_trial_stride  # noqa: F401  (the plain version)

launches = 0

# the kernel's constants (csrc/wta_counts.cu)
WARPS = 8                  # per CTA, at most
STEP_COLS = 256            # columns a warp takes per step, 8 a lane
TIES = 32                  # columns a warp keeps at its fired maximum
WARP_MODE_MAX_C = 512      # one warp per (row, trial), every column drawn, up to this width
MIN_WARP_COLS = 512        # columns a racing warp takes at least,
WARP_COLS = 3072           # and unless the pairs would fill under half the card
MAX_CLUSTER = 8
RADIUS_BUCKETS = 2048      # the radius table: buckets of u1's top 11 bits

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


class WtaGeometry(NamedTuple):
    n_cta: int          # CTAs per (row, trial); 0: one warp per (row, trial)
    warps: int          # warps per CTA
    cols_per_cta: int   # columns of a CTA's slice (a multiple of 4), or C


def wta_geometry(c: int, pairs: int, resident_warps: int) -> WtaGeometry:
    """The launch shape for ``pairs`` (row, trial) pairs of ``c`` classes on
    a card that holds ``resident_warps`` warps at once.  Rows up to 512 wide
    run one warp per pair drawing every column.  Wider rows race in warps
    of ``WARP_COLS`` columns (a warp pays for a batch or two of draws
    before the trial's best prunes its columns), or more warps where the
    pairs would fill less than half the card, down to ``MIN_WARP_COLS``
    columns a warp and at most 64 warps a pair: clusters of 1, 2, 4 or 8
    CTAs of up to 8 warps.  At the serving head (8 × 50304, 32 trials) that
    is 16 warps a pair, clusters of 2 CTAs of 8 warps (the fastest in
    ``chip_smoke.py``'s sweep on an H100)."""
    if c <= WARP_MODE_MAX_C:
        return WtaGeometry(0, 1, c)
    fill = -(-resident_warps // (2 * max(pairs, 1)))
    w = max(1, min(max(c // WARP_COLS, fill), c // MIN_WARP_COLS, MAX_CLUSTER * WARPS))
    n_cta = 1
    while n_cta * WARPS < w:
        n_cta *= 2
    per = -(-c // n_cta)
    return WtaGeometry(n_cta, -(-w // n_cta), -(-per // 4) * 4)
def _lib():
    lib = build.load("wta_counts")
    if lib.wta_counts_launch.argtypes is None:
        lib.wta_counts_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _U, _I, _F, _F, _I, _I, _I,
                                          _P]
        lib.wta_radius_table.argtypes = [_P, _P]
        lib.wta_resident_warps.argtypes = [_I]
        lib.wta_draw_probe.argtypes = [_P, _P, _I, _I, _I, _U, _I, _U, _F, _F, _P]
        for fn in (lib.wta_counts_launch, lib.wta_radius_table, lib.wta_resident_warps,
                   lib.wta_draw_probe):
            fn.restype = _I
    return lib


_tables: dict[torch.device, torch.Tensor] = {}
_resident: dict[torch.device, int] = {}


def resident_warps(device) -> int:
    """Warps of the racing kernel (CTAs of 8 warps) the card holds at once:
    SMs × CTAs an SM by the occupancy calculator × 8."""
    device = _index(device)
    if device not in _resident:
        with torch.cuda.device(device):
            got = _lib().wta_resident_warps(WARPS)
        if got <= 0:
            raise RuntimeError("wta_counts: the occupancy query failed")
        _resident[device] = got
    return _resident[device]


def _index(device) -> torch.device:
    device = torch.device(device)
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def radius_table(device) -> torch.Tensor:
    """(RADIUS_BUCKETS + 1,) f32 on ``device``: the largest radius
    ``sqrtf(-2·logf(u1))`` the card computes over each bucket of u1's 2**24
    values, then the largest ``|cosf(2π·u2)|`` over u2's.  Built once per
    device (one launch over 2**24 values, then a wait on the stream)."""
    device = _index(device)
    table = _tables.get(device)
    if table is None:
        out = torch.zeros(RADIUS_BUCKETS + 1, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device)
        _check(_lib().wta_radius_table(out.data_ptr(), stream.cuda_stream), "wta_radius_table")
        stream.synchronize()
        table = _tables[device] = out.view(torch.float32)
    return table


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# (device, B, C, T) -> the launch's arguments besides the tensors, seed,
# vth0 and σ: worked out once per call shape, since a serving head's call
# is launch-bound and pays for every microsecond of host time
_plans: dict[tuple, tuple] = {}


def _plan(device, b: int, c: int, n_trials: int, geometry: Optional[WtaGeometry]) -> tuple:
    c_pad = -(-c // 128) * 128  # the reference's padded class width
    geo = geometry or wta_geometry(c, b * n_trials, resident_warps(device))
    blocks = b * geo.n_cta if geo.n_cta else -(-b * n_trials // WARPS)
    if not 0 <= n_trials < 65536 or blocks >= 2**31:
        raise ValueError(f"wta_counts cannot take B={b} C={c} T={n_trials}")
    table = radius_table(device).data_ptr() if geo.n_cta else None   # narrow rows draw all
    return (table, (b, c, c_pad, wta_trial_stride(c_pad), n_trials),
            (geo.n_cta, geo.warps, geo.cols_per_cta))


def wta_counts_cuda(
    z: torch.Tensor,       # (B, C) f32, contiguous, on the card
    seed: torch.Tensor,    # one int64 uint32 seed on the card
    *,
    n_trials: int,
    vth0: float,
    sigma_z: float,
    geometry: Optional[WtaGeometry] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B, C) f32 counts.
    Same contract as :func:`wta_counts_ref`.  ``geometry`` overrides
    :func:`wta_geometry` (``chip_smoke.py``'s sweep; every launch shape
    gives the same counts)."""
    global launches
    if z.device.type != "cuda" or z.dtype != torch.float32 or z.dim() != 2:
        raise ValueError(f"wta_counts takes a 2-D f32 CUDA tensor, got {z.dtype} {z.device}")
    if not z.is_contiguous():
        raise ValueError("wta_counts input must be contiguous")
    seed = seed.reshape(-1)
    if seed.shape != (1,) or seed.dtype != torch.int64 or seed.device != z.device:
        raise ValueError("seed must be one int64 value on the input's device")
    key = (z.device, *z.shape, n_trials)
    plan = _plans.get(key) if geometry is None else _plan(*key, geometry)
    if plan is None:
        plan = _plans[key] = _plan(*key, None)
    table, shape, launch = plan
    counts = torch.zeros_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _lib().wta_counts_launch(z.data_ptr(), seed.data_ptr(), table, counts.data_ptr(), *shape,
                                  vth0, sigma_z, *launch, stream)
    _check(rc, "wta_counts")
    launches += 1
    return counts


def draw_bounds(device) -> tuple[float, float]:
    """Over every value the draw's uniforms can take on this card (2**24
    each), from :func:`radius_table`: (the largest radius, ≈ 5.887 at u1 =
    2**-25; the largest ``|cosf(2π·u2)|``, which the kernel's bounds need to
    be at most 1)."""
    table = radius_table(device)
    return float(table[:RADIUS_BUCKETS].max()), float(table[RADIUS_BUCKETS])


def draw_probe(z: torch.Tensor, seed: torch.Tensor, *, n_trials: int, vth0: float,
               sigma_z: float) -> torch.Tensor:
    """Every (row, trial, column) of :func:`wta_counts_cuda`'s call drawn in
    full by ``wta_draw_probe_kernel`` (the kernel's logf, sqrtf and cosf,
    nothing pruned): (B, T, C) f32, the voltage where it fires, else −inf.
    Reads the seed on the host.  Not counted in ``launches``."""
    if z.device.type != "cuda" or z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError("draw_probe takes a contiguous 2-D f32 CUDA tensor")
    b, c = z.shape
    if b * n_trials * c >= 2**31:
        raise ValueError(f"draw_probe takes fewer than 2**31 draws, got {b}x{n_trials}x{c}")
    c_pad = -(-c // 128) * 128
    v = torch.empty((b, n_trials, c), dtype=torch.float32, device=z.device)
    _check(_lib().wta_draw_probe(z.data_ptr(), v.data_ptr(), b, c, c_pad, wta_trial_stride(c_pad),
                                 n_trials, int(seed.reshape(-1)[0]), sigma_z, vth0,
                                 torch.cuda.current_stream(z.device).cuda_stream),
           "wta_draw_probe")
    return v


def full_draw_counts(z: torch.Tensor, seed: torch.Tensor, *, n_trials: int, vth0: float,
                     sigma_z: float) -> torch.Tensor:
    """The counts :func:`wta_counts_cuda` must return exactly: each trial's
    fired maximum over :func:`draw_probe`'s full draw, one vote to every
    fired column equal to it.  The pruned kernel's check on the card."""
    v = draw_probe(z, seed, n_trials=n_trials, vth0=vth0, sigma_z=sigma_z)
    best = v.amax(-1, keepdim=True)
    return ((v == best) & (best > -float("inf"))).sum(1, dtype=torch.float32)
