"""The RACA crossbar read: the CUDA kernels' wrapper and its plain version.

Replaces ``crossbar_mac_pallas`` (``repro/kernels/crossbar_mac.py``), the
paper's own compute: conductance quantization → MAC → thermal noise →
comparator.  A quantized read is two launches of ``csrc/crossbar_mac.cu``:
a prepass that splits x into three bf16 pieces and quantizes W into
centered integer levels (transposed, bf16), then a tensor-core GEMM
(``wgmma``) in the level domain, ``z = qstep·(x @ C) + c0·Σ_k x``, with
noise and comparator fused into its store.  Unquantized reads (the serving
canary) run the f32 CUDA-core kernel.  Its plain PyTorch version is
:func:`crossbar_mac_ref`; :func:`crossbar_prepass_ref` and
:func:`crossbar_gemm_ref` are the two launches' own, which repeat their
level-domain arithmetic.  ``ops.crossbar_mac`` sends CPU tensors to the
plain version and CUDA tensors here.  ``launches`` counts reads (one GEMM or f32 launch
each), ``prepass_launches`` the prepass; nothing else adds to them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import CROSSBAR_PAD_N, CROSSBAR_SLICE_K, level_center
from .ref import crossbar_gemm_ref, crossbar_mac_ref, crossbar_prepass_ref  # noqa: F401  (plain versions)

launches = 0
prepass_launches = 0

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

BM, BK, PIECES = 128, CROSSBAR_SLICE_K, 3   # GEMM tile rows, k-slice, bf16 pieces of x
# The output tile's width.  64 columns leave shared memory for a ring of 4
# stages (48 KB of x pieces and 8 KB of levels each), so two loads stay in
# flight while the consumers hold two slices; 96 and 128 fit only 3 and
# measured slower at every training shape (the tile sweep in
# ``chip_smoke.py``, recorded in ``PERF.md``).  They are compiled for that
# sweep alone.
TILE_N = 64
TILE_NS = (64, 96, 128)


def _lib():
    lib = build.load("crossbar_mac")
    if lib.crossbar_gemm_launch.argtypes is None:
        lib.crossbar_prepass_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                                _F, _F, _F, _F, _P]
        lib.crossbar_gemm_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U,
                                             _I, _I, _F, _F, _F, _F, _F, _F, _I, _P]
        lib.crossbar_mac_f32_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I,
                                                _F, _F, _F, _F, _P]
        for fn in (lib.crossbar_prepass_launch, lib.crossbar_gemm_launch,
                   lib.crossbar_mac_f32_launch):
            fn.restype = _I
    return lib


def crossbar_geometry(m: int, k: int, n: int, tile_n: int = TILE_N) -> dict:
    """Launch shape of the tensor-core read: k padded to the 64-column
    slice, the output tile width and the grid of 128-row tiles."""
    if tile_n not in TILE_NS:
        raise ValueError(f"crossbar_mac tile width {tile_n} is not one of {TILE_NS}")
    return {"kp": -(-k // BK) * BK, "tile_n": tile_n, "grid": (-(-n // tile_n), -(-m // BM))}


def _check(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"crossbar_mac takes 2-D f32 CUDA tensors, got {name} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"crossbar_mac's {name} must be contiguous")
    m, k = x.shape
    if w.shape[0] != k or w.device != x.device:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not chain on one device")
    if k == 0:   # the GEMM's consumers would wait for a slice that never comes
        raise ValueError("crossbar_mac takes K >= 1")
    n = w.shape[1]
    kp = -(-k // BK) * BK
    if max(PIECES * m * kp, n * kp, m * n, k * n) >= 2**31:
        raise ValueError(f"crossbar_mac takes operands under 2**31 elements, got {m}x{k}x{n}")
    return m, k, n


def crossbar_prepass_cuda(
    x: torch.Tensor, w: torch.Tensor, qstep: float, w_min: float, w_max: float,
    physical_noise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the prepass: x (M, K), w (K, N) f32 on the card → x's three
    bf16 pieces (3, M, Kp), its row sums (M,) f32, the centered levels
    transposed (N, Kp) bf16 and, with the physical noise model, their
    column sums (N,) int32 (one unread zero otherwise).  Same contract as
    :func:`crossbar_prepass_ref`."""
    global prepass_launches
    m, k, n = _check(x, w)
    center = level_center(qstep, w_min, w_max)
    kp = -(-k // BK) * BK
    xs = torch.empty((PIECES, m, kp), dtype=torch.bfloat16, device=x.device)
    rowsum = torch.empty((m,), dtype=torch.float32, device=x.device)
    ct = torch.empty((n, kp), dtype=torch.bfloat16, device=x.device)
    colsum = torch.zeros((n if physical_noise else 1,), dtype=torch.int32, device=x.device)
    # 1/qstep rounds to f32 in ctypes, as the reference's jnp.float32 does
    rc = _lib().crossbar_prepass_launch(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), rowsum.data_ptr(), ct.data_ptr(),
        colsum.data_ptr(), m, k, n, kp, int(physical_noise), 1.0 / qstep, w_min, w_max,
        float(center), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"crossbar_mac prepass launch failed: CUDA error {rc}")
    prepass_launches += 1
    return xs, rowsum, ct, colsum


def crossbar_gemm_cuda(
    xs: torch.Tensor, rowsum: torch.Tensor, ct: torch.Tensor, colsum: torch.Tensor,
    k: int, seed: int, sigma: torch.Tensor, *,
    binarize: bool = True, physical_noise: bool = False,
    noise_params: tuple = (0.0, 1.0, 0.0, 1.0, 0),
    qstep: float = 2.0 / 31, w_min: float = -1.0, w_max: float = 1.0,
    tile_n: int = TILE_N,
) -> torch.Tensor:
    """Launch the tensor-core read on the prepass's outputs; returns (M, N)
    f32.  Same contract as :func:`crossbar_gemm_ref`.  ``tile_n`` is the
    tile sweep's override; reads run at ``TILE_N``."""
    global launches
    _, m, kp = xs.shape
    n = ct.shape[0]
    center = level_center(qstep, w_min, w_max)
    geo = crossbar_geometry(m, k, n, tile_n)
    if xs.shape[0] != PIECES or geo["kp"] != kp or ct.shape[1] != kp or rowsum.shape != (m,):
        raise ValueError(f"prepass outputs {tuple(xs.shape)}, {tuple(ct.shape)} do not fit k={k}")
    for name, t, dt, numel in (("xs", xs, torch.bfloat16, xs.numel()),
                               ("ct", ct, torch.bfloat16, ct.numel()),
                               ("rowsum", rowsum, torch.float32, m),
                               ("colsum", colsum, torch.int32, n if physical_noise else 1),
                               ("sigma", sigma, torch.float32, 1)):
        if t.dtype != dt or t.device != xs.device or not t.is_contiguous() or t.numel() < numel:
            raise ValueError(f"crossbar_mac's {name} must be a contiguous {dt} tensor of "
                             f"{numel}+ elements on {xs.device}")
    four_ktdf, g0, g_ref, v_read, k_rows = noise_params
    out = torch.empty((m, n), dtype=torch.float32, device=xs.device)
    # every float argument rounds to f32 in ctypes, as the reference's
    # weakly typed Python floats round
    rc = _lib().crossbar_gemm_launch(
        xs.data_ptr(), ct.data_ptr(), rowsum.data_ptr(), colsum.data_ptr(), sigma.data_ptr(),
        out.data_ptr(), m, k, n, kp, -(-n // CROSSBAR_PAD_N) * CROSSBAR_PAD_N,
        seed & 0xFFFFFFFF, int(binarize), int(physical_noise), qstep, w_min + center * qstep,
        g0, 2.0 * k_rows * g_ref, four_ktdf, v_read * g0, geo["tile_n"],
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"crossbar_mac kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def crossbar_mac_cuda(
    x: torch.Tensor,        # (M, K) f32, contiguous, on the card
    w: torch.Tensor,        # (K, N) f32, contiguous, already range-normalized
    seed: int,              # uint32 noise seed
    sigma: torch.Tensor,    # one f32 on the card (read unless physical_noise)
    *,
    binarize: bool = True,
    physical_noise: bool = False,
    noise_params: tuple = (0.0, 1.0, 0.0, 1.0, 0),
    quantize: bool = True,
    qstep: float = 2.0 / 31,
    w_min: float = -1.0,
    w_max: float = 1.0,
) -> torch.Tensor:
    """The read on the current stream: the prepass and the tensor-core
    GEMM, or, unquantized, the f32 kernel; returns (M, N) f32.  Same
    contract as :func:`crossbar_mac_ref`."""
    global launches
    kw = dict(binarize=binarize, physical_noise=physical_noise, noise_params=noise_params)
    if quantize:
        parts = crossbar_prepass_cuda(x, w, qstep, w_min, w_max, physical_noise)
        return crossbar_gemm_cuda(*parts, x.shape[1], seed, sigma, **kw, qstep=qstep,
                                  w_min=w_min, w_max=w_max)
    m, k, n = _check(x, w)
    if sigma.device != x.device or sigma.dtype != torch.float32 or sigma.numel() != 1:
        raise ValueError("sigma must be one f32 value on the input's device")
    four_ktdf, g0, g_ref, v_read, k_rows = noise_params
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = _lib().crossbar_mac_f32_launch(
        x.data_ptr(), w.data_ptr(), sigma.data_ptr(), out.data_ptr(), m, k, n,
        -(-n // CROSSBAR_PAD_N) * CROSSBAR_PAD_N, seed & 0xFFFFFFFF, int(binarize),
        int(physical_noise), g0, 2.0 * k_rows * g_ref, four_ktdf, v_read * g0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"crossbar_mac f32 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
