"""The port's hand-written kernels at the reference bench's shapes
(``benchmarks/bench_kernels.py``): ``ops.crossbar_mac`` (prepass + tensor-core
GEMM, comparator readout) at 256x1024x512 and 1024x4096x1024,
``ops.wta_counts`` at (256, 128) with 64 trials, and ``ops.stoch_round_serving``
at 2048².  On the card each row is the mean of ``N_CALLS`` back-to-back
calls between CUDA events, after a warm-up call; on the CPU the wrappers
run their plain versions, timed on the host clock.

The derived column gives the work and the H100 bound in µs, under
``PERF.md`` §6's conventions (H100 SXM: 3.35 TB/s, 989 dense bf16
TFLOP/s, 16 SFU results per clock per SM at 1.98 GHz): the crossbar read
as three bf16 passes of x (``3·2·MKN`` operations) or its bytes
(``4·(MK + KN + MN)``), whichever takes longer; the WTA votes as 3
transcendentals a trial-element on the SFU; the rounding as one f32 read
and one f32 write of each element.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import random as R
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.physics import DeviceParams, calibrate_v_read
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.prng import key_to_seed

from . import synchronize

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
N_CALLS = 3


def _time_us(f, device: torch.device) -> float:
    n = N_CALLS
    f()  # warm-up: library load, first-call setup
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n * 1e3
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        f()
    return (time.perf_counter() - t0) / n * 1e6


def crossbar_bound_us(m: int, k: int, n: int) -> float:
    return max(3 * 2 * m * k * n / BF16_FLOPS_PER_S,
               4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S) * 1e6


class Case(NamedTuple):
    """One row's work: the wrapper as the bench calls it, its plain version
    and (where one computes the same product) the library call on the same
    inputs, the H100 bound and the derived column."""

    name: str
    call: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Optional[Callable[[], torch.Tensor]]
    bound_us: float
    derived: str


def cases(dev: torch.device) -> list[Case]:
    """The bench's calls at the reference's shapes, keys and scalings."""
    cfg = AnalogConfig(
        mode="analog_stochastic",
        device=calibrate_v_read(DeviceParams(), 1024),
        use_pallas="off",
    )
    key = R.PRNGKey(0)
    seed = key_to_seed(key)
    seeds = ops._seed_tensor(seed, dev)
    out = []

    def crossbar(m, k, n):
        x = R.normal(key, (m, k), dev)
        w = R.normal(R.PRNGKey(1), (k, n), dev) * 0.05
        bound = crossbar_bound_us(m, k, n)
        return Case(f"crossbar_mac_{m}x{k}x{n}",
                    lambda: ops.crossbar_mac(x, w, key, cfg, True),
                    lambda: ops.crossbar_mac_reference(x, w, key, cfg, True),
                    lambda: x @ w, bound,
                    f"flops={2 * m * k * n:.2e} h100_bound_us={bound:.2f}")

    out += [crossbar(256, 1024, 512), crossbar(1024, 4096, 1024)]

    z = R.normal(key, (256, 128), dev)
    wta_kw = dict(n_trials=64, vth0=2.897, sigma_z=1.702)
    bound = 3 * 256 * 128 * 64 / SFU_OPS_PER_S * 1e6
    out.append(Case("wta_counts_256x128_T64",
                    lambda: ops.wta_counts(z, seed, **wta_kw),
                    lambda: ref.wta_counts_ref(z, seeds, **wta_kw), None, bound,
                    f"bytes={256 * 128 * 4 * 64:.2e} h100_bound_us={bound:.2f}"))

    xr = R.normal(key, (2048, 2048), dev)
    sr_kw = dict(step=2 / 31, lo=-1, hi=1)
    nbytes = 2048 * 2048 * 8
    bound = nbytes / HBM_BYTES_PER_S * 1e6
    out.append(Case("stoch_round_2048x2048",
                    lambda: ops.stoch_round_serving(xr, seed, **sr_kw),
                    lambda: ref.stoch_round_ref(xr, seeds, **sr_kw), None, bound,
                    f"bytes={nbytes:.2e} h100_bound_us={bound:.2f}"))
    return out


@torch.no_grad()
def run(device=None) -> list[tuple[str, float, str]]:
    dev = resolve_device(device)
    return [(c.name, _time_us(c.call, dev), c.derived) for c in cases(dev)]
