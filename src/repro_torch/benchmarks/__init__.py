"""The paper's benches on the port (``benchmarks/`` of the reference), one
module per table or figure, each with ``run(device=None)`` returning
``(name, us_per_call, derived)`` rows under the reference's names:

    bench_sigmoid        — Fig. 4 (sigmoid-neuron fidelity vs SNR knobs)
    bench_wta            — Fig. 5 (WTA vote statistics vs softmax)
    bench_fcnn_accuracy  — Fig. 6 (accuracy vs votes / threshold / SNR)
    bench_cost_model     — Table I (energy / area / TOPS-W)
    bench_kernels        — the hand-written kernels, with their H100 bounds
    bench_serving        — the serving engines under load (``run(device,
                           dry_run)`` returns its rows and a report)

``python -m repro_torch.benchmarks.run [--device cpu]`` prints them all.
A row's ``us_per_call`` is wall time up to a device synchronize
(``bench_kernels``: CUDA events on the card).
"""

import time

import torch


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_us(fn, device: torch.device):
    """(``fn()``'s result, its wall time in µs up to a synchronize)."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, (time.perf_counter() - t0) * 1e6
