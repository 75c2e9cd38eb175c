"""Fig. 4: stochastic Sigmoid neuron fidelity vs the four SNR knobs (V_r,
G0 via the conductance range, Δf, N_col), as ``benchmarks/bench_sigmoid.py``.

Reports, per knob setting, the RMS error between the comparator's fire
probability and the ideal logistic, on the reference's inputs (threefry
``normal`` weights, ``uniform`` inputs, both drawn bit for bit).
"""

from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core import crossbar, neurons, physics
from repro_torch.device import resolve_device

from . import wall_us


def _fit_rmse(dp: physics.DeviceParams, n_rows: int, device: torch.device) -> float:
    w = R.normal(R.PRNGKey(0), (n_rows, 128), device) * (2.0 / n_rows) ** 0.5 * 4
    x = R.uniform(R.PRNGKey(1), (256, n_rows), device) < 0.3
    m = crossbar.map_weights(w, dp)
    z = x.to(torch.float32) @ m.w_eff
    p = neurons.fire_probability_physical(z, crossbar.column_sum_g(m), dp)
    return float(torch.sqrt(torch.mean((p - torch.sigmoid(z)) ** 2)))


def run(device=None) -> list[tuple[str, float, str]]:
    dev = resolve_device(device)
    rows = []
    n0 = 784
    cal = physics.calibrate_v_read(physics.DeviceParams(), n0)

    base, dt_us = wall_us(lambda: _fit_rmse(cal, n0, dev), dev)
    rows.append(("sigmoid_fit_calibrated", dt_us, f"rmse={base:.4f}"))

    # Fig 4(c): read-voltage sweep — ±2x detunes the logistic slope
    for f in (0.5, 2.0):
        r = _fit_rmse(cal.replace(v_read=cal.v_read * f), n0, dev)
        rows.append((f"sigmoid_fit_vr_x{f}", 0.0, f"rmse={r:.4f}"))
    # Fig 4(d): G0 sweep via conductance range
    r = _fit_rmse(physics.calibrate_v_read(physics.DeviceParams(g_max=2e-4), n0), n0, dev)
    rows.append(("sigmoid_fit_g0_recal", 0.0, f"rmse={r:.4f}"))
    # Fig 4(e): bandwidth sweep (recalibrated -> fit restored)
    r = _fit_rmse(physics.calibrate_v_read(physics.DeviceParams(delta_f=4e9), n0), n0, dev)
    rows.append(("sigmoid_fit_df_recal", 0.0, f"rmse={r:.4f}"))
    # Fig 4(f): column length sweep
    for n in (256, 1568):
        r = _fit_rmse(physics.calibrate_v_read(physics.DeviceParams(), n), n, dev)
        rows.append((f"sigmoid_fit_ncol_{n}", 0.0, f"rmse={r:.4f}"))

    # detuned (uncalibrated) should be clearly worse than calibrated
    r_detuned = _fit_rmse(cal.replace(v_read=cal.v_read * 4), n0, dev)
    rows.append(
        ("sigmoid_fit_detuned_x4", 0.0,
         f"rmse={r_detuned:.4f} (vs {base:.4f} calibrated)")
    )
    return rows
