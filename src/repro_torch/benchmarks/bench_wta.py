"""Fig. 5: WTA stochastic SoftMax neuron statistics, as
``benchmarks/bench_wta.py``: (a) one winner per trial, (b) TV distance of
the cumulative vote distribution from the ideal SoftMax as trials grow,
(c) argmax agreement.  The trials run through ``ops.wta_trial_counts``
(the ``wta_sample`` kernel on the card).
"""

from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core import wta
from repro_torch.device import resolve_device

from . import wall_us


def run(device=None) -> list[tuple[str, float, str]]:
    dev = resolve_device(device)
    rows = []
    z = R.normal(R.PRNGKey(3), (10,), dev)
    sm = torch.softmax(z, dim=-1)
    theta = wta.calibrated_threshold()

    res, dt = wall_us(lambda: wta.wta_trials(R.PRNGKey(0), z, 100, theta), dev)
    one_winner = float(res.counts.sum()) == float(res.n_decisions)
    rows.append(
        ("wta_100_trials", dt,
         f"one_winner_per_trial={one_winner} "
         f"decision_rate={float(res.n_decisions) / 100:.2f}")
    )

    for t in (100, 1000, 10000, 40000):
        res = wta.wta_trials(R.PRNGKey(1), z, t, theta)
        tv = 0.5 * float((res.probs - sm).abs().sum())
        agree = int(torch.argmax(res.probs)) == int(torch.argmax(sm))
        rows.append(
            (f"wta_tv_vs_softmax_T{t}", 0.0,
             f"tv={tv:.4f} argmax_agree={agree}")
        )

    ana = wta.wta_expected_probs(z, theta)
    tv_ana = 0.5 * float((ana - sm).abs().sum())
    rows.append(("wta_analytic_vs_softmax", 0.0, f"tv={tv_ana:.4f}"))
    return rows
