"""Table I: hardware metrics of the 1-bit-ADC design vs RACA, as
``benchmarks/bench_cost_model.py`` (the port's copy of the cost model: a
model of the paper's accelerator, not a measurement of any device)."""

from __future__ import annotations

from repro_torch.core import cost_model as CM


def run(device=None) -> list[tuple[str, float, str]]:
    t = CM.table1()
    a, r = t["adc1b"], t["raca"]
    rows = [
        ("table1_adc1b", 0.0,
         f"E={a.energy_pj:.3e}pJ A={a.area_mm2:.2f}mm2 "
         f"eff={a.tops_per_w:.1f}TOPS/W"),
        ("table1_raca", 0.0,
         f"E={r.energy_pj:.3e}pJ A={r.area_mm2:.2f}mm2 "
         f"eff={r.tops_per_w:.1f}TOPS/W"),
        ("table1_changes", 0.0,
         f"energy{t['energy_change_pct']:+.2f}% "
         f"area{t['area_change_pct']:+.2f}% "
         f"eff{t['efficiency_change_pct']:+.2f}% "
         "(paper: -58.29/-38.43/+142.37)"),
    ]
    return rows
