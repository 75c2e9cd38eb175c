"""The port's copy of the Table I cost model (``repro_torch.core.cost_model``)
against ``repro.core.cost_model``: standard-library arithmetic on the same
Python floats, so every number must be equal to the last bit (``==``,
no tolerance)."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import cost_model as JCM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import cost_model as TCM

LAYERS = [(784, 500, 300, 10), (784, 10), (64, 32, 10), (1024, 4096, 4096, 1000), (129, 257, 3)]
VARIANTS = ["bf16", "int8", "wta_head", "wta_head_int8"]
COUNT_FNS = ["per_token_analog_counts", "per_sample_analog_counts",
             "per_redundant_read_counts", "per_kv_token_round_events"]


def _cfgs(smoke: bool, variant: str):
    jcfg = (jax_smoke if smoke else jax_config)("stablelm-3b")
    tcfg = (get_smoke_config if smoke else get_config)("stablelm-3b")
    kw = {"kv_cache_dtype": "int8" if "int8" in variant else "same",
          "wta_head": variant.startswith("wta_head")}
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _plain(v):
    """A value with the packages' own dataclasses turned into dicts."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def test_constants_equal():
    names = [n for n in vars(JCM) if n.isupper() and not n.startswith("_")]
    assert len(names) > 10
    for n in names:
        assert _plain(getattr(TCM, n)) == _plain(getattr(JCM, n)), n
    assert TCM._REF_COUNTS == JCM._REF_COUNTS


@pytest.mark.parametrize("layers", LAYERS, ids=str)
def test_table1_equal_to_the_last_bit(layers):
    j, t = JCM.table1(layers), TCM.table1(layers)
    for k in ("adc1b", "raca"):
        assert dataclasses.asdict(t[k]) == dataclasses.asdict(j[k]), k
    for k in ("energy_change_pct", "area_change_pct", "efficiency_change_pct"):
        assert t[k] == j[k], k
    for trials in (1, 10, 64):
        assert (dataclasses.asdict(TCM.cost_raca(layers, trials))
                == dataclasses.asdict(JCM.cost_raca(layers, trials)))


def test_table1_lands_on_the_paper():
    """The calibration the copy carries reproduces Table I as the
    reference's does (``tests/test_cost_model.py``'s bounds)."""
    t = TCM.table1()
    for k in ("adc1b", "raca"):
        got, want = t[k], TCM.PAPER_TABLE1[k]
        assert abs(got.energy_pj / want.energy_pj - 1) < 0.01
        assert abs(got.area_mm2 / want.area_mm2 - 1) < 0.01
        assert abs(got.tops_per_w / want.tops_per_w - 1) < 0.01


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fn", COUNT_FNS)
def test_per_kind_counts_equal(smoke, variant, fn):
    jcfg, tcfg = _cfgs(smoke, variant)
    assert getattr(TCM, fn)(tcfg).as_dict() == getattr(JCM, fn)(jcfg).as_dict()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_weight_matmuls_equal(smoke):
    jcfg, tcfg = _cfgs(smoke, "bf16")
    assert TCM.per_token_weight_matmuls(tcfg) == JCM.per_token_weight_matmuls(jcfg)
    if not smoke:   # stablelm-3b: 32 units of 7 projections, then the head
        assert len(TCM.per_token_weight_matmuls(tcfg)) == 32 * 7 + 1


def test_unknown_layer_kind_raises_as_the_reference():
    _, tcfg = _cfgs(True, "bf16")
    bad = dataclasses.replace(tcfg, layer_pattern=("conv",), n_layers=2)
    with pytest.raises(ValueError, match="unknown layer kind 'conv'"):
        TCM.per_token_weight_matmuls(bad)


@pytest.mark.parametrize("seed", range(4))
def test_price_counts_and_tops_per_w_equal(seed):
    rng = np.random.default_rng(seed)
    fields = [f.name for f in dataclasses.fields(TCM.AnalogOpCounts)]
    vals = {f: int(v) for f, v in zip(fields, rng.integers(0, 10**12, len(fields)))}
    tc, jc = TCM.AnalogOpCounts(**vals), JCM.AnalogOpCounts(**vals)
    tp, jp = TCM.price_counts(tc), JCM.price_counts(jc)
    assert tp == jp
    for k in ("raca_energy_pj", "adc1b_energy_pj"):
        assert TCM.effective_tops_per_w(tc, tp[k]) == JCM.effective_tops_per_w(jc, jp[k])
    assert TCM.AnalogOpCounts.from_dict(tc.as_dict()) == tc
    assert (tc + tc.scaled(3)).as_dict() == (jc + jc.scaled(3)).as_dict()
    assert TCM.effective_tops_per_w(TCM.AnalogOpCounts(), 0.0) == 0.0
