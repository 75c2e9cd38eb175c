"""Pluggable device-backend seam behind the kernel wrappers
(``repro/kernels/backend.py``).

The public wrappers of :mod:`repro_torch.kernels.ops` (``crossbar_mac``,
``wta_counts``, ``stoch_round_serving``, ``paged_attention``,
``paged_prefill_attention``) do not call their implementations directly:
they ask the process-wide active :class:`DeviceBackend`.  Behind it the
rule of ``ops.py`` holds unchanged: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain version.  The seam is never a
fallback; no backend method catches a kernel's failure.

* :class:`SimBackend` (the default) routes every op to the ``*_sim``
  functions of ``ops.py``, the pre-seam wrappers, and carries **pure
  accounting**: host-side tallies of the analog events a served workload
  drives (crossbar tile reads, comparator decisions, input-DAC
  conversions, stochastic-rounding events), priced by the calibrated
  Table I constants of :mod:`repro_torch.core.cost_model`.
* :class:`FaultySimBackend` wraps the same math in a deterministic,
  seeded ReRAM fault model (stuck cells, conductance drift, read-noise
  inflation, comparator offset).

Two planes, kept apart as in the reference:

1. **Compute dispatch**: ``ops.crossbar_mac`` and the others call
   ``get_backend().<op>(...)`` when they run.  An eager call reads the
   backend of its moment; a captured CUDA graph keeps what was current at
   its capture, so the serving engine drops its graphs whenever a fault
   backend's ``fault_version`` moves.
2. **Event accounting** (host side): each serving engine owns a private
   backend (``ServeConfig.device_backend``) and notes analytical
   multiplicities per entry-point call (``launch/specs.analog_call_profile``),
   never padded slots, so ``totals == tokens_computed x per-token counts``
   exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import cost_model as CM
from repro_torch.core import physics as P


def _ops():
    # ops imports this module at load; the dispatch target is looked up
    # when a backend method runs
    from repro_torch.kernels import ops

    return ops


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of the deterministic ReRAM fault model (all zero => no fault).

    The model is applied in *conductance space* at the backend-dispatch
    layer: stuck-at cells pin G to G_min (SA0) / G_max (SA1), conductance
    drift multiplies G by a power-law factor of the host fault clock, and
    the readout knobs perturb the comparator operating point.  Every knob
    at its default leaves :class:`FaultySimBackend` bit-identical to
    :class:`SimBackend`.
    """

    seed: int = 0
    # fraction of cells stuck (split evenly SA0 / SA1), drawn once per
    # weight shape from a PCG64 stream keyed by (seed, shape)
    stuck_rate: float = 0.0
    # power-law drift exponent: G(t) = G(0) · (1 + clock)^(-drift_nu)
    drift_nu: float = 0.0
    # drift multiplier is quantized to this bucket so the engine only
    # rebuilds when the bucket crosses, not every tick
    drift_quant: float = 0.02
    # cycle-to-cycle read-noise sigma grows by (1 + inflation)
    read_sigma_inflation: float = 0.0
    # additive comparator threshold offset (z-units for WTA readout,
    # output units for the linear crossbar read)
    comparator_offset: float = 0.0
    # physical tile geometry for stuck-at density / retirement
    tile_rows: int = 128
    tile_cols: int = 128


class DeviceBackend:
    """Base: accounting surface (shared) + abstract compute dispatch."""

    name = "base"
    # True when the backend's compute methods differ from the plain sim
    # math: the engine then installs it process-wide around each tick.
    # Pure-accounting backends leave the process backend alone.
    overrides_compute = False

    def __init__(self, model_cfg: Optional[Any] = None):
        self.model_cfg = model_cfg
        if model_cfg is not None:
            self._per_tok = CM.per_token_analog_counts(model_cfg)
            self._per_sample = CM.per_sample_analog_counts(model_cfg)
            self._per_kv_tok = CM.per_kv_token_round_events(model_cfg)
            self._per_redundant = CM.per_redundant_read_counts(model_cfg)
        else:
            zero = CM.AnalogOpCounts()
            self._per_tok = self._per_sample = self._per_kv_tok = zero
            self._per_redundant = zero
        self.reset()

    # -- accounting (host-side, engine-driven) ------------------------------

    def reset(self) -> None:
        self._counts = CM.AnalogOpCounts()
        self._tokens = {"prefill": 0, "decode": 0, "draft": 0}
        self._sample_events = 0
        self._kv_written_tokens = 0
        self._redundant_reads = 0

    def note_call(self, profile: dict) -> None:
        """Record one device entry-point invocation.

        ``profile`` is ``launch/specs.analog_call_profile(...)``: token
        forwards per kind, sampling events, KV-writing tokens and extra
        comparator re-reads.  Counts accumulate as exact integer multiples
        of the per-token / per-sample / per-KV-token / per-re-read shape
        counts."""
        fwd = 0
        for kind in ("prefill", "decode", "draft"):
            n = profile[kind]
            self._tokens[kind] += n
            fwd += n
        redundant = profile.get("redundant", 0)
        self._sample_events += profile["samples"]
        self._kv_written_tokens += profile["kv_tokens"]
        self._redundant_reads += redundant
        self._counts = (
            self._counts
            + self._per_tok.scaled(fwd)
            + self._per_sample.scaled(profile["samples"])
            + self._per_kv_tok.scaled(profile["kv_tokens"])
            + self._per_redundant.scaled(redundant)
        )

    def events(self) -> CM.AnalogOpCounts:
        return self._counts

    def tokens_computed(self) -> dict:
        out = dict(self._tokens)
        out["total"] = sum(self._tokens.values())
        return out

    def snapshot(self, published_tokens: int = 0) -> dict:
        """Full accounting report: tallies, the per-event shape counts they
        reconcile against, and Table I pricing under both readout schemes
        (a model of the paper's accelerator, not a measurement)."""
        c = self._counts
        prices = CM.price_counts(c)
        denom = max(published_tokens, 1)

        def scheme(energy_pj: float) -> dict:
            return {
                "energy_pj_gross": energy_pj,
                "energy_pj_per_token": energy_pj / denom,
                "tops_per_w_effective": CM.effective_tops_per_w(c, energy_pj),
            }

        return {
            "backend": self.name,
            "tokens_computed": self.tokens_computed(),
            "tokens_published": published_tokens,
            "sample_events": self._sample_events,
            "kv_written_tokens": self._kv_written_tokens,
            "redundant_read_events": self._redundant_reads,
            "counts": c.as_dict(),
            "per_token_counts": self._per_tok.as_dict(),
            "per_sample_counts": self._per_sample.as_dict(),
            "per_kv_token_counts": self._per_kv_tok.as_dict(),
            "per_redundant_counts": self._per_redundant.as_dict(),
            "raca": scheme(prices["raca_energy_pj"]),
            "adc1b": scheme(prices["adc1b_energy_pj"]),
        }

    # -- compute dispatch ---------------------------------------------------

    def wta_readout_params(self, vth0: float, sigma_z: float):
        """Comparator operating point seen by WTA readout heads, asked by
        ``launch/specs.sample_tokens`` (which races the threefry trials,
        not ``ops.wta_counts``) so fault backends reach the serving
        sampler.  The identity on non-faulty backends."""
        return vth0, sigma_z

    def crossbar_mac(self, x, w, key, cfg, binarize=True):
        raise NotImplementedError

    def wta_counts(self, z, seed, *, n_trials, vth0, sigma_z):
        raise NotImplementedError

    def stoch_round_serving(self, x, seeds, *, step, lo, hi):
        raise NotImplementedError

    def paged_attention(self, q, k_pages, v_pages, table, pos, **kw):
        raise NotImplementedError

    def paged_prefill_attention(self, q, k_pages, v_pages, table, q0, **kw):
        raise NotImplementedError


class SimBackend(DeviceBackend):
    """Default backend: the ``*_sim`` functions of ``ops.py`` (the
    hand-written kernel on the card, the plain version on the CPU),
    accounting only."""

    name = "sim"

    def crossbar_mac(self, x, w, key, cfg, binarize=True):
        return _ops().crossbar_mac_sim(x, w, key, cfg, binarize)

    def wta_counts(self, z, seed, *, n_trials, vth0, sigma_z):
        return _ops().wta_counts_sim(z, seed, n_trials=n_trials, vth0=vth0, sigma_z=sigma_z)

    def stoch_round_serving(self, x, seeds, *, step, lo, hi):
        return _ops().stoch_round_serving_sim(x, seeds, step=step, lo=lo, hi=hi)

    def paged_attention(self, q, k_pages, v_pages, table, pos, **kw):
        return _ops().paged_attention_sim(q, k_pages, v_pages, table, pos, **kw)

    def paged_prefill_attention(self, q, k_pages, v_pages, table, q0, **kw):
        return _ops().paged_prefill_attention_sim(q, k_pages, v_pages, table, q0, **kw)


class FaultySimBackend(SimBackend):
    """Sim math wrapped in a deterministic, seeded ReRAM fault model.

    * **stuck-at cells**: per-shape SA0/SA1 masks drawn once from a PCG64
      stream keyed by ``(seed, *shape)`` (numpy, so the bits are the
      reference's); stuck cells read back as exactly ``w_min``/``w_max``
      in normalized conductance units.  Each mask moves to a device once
      and stays there.
    * **conductance drift**: a multiplicative power-law factor of the
      host fault clock (``advance_clock``), quantized to ``drift_quant``
      buckets; a bucket crossing bumps ``fault_version``.
    * **read-noise inflation**: calibrated binarized reads see
      ``beta/(1+i)``, calibrated linear reads ``linear_sigma·(1+i)``,
      physical reads a temperature raised by ``(1+i)²`` (σ ∝ √T).
    * **comparator offset**: added to the WTA threshold and to the linear
      crossbar readout (the binarized crossbar's internal comparator
      offset is not modelled, as in the reference).

    With every knob at zero each compute method delegates with unmodified
    arguments, so the results are :class:`SimBackend`'s bit for bit.
    ``fault_version`` moves on every change that alters the math (drift
    bucket, retirement, degrade/recover); the serving engine checks it
    each tick and drops what it compiled under the old state.
    """

    name = "sim_faulty"
    overrides_compute = True

    def __init__(self, model_cfg: Optional[Any] = None, fault: Optional[FaultConfig] = None):
        self.fault = fault if fault is not None else FaultConfig()
        self._clock = 0
        self._overrides: dict = {}
        self._stuck_maps: dict = {}     # (K, N) -> (sa0, sa1) bool ndarrays
        self._device_maps: dict = {}    # ((K, N), device) -> (sa0, sa1) bool tensors
        self._retired: set = set()      # ((K, N), tile_i, tile_j)
        self.fault_version = 0
        self._drift_mult_q = self._drift_mult()
        super().__init__(model_cfg)

    # -- fault-state host API ------------------------------------------------

    def _knob(self, name: str) -> float:
        return self._overrides.get(name, getattr(self.fault, name))

    def _drift_mult(self) -> float:
        nu = self._knob("drift_nu")
        if nu <= 0.0 or self._clock <= 0:
            return 1.0
        m = (1.0 + self._clock) ** (-nu)
        q = self.fault.drift_quant
        if q > 0.0:
            m = max(q, round(m / q) * q)
        return m

    def _refresh(self) -> None:
        new = self._drift_mult()
        if new != self._drift_mult_q:
            self._drift_mult_q = new
            self.fault_version += 1

    def advance_clock(self, n: int = 1) -> None:
        """Tick the host-side fault clock; drift follows the power law."""
        self._clock += int(n)
        self._refresh()

    def degrade(self, clock: Optional[int] = None, **knobs) -> None:
        """Jump the fault clock and/or override readout knobs (injector
        kind ``degrade_device``).  Always bumps ``fault_version``."""
        allowed = {"read_sigma_inflation", "comparator_offset", "drift_nu"}
        bad = sorted(set(knobs) - allowed)
        if bad:
            raise ValueError(f"degrade: unknown knob(s) {bad}; allowed: {sorted(allowed)}")
        if clock is not None:
            self._clock = int(clock)
        self._overrides.update(knobs)
        self._drift_mult_q = self._drift_mult()
        self.fault_version += 1

    def recover(self) -> None:
        """Reset the fault clock and drop knob overrides (injector kind
        ``recover_device``).  Tile retirement persists: remapping to a
        spare tile is a physical, one-way operation."""
        self._clock = 0
        self._overrides.clear()
        self._drift_mult_q = self._drift_mult()
        self.fault_version += 1

    def _stuck_masks(self, shape):
        """The host (sa0, sa1) masks of a 2-D weight shape, or (None, None)."""
        rate = self.fault.stuck_rate
        if rate <= 0.0 or len(shape) != 2:
            return None, None
        if shape not in self._stuck_maps:
            rng = np.random.default_rng([self.fault.seed, *shape])
            u = rng.random(shape)
            self._stuck_maps[shape] = (u < rate / 2.0, (u >= rate / 2.0) & (u < rate))
        return self._stuck_maps[shape]

    def _device_masks(self, shape, device: torch.device):
        """The masks of ``shape`` on ``device``, copied there once."""
        sa0, sa1 = self._stuck_masks(shape)
        if sa0 is None:
            return None, None
        key = (shape, device)
        if key not in self._device_maps:
            self._device_maps[key] = (torch.from_numpy(sa0).to(device),
                                      torch.from_numpy(sa1).to(device))
        return self._device_maps[key]

    def stuck_cell_count(self) -> int:
        return sum(int(sa0.sum()) + int(sa1.sum()) for sa0, sa1 in self._stuck_maps.values())

    @property
    def retired_tiles(self) -> int:
        return len(self._retired)

    def retire_tiles(self, threshold: float) -> int:
        """Retire (remap-to-spare) tiles whose stuck-at density reaches
        ``threshold``: their stuck masks are cleared, so reads behave as a
        healthy spare tile.  Returns the number of newly retired tiles and
        bumps ``fault_version`` when any mask changed."""
        if threshold <= 0.0:
            return 0
        tr, tc = self.fault.tile_rows, self.fault.tile_cols
        newly = 0
        for shape, (sa0, sa1) in self._stuck_maps.items():
            rows, cols = shape
            for ti in range(0, rows, tr):
                for tj in range(0, cols, tc):
                    tile = (shape, ti // tr, tj // tc)
                    if tile in self._retired:
                        continue
                    sl = (slice(ti, ti + tr), slice(tj, tj + tc))
                    cells = sa0[sl].size
                    stuck = int(sa0[sl].sum()) + int(sa1[sl].sum())
                    if cells and stuck / cells >= threshold:
                        sa0[sl] = False
                        sa1[sl] = False
                        self._retired.add(tile)
                        newly += 1
        if newly:
            self._device_maps.clear()   # copied again, once, on next use
            self.fault_version += 1
        return newly

    def fault_state(self) -> dict:
        return {
            "clock": self._clock,
            "drift_mult": self._drift_mult_q,
            "fault_version": self.fault_version,
            "retired_tiles": self.retired_tiles,
            "stuck_cells": self.stuck_cell_count(),
            "overrides": dict(self._overrides),
        }

    # -- faulty compute dispatch --------------------------------------------

    def _weight_faults_active(self) -> bool:
        return self.fault.stuck_rate > 0.0 or self._drift_mult_q != 1.0

    def _faulty_weights(self, w: torch.Tensor) -> torch.Tensor:
        """Crossbar weights as the devices would read them back, in torch
        ops on ``w``'s device and dtype: drift first (multiplicative in
        conductance space), stuck cells override.  The normalization scale
        is the original max|w| (detached), so stuck cells land exactly on
        ``w_min``/``w_max`` in device units."""
        if not self._weight_faults_active():
            return w
        dp = P.DeviceParams()
        s = w.detach().abs().amax().clamp_min(1e-6)
        wn = w / s
        m = self._drift_mult_q
        if m != 1.0:
            wn = P.weight_from_conductance(m * P.weight_to_conductance(wn, dp), dp)
        sa0, sa1 = self._device_masks(tuple(w.shape), w.device)
        if sa0 is not None:
            wn = torch.where(sa0, dp.w_min, wn)
            wn = torch.where(sa1, dp.w_max, wn)
        return (wn * s).to(w.dtype)

    def wta_readout_params(self, vth0: float, sigma_z: float):
        return (
            vth0 + self._knob("comparator_offset"),
            sigma_z * (1.0 + self._knob("read_sigma_inflation")),
        )

    def crossbar_mac(self, x, w, key, cfg, binarize=True):
        ops = _ops()
        infl = self._knob("read_sigma_inflation")
        off = self._knob("comparator_offset")
        if not (self._weight_faults_active() or infl or off):
            return ops.crossbar_mac_sim(x, w, key, cfg, binarize)
        w = self._faulty_weights(w)
        if infl:
            if cfg.calibrated and binarize:
                cfg = dataclasses.replace(cfg, beta=cfg.beta / (1.0 + infl))
            elif cfg.calibrated:
                cfg = dataclasses.replace(cfg, linear_sigma=cfg.linear_sigma * (1.0 + infl))
            else:
                dev = cfg.device.replace(temperature=cfg.device.temperature * (1.0 + infl) ** 2)
                cfg = dataclasses.replace(cfg, device=dev)
        y = ops.crossbar_mac_sim(x, w, key, cfg, binarize)
        if off and not binarize:
            y = y + off
        return y

    def wta_counts(self, z, seed, *, n_trials, vth0, sigma_z):
        vth0, sigma_z = self.wta_readout_params(vth0, sigma_z)
        return _ops().wta_counts_sim(z, seed, n_trials=n_trials, vth0=vth0, sigma_z=sigma_z)

    # stoch_round_serving and paged_(prefill_)attention are digital-domain
    # ops (counters, SRAM attention): the inherited sim paths.


BACKENDS = {"sim": SimBackend, "sim_faulty": FaultySimBackend}

_ACTIVE: DeviceBackend = SimBackend()


def make_backend(name: str, model_cfg: Optional[Any] = None, **kw) -> DeviceBackend:
    """Instantiate a registered backend (loud on unknown names); keyword
    arguments go to its constructor, e.g. ``make_backend("sim_faulty", cfg,
    fault=FaultConfig(...))``."""
    if name not in BACKENDS:
        raise ValueError(f"unknown device backend {name!r}; registered: {sorted(BACKENDS)}")
    return BACKENDS[name](model_cfg, **kw)


def get_backend() -> DeviceBackend:
    """The process-wide backend the ``ops.py`` wrappers route through."""
    return _ACTIVE


def set_backend(backend: DeviceBackend) -> DeviceBackend:
    """Install a backend process-wide; returns the previous one.  Eager
    calls see it at once; a captured CUDA graph keeps the backend of its
    capture."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = backend
    return prev


@contextlib.contextmanager
def use_backend(backend: DeviceBackend):
    """Scoped install: the previous process-wide backend is restored
    however the body leaves, so a raising engine tick cannot leak a faulty
    backend into later work."""
    prev = set_backend(backend)
    try:
        yield backend
    finally:
        set_backend(prev)
