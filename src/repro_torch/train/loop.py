"""The fault-tolerant training loop (``repro/train/loop.py``).

- Checkpoint and restart: an async :class:`CheckpointManager` (atomic
  writes, the last three kept) and auto-resume from the latest step on
  every (re)start.  The data pipeline is stateless (a batch is a function
  of its step), so a resumed run consumes exactly the batches it would
  have, and the step keys are ``fold_in(rng, step)``: a resumed analog run
  redraws the same crossbar noise.
- Fault injection: ``LoopConfig.fault_inject_step`` or the
  ``FAULT_INJECT_STEP`` environment variable raises once, before that
  step; the retry reloads the last checkpoint, up to ``max_restarts``.
- Stragglers: a step slower than ``straggler_factor`` times the EMA of
  step times is logged and counted.  A step's time runs to the host read
  of its loss, which waits for the card.

Checkpoints are host-gathered and so restore on any device and onto any
mesh.  ``run(..., mesh=)`` is the counterpart of the reference's
``state_shardings``: the port passes the ``(data, model)`` DeviceMesh and
derives the placements (``launch/sharding.state_shardings``); a fresh
state is seeded identically on every rank and placed, a resume or a
restart loads each rank's blocks of the latest checkpoint, saves gather on
every rank and write on rank 0.  Every rank runs the loop and keeps its
own stats.  Besides the reference's stats (``losses``, ``restarts``,
``stragglers``), :func:`run` records each step's seconds (``step_s``),
each restart's (``restart_s``: the fresh state's init, the load, their
sum), each save's (``saves``, from :class:`CheckpointManager`) and, on a
mesh, the rank (``rank``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SH
from repro_torch.models import ModelConfig
from repro_torch.testing import InjectedFault, StepFaultInjector, fault_step_from_env

from .step import TrainConfig, TrainState, init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str = "ckpts"
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 2.0
    fault_inject_step: Optional[int] = None  # raise once at this step
    max_restarts: int = 3
    seed: int = 0


class StragglerMonitor:
    def __init__(self, factor: float):
        self.factor = factor
        self.ema: Optional[float] = None
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        if slow:
            self.flagged += 1
            log.warning(
                "straggler step: %.3fs vs EMA %.3fs (flagged=%d)",
                dt, self.ema, self.flagged,
            )
        return slow


# the reference's alias: tests and callers catch the shared exception type
_InjectedFault = InjectedFault


def run(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    loop_cfg: LoopConfig,
    batch_fn: Callable[[int], dict],
    step_fn=None,
    state: Optional[TrainState] = None,
    device=None,
    mesh=None,
) -> tuple[TrainState, dict]:
    """Run (or resume) training on ``device`` (the card unless ``"cpu"``),
    on ``mesh`` when one is given (the same device type); returns (final
    state, stats).  ``batch_fn(step)`` gives the step's batch on that
    device, whole on every rank."""
    dev = resolve_device(device)
    step_fn = step_fn or make_train_step(model_cfg, train_cfg)
    mgr = CheckpointManager(loop_cfg.ckpt_dir)
    monitor = StragglerMonitor(loop_cfg.straggler_factor)
    stats = {"losses": [], "restarts": 0, "stragglers": 0,
             "step_s": [], "restart_s": [], "saves": mgr.saves}
    if mesh is not None:
        import torch.distributed as dist

        stats["rank"] = dist.get_rank()

    injector = StepFaultInjector(fault_step_from_env(loop_cfg.fault_inject_step))

    restarts = 0
    while True:
        try:
            if state is None:
                t0 = time.perf_counter()
                last = latest_step(loop_cfg.ckpt_dir)
                fresh = init_train_state(loop_cfg.seed, model_cfg, train_cfg, device=dev,
                                         mesh=mesh)
                t1 = time.perf_counter()
                if last is not None:
                    log.info("resuming from checkpoint step %d", last)
                    state = load_checkpoint(loop_cfg.ckpt_dir, last, fresh, shardings=None if mesh is None
                                            else SH.state_shardings(fresh, mesh, model_cfg))
                else:
                    state = fresh
                del fresh
                if restarts:
                    t2 = time.perf_counter()
                    stats["restart_s"].append(
                        {"step": last, "init_s": t1 - t0, "load_s": t2 - t1, "total_s": t2 - t0})

            while state.step < loop_cfg.steps:
                step = state.step
                batch = batch_fn(step)
                t0 = time.perf_counter()
                injector.check(step)  # raises InjectedFault exactly once
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                stats["step_s"].append(dt)
                if monitor.observe(dt):
                    stats["stragglers"] += 1
                stats["losses"].append((step, loss))
                if step % loop_cfg.log_every == 0:
                    log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
                if (step + 1) % loop_cfg.ckpt_every == 0:
                    mgr.save_async(step + 1, state)
            break
        except _InjectedFault as e:
            restarts += 1
            stats["restarts"] = restarts
            log.warning("fault: %s — restart %d", e, restarts)
            if restarts > loop_cfg.max_restarts:
                raise
            mgr.wait()
            state = None  # force reload from latest checkpoint

    mgr.wait()
    mgr.save_async(state.step, state)
    mgr.wait()
    return state, stats
