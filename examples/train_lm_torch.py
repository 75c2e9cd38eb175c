"""Train a ~100M-parameter LM (stablelm-100m, a scaled-down member of the
stablelm family) on the PyTorch/CUDA port, through the fault-tolerant
loop (checkpoints + resume), on the synthetic Markov-zipf stream,
optionally with the paper's analog-stochastic projections (noise-aware
QAT for RACA deployment), as ``examples/train_lm.py`` does on the
reference.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --analog

With ``--analog`` every projection reads through the ``crossbar_mac``
kernel on the card.  A rerun with the same ``--ckpt-dir`` resumes from
the latest checkpoint there.  The weights are the port's seeded random
init (seed 0).
"""

import argparse
import dataclasses
import logging

from repro_torch.configs import get_config
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.physics import DeviceParams, calibrate_v_read
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig
from repro_torch.train.loop import LoopConfig, run


def small_lm(analog: bool):
    """~100M-param member of the stablelm family."""
    cfg = dataclasses.replace(
        get_config("stablelm-3b"),
        name="stablelm-100m",
        n_layers=8,
        d_model=640,
        n_heads=8,
        n_kv_heads=8,
        d_head=80,
        d_ff=1728,
        vocab=50304,
        max_seq=2048,
        dtype="float32",
    )
    if analog:
        cfg = dataclasses.replace(
            cfg,
            analog=AnalogConfig(
                mode="analog_stochastic",
                device=calibrate_v_read(DeviceParams(), cfg.d_model),
                use_pallas="auto",
            ),
        )
    return cfg


def train_config(steps: int) -> TrainConfig:
    return TrainConfig(opt=AdamWConfig(lr=3e-4), total_steps=steps, warmup_steps=20)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--analog", action="store_true",
                    help="RACA analog-stochastic projections (QAT)")
    ap.add_argument("--ckpt-dir", default="ckpts/lm")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted, 'cpu' for the plain PyTorch path")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    dev = resolve_device(args.device)

    cfg = small_lm(args.analog)
    n = cfg.param_count()
    print(f"model: {cfg.name} ({n / 1e6:.1f}M params, analog={cfg.analog.mode})")
    tcfg = train_config(args.steps)
    lcfg = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10)
    state, stats = run(
        cfg, tcfg, lcfg,
        batch_fn=lambda step: lm_batch(cfg, batch=args.batch, seq=args.seq, step=step, device=dev),
        device=dev,
    )
    losses = stats["losses"]
    first = sum(l for _, l in losses[:10]) / max(len(losses[:10]), 1)
    last = sum(l for _, l in losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"loss: first10={first:.4f} last10={last:.4f} (improved {first - last:+.4f})")
    return state, stats


if __name__ == "__main__":
    main()
