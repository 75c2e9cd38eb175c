"""Training launcher: the training step looped over synthetic batches (LM
tokens, or MNIST-surrogate images for ``fcnn-mnist``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        [--smoke] [--analog] [--device cpu] [--steps 100] [--batch 8] \\
        [--seq 128] [--lr 3e-4] [--microbatches 1]
    PYTHONPATH=src python -m repro_torch.launch.train --arch fcnn-mnist \\
        [--smoke] [--device cpu] [--steps 100] [--batch 8]

Takes the reference's flags (``repro/launch/train.py``) and adds
``--device``; runs on the card unless ``--device cpu`` is given.
``--analog`` trains an LM in RACA analog-stochastic mode (noise-aware
QAT): every projection goes through the crossbar kernel; ``fcnn-mnist``'s
config is analog already (``--analog`` is refused there).  An LM's
weights are the port's random init from ``TrainConfig.seed`` (0), an
FCNN's the reference's ``init_fcnn(PRNGKey(0))``; the seed also seeds the
step keys.  ``fcnn-mnist --smoke`` (64 inputs) trains on the first 64
pixels of each image, as the reference's tests feed that config.  The
reference's fault-tolerant loop (checkpoints, auto-resume, straggler
monitor), gradient compression and model parallelism are not ported:
``--ckpt-dir``, ``--compress`` and ``--model-par`` other than 1 are
refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.physics import DeviceParams, calibrate_v_read
from repro_torch.data import lm_batch, mnist_batch
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted, 'cpu' for the plain PyTorch path")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression (not ported: refused)")
    ap.add_argument("--analog", action="store_true",
                    help="RACA analog-stochastic execution (QAT)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="model-parallel size (not ported: only 1)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the checkpointing loop is not ported: refused)")
    args = ap.parse_args(argv)
    if args.compress:
        ap.error("--compress: gradient compression is not ported yet")
    if args.model_par != 1:
        ap.error("--model-par: model parallelism is not ported yet")
    if args.ckpt_dir is not None:
        ap.error("--ckpt-dir: the checkpointing training loop is not ported yet")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    fcnn = cfg.family == "fcnn"
    if args.analog and fcnn:
        ap.error("--analog: the fcnn config runs in analog-stochastic mode already")
    if args.analog:
        cfg = dataclasses.replace(cfg, analog=AnalogConfig(
            mode="analog_stochastic",
            device=calibrate_v_read(DeviceParams(), cfg.d_model),
        ))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr), microbatches=args.microbatches, total_steps=args.steps,
    )
    state = init_train_state(tcfg.seed, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    losses = []
    t0 = time.perf_counter()
    while state.step < args.steps:
        step = state.step
        if fcnn:
            batch = mnist_batch(batch=args.batch, step=step, device=dev)
            batch["image"] = batch["image"][:, : cfg.fcnn_layers[0]]
        else:
            batch = lm_batch(cfg, batch=args.batch, seq=args.seq, step=step, device=dev)
        state, metrics = step_fn(state, batch)
        losses.append((step, float(metrics["loss"])))
        if step % 10 == 0:
            print(f"step {step} loss {losses[-1][1]:.4f}", flush=True)
    dt = time.perf_counter() - t0
    if losses:
        print(
            f"done: steps={state.step} first_loss={losses[0][1]:.4f} "
            f"last_loss={losses[-1][1]:.4f} restarts=0 stragglers=0 "
            f"({dt / len(losses):.3f} s/step on {dev})"
        )


if __name__ == "__main__":
    main()
