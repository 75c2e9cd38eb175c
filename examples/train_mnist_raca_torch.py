"""The paper's FCNN [784, 500, 300, 10] on the PyTorch/CUDA port: train
with stochastic-binary neurons (noise-aware QAT) on the MNIST surrogate,
then evaluate the full RACA inference pipeline (Fig. 6 protocol): the
digital baseline and the stochastic circuit at 1, 4, 16 and 64 votes.

    PYTHONPATH=src python examples/train_mnist_raca_torch.py \\
        [--steps 300] [--batch 128] [--small] [--device cpu]

The settings of ``examples/train_mnist_raca.py`` (lr 3e-3, f32 moments
without stochastic rounding, seed 0, ``PRNGKey(7)`` for the votes).  The
steps run in the plain step loop: the checkpointing training loop is not
ported, so ``--ckpt-dir`` is refused.  Runs on the card unless ``--device
cpu`` is given.
"""

import argparse
import dataclasses
import time

import torch

from repro_torch import random as R
from repro_torch.configs.fcnn_mnist import CONFIG as FCNN_CFG
from repro_torch.data import mnist_batch, mnist_dataset
from repro_torch.device import resolve_device
from repro_torch.models.fcnn import fcnn_predict_digital, fcnn_predict_raca
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--small", action="store_true",
                    help="reduced hidden widths (784, 128, 64, 10): a fast CPU run")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted, 'cpu' for the plain PyTorch path")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (the checkpointing loop is not ported: refused)")
    args = ap.parse_args()
    if args.ckpt_dir is not None:
        ap.error("--ckpt-dir: the checkpointing training loop is not ported yet")

    dev = resolve_device(args.device)
    cfg = FCNN_CFG
    if args.small:
        cfg = dataclasses.replace(cfg, fcnn_layers=(784, 128, 64, 10))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=3e-3, state_dtype="float32", stochastic_rounding=False),
        total_steps=args.steps,
    )
    state = init_train_state(tcfg.seed, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, metrics = step_fn(state, mnist_batch(batch=args.batch, step=step, device=dev))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step} loss {float(metrics['loss']):.4f}", flush=True)
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f} s on {dev}")

    test = mnist_dataset(1024, device=dev)
    y = test["label"].long()
    digital = float((fcnn_predict_digital(state.params, test["image"], cfg) == y).float().mean())
    print(f"digital baseline accuracy: {digital:.4f}")
    for votes in (1, 4, 16, 64):
        pred = fcnn_predict_raca(state.params, test["image"], cfg, R.PRNGKey(7), votes)
        acc = float((pred == y).float().mean())
        print(f"RACA stochastic inference, {votes:3d} votes: acc={acc:.4f}")


if __name__ == "__main__":
    main()
