"""Training launcher: the fault-tolerant loop (``train/loop.py``:
checkpoints, auto-resume, straggler monitor) over synthetic batches (LM
tokens, with ``lm_batch``'s patch embeddings for ``llava-next-34b`` and
its frame embeddings for ``whisper-small``, or MNIST-surrogate images for
``fcnn-mnist``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        [--smoke] [--analog] [--device cpu] [--steps 100] [--batch 8] \\
        [--seq 128] [--lr 3e-4] [--microbatches 1] [--compress] \\
        [--ckpt-dir ckpts/stablelm-3b]
    PYTHONPATH=src python -m repro_torch.launch.train --arch fcnn-mnist \\
        [--smoke] [--device cpu] [--steps 100] [--batch 8]

Takes the reference's flags (``repro/launch/train.py``) and adds
``--device``; runs on the card unless ``--device cpu`` is given.
``--analog`` trains an LM in RACA analog-stochastic mode (noise-aware
QAT): every projection goes through the crossbar kernel (mamba2-1.3b's
``in_proj`` and ``out_proj`` as linear reads, as in the reference;
whisper-small's encoder, decoder and cross-attention projections, its
tied head digital); ``fcnn-mnist``'s
config is analog already (``--analog`` is refused there).  An LM's and
the encoder-decoder's weights are the port's random init from
``TrainConfig.seed`` (0), an
FCNN's the reference's ``init_fcnn(PRNGKey(0))``; the seed also seeds the
step keys.  ``fcnn-mnist --smoke`` (64 inputs) trains on the first 64
pixels of each image, as the reference's tests feed that config.
``--compress`` trains with int8 gradient compression (error feedback).
Checkpoints go to ``--ckpt-dir`` (default ``ckpts/<config name>``) every
``max(steps // 4, 1)`` steps and at the end; a run that finds one there
resumes from it.

``--model-par N`` (or ``--sharded``) trains on a ``(data, model)`` DTensor
mesh (``launch/mesh.make_host_mesh(model=N)``) over the process group:
``torchrun``'s ranks, or one rank over an in-memory store when run alone
(a 1 × 1 mesh); NCCL on the card, gloo with ``--device cpu``.  The model
axis must divide the group's ranks (``make_host_mesh``'s error
otherwise); every other rank goes to the data axis.  Every rank feeds the
same whole batch and keeps its blocks of it; rank 0 prints.

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch stablelm-3b --smoke --device cpu --model-par 2
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.physics import DeviceParams, calibrate_v_read
from repro_torch.data import lm_batch, mnist_batch
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig
from repro_torch.train.loop import LoopConfig, run


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
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--analog", action="store_true",
                    help="RACA analog-stochastic execution (QAT)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="model-axis size of the training mesh; above 1 implies --sharded")
    ap.add_argument("--sharded", action="store_true",
                    help="train on a (data, model) DTensor mesh of the process group's ranks "
                         "(one rank when run alone)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    fcnn = cfg.family == "fcnn"
    if args.analog and fcnn:
        ap.error("--analog: the fcnn config runs in analog-stochastic mode already")
    if cfg.family == "encdec" and args.seq > cfg.max_seq:
        # the decoder's learned positions end there (the smoke config's at 64)
        ap.error(f"--seq {args.seq}: {cfg.name}'s decoder has {cfg.max_seq} positions")
    if args.analog:
        cfg = dataclasses.replace(cfg, analog=AnalogConfig(
            mode="analog_stochastic",
            device=calibrate_v_read(DeviceParams(), cfg.d_model),
        ))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr), microbatches=args.microbatches,
        compress_grads=args.compress, total_steps=args.steps,
    )
    lcfg = LoopConfig(
        steps=args.steps,
        ckpt_dir=args.ckpt_dir or f"ckpts/{cfg.name}",
        ckpt_every=max(args.steps // 4, 1),
        log_every=10,
    )

    def batch_fn(step):
        if fcnn:
            batch = mnist_batch(batch=args.batch, step=step, device=dev)
            batch["image"] = batch["image"][:, : cfg.fcnn_layers[0]]
            return batch
        return lm_batch(cfg, batch=args.batch, seq=args.seq, step=step, device=dev)

    if not (args.sharded or args.model_par != 1):
        return _report(run(cfg, tcfg, lcfg, batch_fn, device=dev), dev)
    from repro_torch.launch import mesh as LM

    with LM.process_group(dev):
        mesh = LM.make_host_mesh(model=args.model_par, device=dev)
        out = run(cfg, tcfg, lcfg, batch_fn, device=dev, mesh=mesh)
        if torch.distributed.get_rank() == 0:
            print(f"training mesh: {LM.mesh_shape(mesh)}")
            _report(out, dev)


def _report(out, dev) -> None:
    state, stats = out
    losses = stats["losses"]
    if losses:
        print(
            f"done: steps={state.step} first_loss={losses[0][1]:.4f} "
            f"last_loss={losses[-1][1]:.4f} restarts={stats['restarts']} "
            f"stragglers={stats['stragglers']} "
            f"({sum(stats['step_s']) / len(stats['step_s']):.3f} s/step on {dev})"
        )


if __name__ == "__main__":
    main()
