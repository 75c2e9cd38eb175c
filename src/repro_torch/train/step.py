"""The training step (``repro/train/step.py``): loss → gradients
(optionally micro-batched) → AdamW with stochastically rounded moments.

Keys follow the reference exactly (``repro_torch.random`` is its
threefry): the step draws under ``fold_in(state.rng, step)``, microbatch
``i`` under ``fold_in(step_key, i)``, AdamW's rounding under
``fold_in(step_key, 7)``, and int8 gradient compression
(``TrainConfig.compress_grads``, ``optim/compress.py``) under
``fold_in(step_key, 13)``, or per microbatch ``fold_in(fold_in(step_key,
i), 13)``: each microbatch's gradients are compressed, with the error
feedback carried from one to the next, before they are summed.  The
model's init and loss come from ``models.get_model_fns``: the
``decoder_lm``, ``hybrid`` and ``ssm`` families (analog projections run
the crossbar kernel on the card; a hybrid model's ``analog_stochastic``
RG-LRU gates run ``sigmoid_sample``; a Mamba-2 mixer's two projections
read linearly in every analog mode) and the paper's ``fcnn``.
Parameters and moments are updated in
place (the reference donates its state to the jitted step): pass each
state to the step once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import random as R
from repro_torch.models import ModelConfig, get_model_fns
from repro_torch.optim import (
    AdamWConfig,
    AdamWState,
    CompressState,
    adamw_init,
    adamw_update,
    compress_grads,
    init_compress,
    tree_leaves,
    tree_unflatten,
    warmup_cosine,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1
    compress_grads: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    seed: int = 0


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    compress: Optional[CompressState]
    step: int
    rng: R.Key


def init_train_state(seed: int, model_cfg: ModelConfig, train_cfg: TrainConfig, device=None) -> TrainState:
    """Seeded random parameters on ``device`` (an LM: the port's own init,
    not jax's; an FCNN: the reference's ``init_fcnn(PRNGKey(seed))``), zero
    moments, step 0 and the reference's ``rng = fold_in(PRNGKey(seed),
    1)``; with ``compress_grads``, a zero error-feedback state."""
    params = get_model_fns(model_cfg).init(seed, model_cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(
        params=params, opt=adamw_init(params, train_cfg.opt),
        compress=init_compress(params) if train_cfg.compress_grads else None,
        step=0, rng=R.fold_in(R.PRNGKey(seed), 1),
    )


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` is the
    family's (an LM's (B, S) int tokens and labels, an FCNN's images and
    labels) on the parameters' device."""
    loss_fn = get_model_fns(model_cfg).loss
    needs_key = model_cfg.analog.mode != "digital"

    def loss_and_grads(params: dict, batch: dict, key):
        leaves = tree_leaves(params)
        loss, metrics = loss_fn(params, batch, model_cfg, key if needs_key else None)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def train_step(state: TrainState, batch: dict):
        step_key = R.fold_in(state.rng, state.step)
        nmb = train_cfg.microbatches
        comp = state.compress
        if nmb == 1:
            with torch.profiler.record_function("train/forward_backward"):
                loss, metrics, grads = loss_and_grads(state.params, batch, step_key)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if comp is not None:
                with torch.profiler.record_function("train/compress"):
                    grads, comp = compress_grads(grads, comp, R.fold_in(step_key, 13))
        else:
            grads, loss = None, torch.zeros((), dtype=torch.float32)
            b = next(iter(batch.values())).shape[0]
            if b % nmb:
                raise ValueError(f"batch {b} does not split into {nmb} microbatches")
            bm = b // nmb
            for i in range(nmb):
                mbatch = {k: v[i * bm : (i + 1) * bm] for k, v in batch.items()}
                kmb = R.fold_in(step_key, i)
                with torch.profiler.record_function("train/forward_backward"):
                    l, _, g = loss_and_grads(state.params, mbatch, kmb)
                if comp is not None:
                    with torch.profiler.record_function("train/compress"):
                        g, comp = compress_grads(g, comp, R.fold_in(kmb, 13))
                acc = [x.float() / nmb for x in tree_leaves(g)]
                grads = acc if grads is None else [a + x for a, x in zip(grads, acc)]
                loss = loss.to(l.device) + l / nmb
            grads = tree_unflatten(state.params, grads)
            metrics = {"loss": loss}
        lr_scale = warmup_cosine(
            state.step, warmup=train_cfg.warmup_steps, total=train_cfg.total_steps
        )
        with torch.profiler.record_function("train/adamw"):
            params, opt, opt_metrics = adamw_update(
                train_cfg.opt, state.params, grads, state.opt, lr_scale=lr_scale,
                rng=R.fold_in(step_key, 7) if train_cfg.opt.stochastic_rounding else None,
            )
        new_state = TrainState(params=params, opt=opt, compress=comp, step=state.step + 1, rng=state.rng)
        return new_state, {**metrics, **opt_metrics}

    return train_step
