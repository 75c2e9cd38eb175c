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

On a ``(data, model)`` DTensor mesh (``init_train_state(..., mesh=)`` or
:func:`place_state`) the state's tensors are DTensors at the reference's
placements (``launch/sharding.state_shardings``), seeded identically on
every rank and each rank keeping its shard (no collective); the step
finds the mesh on its parameters, places the batch under
``batch_shardings`` and runs the loss under the reference's activation
rules (``parallel.axis_rules``; the models' ``parallel.shard``
annotations), with plain tensors taken as replicated.  Gradients are
redistributed to their parameters' placements before compression and
AdamW, which work on each rank's blocks.  A microbatch is rows ``[i·b,
(i+1)·b)`` of the global batch, as unsharded (the batch's tokens are
gathered once and each microbatch placed again), so a sharded step draws
the unsharded noise.  ``step`` and ``rng`` stay host scalars; metrics come
back as plain tensors, whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.launch import sharding as SH
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


def init_train_state(seed: int, model_cfg: ModelConfig, train_cfg: TrainConfig, device=None,
                     mesh=None) -> TrainState:
    """Seeded random parameters on ``device`` (an LM: the port's own init,
    not jax's; an FCNN: the reference's ``init_fcnn(PRNGKey(seed))``), zero
    moments, step 0 and the reference's ``rng = fold_in(PRNGKey(seed),
    1)``; with ``compress_grads``, a zero error-feedback state.  With a
    ``mesh``, placed on it (:func:`place_state`)."""
    params = get_model_fns(model_cfg).init(seed, model_cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = TrainState(
        params=params, opt=adamw_init(params, train_cfg.opt),
        compress=init_compress(params) if train_cfg.compress_grads else None,
        step=0, rng=R.fold_in(R.PRNGKey(seed), 1),
    )
    return state if mesh is None else place_state(state, mesh, model_cfg)


def _place_tree(tree: dict, shardings: dict) -> dict:
    """Each leaf of a tree every rank holds whole as a DTensor of its
    sharding: this rank's block (copied out where it is not the whole
    leaf, so the whole one can be freed), ``requires_grad`` kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _place_tree(v, shardings[k])
            continue
        sh = shardings[k]
        block = v.detach()[PX.local_slices(sh, v.shape)]
        if block.numel() != v.numel():
            block = block.clone()
        out[k] = PX.place_local(block, sh, v.shape).requires_grad_(v.requires_grad)
    return out


def place_state(state: TrainState, mesh, model_cfg: ModelConfig) -> TrainState:
    """A state every rank holds whole (the same seeded init, or a loaded
    checkpoint), placed on ``mesh`` under ``SH.state_shardings``: each rank
    keeps its blocks, no collective."""
    sh = SH.state_shardings(state, mesh, model_cfg)
    comp = state.compress
    return state._replace(
        params=_place_tree(state.params, sh["params"]),
        opt=state.opt._replace(m=_place_tree(state.opt.m, sh["m"]),
                               v=_place_tree(state.opt.v, sh["v"])),
        compress=None if comp is None else comp._replace(
            error=_place_tree(comp.error, sh["error"])),
    )


def mesh_of(params: dict):
    """The DeviceMesh a parameter tree is placed on, or ``None``."""
    from torch.distributed.tensor import DTensor

    leaf = tree_leaves(params)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


@contextlib.contextmanager
def _on_mesh(mesh, model_cfg: ModelConfig, batch_size: int):
    """The reference's activation rules for a batch of ``batch_size`` on
    ``mesh``, plain tensors taken as replicated; nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with PX.axis_rules(mesh, SH.activation_rules(mesh, model_cfg, batch_size)), \
            implicit_replication():
        yield


def _place_batch(batch: dict, mesh) -> dict:
    """A batch every rank holds whole, as DTensors of ``batch_shardings``
    (a DTensor leaf as it is)."""
    from torch.distributed.tensor import DTensor

    b = next(iter(batch.values())).shape[0]
    sh = SH.batch_shardings(batch, mesh, b)
    return {k: v if isinstance(v, DTensor) else PX.place(v, sh[k]) for k, v in batch.items()}


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` is the
    family's (an LM's (B, S) int tokens and labels, an FCNN's images and
    labels) on the parameters' device."""
    loss_fn = get_model_fns(model_cfg).loss
    needs_key = model_cfg.analog.mode != "digital"

    def loss_and_grads(params: dict, batch: dict, key):
        leaves = tree_leaves(params)
        mesh = mesh_of(params)
        if mesh is not None:
            batch = _place_batch(batch, mesh)
        with _on_mesh(mesh, model_cfg, next(iter(batch.values())).shape[0]):
            loss, metrics = loss_fn(params, batch, model_cfg, key if needs_key else None)
            grads = torch.autograd.grad(loss, leaves)
        if mesh is not None:   # to the parameters' placements (reduce-scatters, all-reduces)
            grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
            metrics = {k: PX.whole(v) for k, v in metrics.items()}
        return PX.whole(loss.detach()), metrics, tree_unflatten(params, list(grads))

    def train_step(state: TrainState, batch: dict):
        step_key = R.fold_in(state.rng, state.step)
        nmb = train_cfg.microbatches
        comp = state.compress
        if mesh_of(state.params) is not None and nmb > 1:
            batch = {k: PX.whole(v) for k, v in batch.items()}   # sliced globally below
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
