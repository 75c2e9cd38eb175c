"""Model definitions of the port and the family registry
(``repro/models/__init__.py``): the ``decoder_lm``, ``moe_lm``, ``hybrid``,
``ssm`` and ``fcnn`` families."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch import random as R
from . import fcnn as FC
from . import transformer as TF
from .config import ModelConfig


class ModelFns(NamedTuple):
    init: Callable          # (seed, cfg, device) -> params
    loss: Callable          # (params, batch, cfg, key) -> (loss, metrics)
    prefill: Callable | None      # (params, batch, cfg, max_len) -> (cache, logits)
    decode_step: Callable | None  # (params, cache, token, cfg[, table]) -> (cache, logits)


def get_model_fns(cfg: ModelConfig) -> ModelFns:
    """The family's functions.  ``init`` takes an integer seed: the LM's is
    the port's own seeded init, the FCNN's the reference's draw from
    ``PRNGKey(seed)``.  The LM's ``prefill`` is the dense layout's
    monolithic prefill (``transformer.lm_prefill``, a batch dict with
    ``tokens``; the ported family has no patches) and ``decode_step`` the decode
    step over a dense or a paged cache (``transformer.lm_decode_step``);
    the FCNN has neither.  A ``moe_lm`` model (mixture-of-experts MLPs),
    a ``hybrid`` one (RG-LRU blocks beside attention) and an ``ssm`` one
    (Mamba-2 mixers) share the LM's functions."""
    if cfg.family == "fcnn":
        return ModelFns(
            init=lambda seed, c, device=None: FC.init_fcnn(R.PRNGKey(seed), c, device),
            loss=FC.fcnn_loss, prefill=None, decode_step=None,
        )
    if cfg.family in ("decoder_lm", "moe_lm", "hybrid", "ssm"):
        return ModelFns(
            init=lambda seed, c, device=None: TF.init_lm(c, seed=seed, device=device),
            loss=TF.lm_loss,
            prefill=lambda params, batch, c, max_len: TF.lm_prefill(
                params, batch["tokens"], c, max_len
            ),
            decode_step=TF.lm_decode_step,
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported; ported: decoder_lm, moe_lm, hybrid, ssm, fcnn")


__all__ = ["ModelConfig", "ModelFns", "get_model_fns"]
