"""Model definitions of the port and the family registry
(``repro/models/__init__.py``): the ``decoder_lm`` and ``fcnn`` families."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch import random as R
from . import fcnn as FC
from . import transformer as TF
from .config import ModelConfig


class ModelFns(NamedTuple):
    init: Callable          # (seed, cfg, device) -> params
    loss: Callable          # (params, batch, cfg, key) -> (loss, metrics)


def get_model_fns(cfg: ModelConfig) -> ModelFns:
    """The family's functions.  ``init`` takes an integer seed: the LM's is
    the port's own seeded init, the FCNN's the reference's draw from
    ``PRNGKey(seed)``.  The reference's dense ``prefill`` and
    ``decode_step`` are not ported: the serving path calls the paged
    functions of ``launch/specs.py``."""
    if cfg.family == "fcnn":
        return ModelFns(
            init=lambda seed, c, device=None: FC.init_fcnn(R.PRNGKey(seed), c, device),
            loss=FC.fcnn_loss,
        )
    if cfg.family == "decoder_lm":
        return ModelFns(
            init=lambda seed, c, device=None: TF.init_lm(c, seed=seed, device=device),
            loss=TF.lm_loss,
        )
    raise NotImplementedError(f"family {cfg.family!r} is not ported; ported: decoder_lm, fcnn")


__all__ = ["ModelConfig", "ModelFns", "get_model_fns"]
