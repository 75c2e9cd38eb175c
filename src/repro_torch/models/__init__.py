"""Model definitions of the port and the family registry
(``repro/models/__init__.py``): the ``decoder_lm``, ``moe_lm``, ``hybrid``,
``ssm``, ``vlm``, ``encdec`` and ``fcnn`` families."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch import random as R
from . import encdec as ED
from . import fcnn as FC
from . import transformer as TF
from .config import ModelConfig


class ModelFns(NamedTuple):
    init: Callable          # (seed, cfg, device) -> params
    loss: Callable          # (params, batch, cfg, key) -> (loss, metrics)
    prefill: Callable | None      # (params, batch, cfg, max_len) -> (cache, logits)
    decode_step: Callable | None  # (params, cache, token, cfg[, table]) -> (cache, logits)


def get_model_fns(cfg: ModelConfig) -> ModelFns:
    """The family's functions.  ``init`` takes an integer seed: the LM's
    and the encoder-decoder's are the port's own seeded inits, the FCNN's
    the reference's draw from ``PRNGKey(seed)``.  The LM's ``prefill`` is
    the dense layout's monolithic prefill (``transformer.lm_prefill``, a
    batch dict with ``tokens`` and, for a ``vlm`` model, optional
    ``patches``) and ``decode_step`` the decode step over a dense or a
    paged cache (``transformer.lm_decode_step``).  A ``moe_lm`` model
    (mixture-of-experts MLPs), a ``hybrid`` one (RG-LRU blocks beside
    attention), an ``ssm`` one (Mamba-2 mixers) and a ``vlm`` one (a
    prepended patch prefix) share the LM's functions.  The
    encoder-decoder's ``prefill`` takes ``frames`` and ``tokens``
    (``encdec.encdec_prefill``) and its ``decode_step`` is the dense
    cache's (``encdec.encdec_decode_step``).  The FCNN has neither."""
    if cfg.family == "encdec":
        return ModelFns(
            init=lambda seed, c, device=None: ED.init_encdec(c, seed=seed, device=device),
            loss=ED.encdec_loss,
            prefill=lambda params, batch, c, max_len: ED.encdec_prefill(
                params, batch["frames"], batch["tokens"], c, max_len
            ),
            decode_step=ED.encdec_decode_step,
        )
    if cfg.family == "fcnn":
        return ModelFns(
            init=lambda seed, c, device=None: FC.init_fcnn(R.PRNGKey(seed), c, device),
            loss=FC.fcnn_loss, prefill=None, decode_step=None,
        )
    if cfg.family in ("decoder_lm", "moe_lm", "hybrid", "ssm", "vlm"):
        return ModelFns(
            init=lambda seed, c, device=None: TF.init_lm(c, seed=seed, device=device),
            loss=TF.lm_loss,
            prefill=lambda params, batch, c, max_len: TF.lm_prefill(
                params, batch["tokens"], c, max_len, prefix_embeds=batch.get("patches")
            ),
            decode_step=TF.lm_decode_step,
        )
    raise NotImplementedError(f"unknown family {cfg.family!r}")


__all__ = ["ModelConfig", "ModelFns", "get_model_fns"]
