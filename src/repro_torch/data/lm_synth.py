"""Stateless synthetic LM data (``repro/data/lm_synth.py``), drawn from the
port's threefry (``repro_torch.random``) so the tokens are the reference's.

Every batch is a pure function of (seed, step, shard).  The stream is a
Markov-zipf language: with probability 0.75 the next token is a fixed
successor of the previous one (learnable structure), otherwise a
zipf-distributed draw.  The zipf draw goes through f32 ``exp``, whose last
bit can differ between libraries, so a token can differ from the
reference's where ``exp`` lands within an ulp of an integer.
"""

from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.device import resolve_device


def _tokens(key, b: int, s: int, vocab: int, device, markov_p: float = 0.75) -> torch.Tensor:
    k1, k2, _ = R.split(key, 3)
    u = R.uniform(k1, (b, s + 1), device)
    log_v = torch.log(torch.tensor(float(vocab), dtype=torch.float32)).to(device)
    zipf = torch.exp(u * log_v).to(torch.int32) % vocab
    follow = R.uniform(k2, (b, s + 1), device) < markov_p
    toks = torch.empty((b, s + 1), dtype=torch.int32, device=device)
    toks[:, 0] = prev = zipf[:, 0]
    for t in range(1, s + 1):
        prev = torch.where(follow[:, t], (prev * 31 + 17) % vocab, zipf[:, t])
        toks[:, t] = prev
    return toks


def lm_batch(
    cfg, *, batch: int, seq: int, step: int, seed: int = 0, shard: int = 0,
    n_shards: int = 1, device=None,
) -> dict:
    """Batch for one (step, shard): int32 "tokens" and "labels" (B, seq),
    on ``device`` (the card unless ``"cpu"``).  A ``vlm`` model's batch
    adds f32 "patches" (B, n_patches, d) · 0.02, drawn under ``fold_in(key,
    101)``; an ``encdec`` model's adds f32 "frames" (B, seq, d) · 0.1,
    under ``fold_in(key, 102)``, as the reference draws them."""
    if cfg.family == "fcnn":
        raise NotImplementedError("lm_batch draws token batches; an fcnn model takes mnist_batch")
    dev = resolve_device(device)
    key = R.fold_in(R.fold_in(R.PRNGKey(seed), step), shard)
    toks = _tokens(key, batch, seq, cfg.vocab, dev)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patches"] = R.normal(R.fold_in(key, 101), (batch, cfg.n_patches, cfg.d_model),
                                  dev) * 0.02
    if cfg.family == "encdec":
        out["frames"] = R.normal(R.fold_in(key, 102), (batch, seq, cfg.d_model), dev) * 0.1
    return out
