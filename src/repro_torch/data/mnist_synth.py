"""Procedural MNIST surrogate (``repro/data/mnist_synth.py``), drawn from
the port's threefry (``repro_torch.random``) so labels and draws are the
reference's.

28×28 digit images rendered from 7×5 bitmap glyphs with a random affine
distortion (scale, shear, shift), a light 3×3 box blur and per-pixel
Gaussian noise; [784] in [0, 1], 10 classes.  Fully deterministic from
(seed, step, shard).

Labels equal the reference's.  Images go through f32 affine maps, a
``round``, the blur and ``normal`` (99% bit-equal to jax's, a few ulps
apart elsewhere), so an ulp can move a glyph coordinate across a rounding
boundary: compare images by a tolerance and a pixel-agreement fraction.
"""

from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.device import resolve_device

_GLYPHS_TXT = [
    # 0
    "01110 10001 10011 10101 11001 10001 01110",
    # 1
    "00100 01100 00100 00100 00100 00100 01110",
    # 2
    "01110 10001 00001 00110 01000 10000 11111",
    # 3
    "11110 00001 00001 01110 00001 00001 11110",
    # 4
    "00010 00110 01010 10010 11111 00010 00010",
    # 5
    "11111 10000 11110 00001 00001 10001 01110",
    # 6
    "00110 01000 10000 11110 10001 10001 01110",
    # 7
    "11111 00001 00010 00100 01000 01000 01000",
    # 8
    "01110 10001 10001 01110 10001 10001 01110",
    # 9
    "01110 10001 10001 01111 00001 00010 01100",
]


def glyphs(device=None) -> torch.Tensor:
    """The ten 7×5 bitmaps, (10, 7, 5) f32 in {0, 1}."""
    rows = [[[float(ch == "1") for ch in row] for row in g.split()] for g in _GLYPHS_TXT]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _render(key: R.Key, labels: torch.Tensor) -> torch.Tensor:
    """Render a batch of distorted digits: labels (B,) → (B, 28, 28)."""
    b, dev = labels.shape[0], labels.device
    ks = R.split(key, 5)
    scale, shear, dx, dy = (
        R.uniform(k, (b,), dev, lo, hi)[:, None, None]
        for k, (lo, hi) in zip(ks[:4], ((2.2, 3.2), (-0.25, 0.25), (-3.5, 3.5), (-3.5, 3.5)))
    )
    ar = torch.arange(28, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    # inverse-map output pixels into glyph coordinates
    gy = (yy - 14.0 - dy) / scale + 3.5
    gx = (xx - 14.0 - dx) / scale - shear * (gy - 3.5) + 2.5
    gyi = torch.clamp(torch.round(gy).long(), 0, 6)
    gxi = torch.clamp(torch.round(gx).long(), 0, 4)
    inside = (gy >= -0.5) & (gy <= 6.5) & (gx >= -0.5) & (gx <= 4.5)
    imgs = glyphs(dev)[labels.long()[:, None, None], gyi, gxi] * inside
    # light blur (3x3 box) + noise
    pad = torch.nn.functional.pad(imgs, (1, 1, 1, 1))
    blur = sum(pad[:, i : i + 28, j : j + 28] for i in range(3) for j in range(3)) / 9.0
    imgs = 0.6 * imgs + 0.4 * blur
    noise = R.normal(ks[4], tuple(imgs.shape), dev) * 0.12
    return torch.clamp(imgs + noise, 0.0, 1.0)


def mnist_batch(*, batch: int, step: int, seed: int = 0, shard: int = 0, device=None) -> dict:
    """Batch for one (step, shard): "image" (B, 784) f32 and "label" (B,)
    int32, on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    key = R.fold_in(R.fold_in(R.PRNGKey(seed), step), shard)
    k1, k2 = R.split(key)
    labels = R.randint(k1, (batch,), 0, 10, dev).to(torch.int32)
    imgs = _render(k2, labels)
    return {"image": imgs.reshape(batch, 784), "label": labels}


def mnist_dataset(n: int, seed: int = 1234, device=None) -> dict:
    """A fixed evaluation set (held out from training by seed)."""
    return mnist_batch(batch=n, step=0, seed=seed, device=device)
