"""PyTorch/CUDA port of the RACA serving stack (reference: the JAX package
``repro``).

Module names mirror ``repro`` so each counterpart is easy to find.  The
port imports ``torch`` and never ``jax`` or ``repro``.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``; without a card
and without an explicit CPU request it raises (see :func:`resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
