"""Model definitions of the port (the ``decoder_lm`` family so far)."""

from .config import ModelConfig

__all__ = ["ModelConfig"]
