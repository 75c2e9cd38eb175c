"""The ``moe_lm`` family: the decoder stack with a mixture of experts in
place of the MLP (``decoder_stack``; GShard capacity in the reference)."""

from .decoder_stack import make_weights, model_config, reference  # noqa: F401
