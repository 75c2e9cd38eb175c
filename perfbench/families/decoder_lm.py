"""The ``decoder_lm`` family: a dense pre-norm decoder (``decoder_stack``)."""

from .decoder_stack import make_weights, model_config, reference  # noqa: F401
