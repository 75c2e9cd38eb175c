"""One module per model family, found by a configuration file's
``family``: ``model_config(conf, traffic)`` (the port's ``ModelConfig``),
``make_weights(mcfg, seed, device)`` (the weights, made on the device from
the seed) and ``reference`` (the plain reference module that the output
check runs: ``Sizes.from_config(conf)`` and ``logits``).  A later family is
a new module here and, where it needs one, a new reference module."""
