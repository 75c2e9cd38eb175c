"""The plain reference of the benchmark's served models: plain PyTorch in
float32, with no kernel, cache or batching.  It imports nothing of the
program (``repro_torch``) and nothing of JAX or the JAX package, and takes
nothing the program made: the benchmark hands it the weights it made and
the tokens the program served, which it reads only to judge them."""
