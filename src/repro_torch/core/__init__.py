"""Core RACA primitives (``repro/core``): device physics, the crossbar, the
stochastic Sigmoid neurons, the WTA neurons and the analog execution modes."""
