"""Per-architecture configs ported so far: ``stablelm-3b`` and the paper's
``fcnn-mnist``."""

from importlib import import_module

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "fcnn-mnist": "fcnn_mnist",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke_config(name: str):
    return _mod(name).smoke_config()
