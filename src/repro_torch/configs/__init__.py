"""Per-architecture configs, every one of the reference's: the
attention-only decoder LMs ``stablelm-3b``, ``gemma2-2b``,
``deepseek-coder-33b`` and ``nemotron-4-340b``, the hybrid
``recurrentgemma-2b`` (RG-LRU blocks and local attention), the
attention-free ``mamba2-1.3b`` (Mamba-2 SSD mixers), the mixtures of
experts ``granite-moe-3b-a800m`` and ``grok-1-314b``, the encoder-decoder
``whisper-small``, the vision-language ``llava-next-34b`` (a decoder LM
with a prepended patch prefix), and the paper's ``fcnn-mnist``; plus the
shape suite (``SHAPES``, ``ShapeSpec``) and each arch's ``skip_shapes``."""

from importlib import import_module

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "gemma2-2b": "gemma2_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "nemotron-4-340b": "nemotron_4_340b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "grok-1-314b": "grok_1_314b",
    "whisper-small": "whisper_small",
    "llava-next-34b": "llava_next_34b",
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


def skip_shapes(name: str) -> dict:
    return getattr(_mod(name), "SKIP_SHAPES", {})


from .shapes import SHAPES, ShapeSpec  # noqa: E402,F401
