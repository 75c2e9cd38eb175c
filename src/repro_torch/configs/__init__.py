"""Per-architecture configs, every one of the reference's: the
attention-only decoder LMs ``stablelm-3b``, ``gemma2-2b``,
``deepseek-coder-33b`` and ``nemotron-4-340b``, the hybrid
``recurrentgemma-2b`` (RG-LRU blocks and local attention), the
attention-free ``mamba2-1.3b`` (Mamba-2 SSD mixers), the mixtures of
experts ``granite-moe-3b-a800m`` and ``grok-1-314b``, the encoder-decoder
``whisper-small``, the vision-language ``llava-next-34b`` (a decoder LM
with a prepended patch prefix), and the paper's ``fcnn-mnist``; plus the
shape suite (``SHAPES``, ``ShapeSpec``), each arch's ``skip_shapes``, and
the dry run's cells (``ASSIGNED_ARCHS`` in the reference's order,
:func:`cells`)."""

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


# the assigned pool in the reference's order (``repro/configs/__init__.py``),
# which the dry run's report keeps
ASSIGNED_ARCHS = [
    "llava-next-34b",
    "whisper-small",
    "stablelm-3b",
    "gemma2-2b",
    "deepseek-coder-33b",
    "nemotron-4-340b",
    "granite-moe-3b-a800m",
    "grok-1-314b",
    "recurrentgemma-2b",
    "mamba2-1.3b",
]


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


def cells(include_skipped: bool = False) -> list[tuple]:
    """Every (arch, shape, skip reason or None) dry-run cell: the assigned
    archs by the shape suite, the skipped cells only when asked for."""
    out = []
    for arch in ASSIGNED_ARCHS:
        skips = skip_shapes(arch)
        for shape in SHAPES:
            if shape in skips and not include_skipped:
                continue
            out.append((arch, shape, skips.get(shape)))
    return out
