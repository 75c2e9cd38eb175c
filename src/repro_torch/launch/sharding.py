"""The sharding policy (``repro/launch/sharding.py``), as plain partition
specs: which mesh axis shards which dimension of each leaf.

  * batch            → ("pod", "data")  (dropped per dim when it does not divide)
  * heads/ffn/vocab/experts' F dim → "model" (tensor parallelism)
  * params ≥ FSDP_THRESHOLD → the rule's replicated dim additionally
    sharded over "data" (ZeRO-3); optimizer moments and error feedback
    inherit the parameters' specs
  * decode KV caches → batch over data; kv_heads over "model" when
    divisible, else the cache's sequence dim over "model"
  * paged KV pools → the page axis over "data", kv_heads over "model";
    scale planes follow their code pages; per-slot state leaves keep the
    dense batch→data rules

Every rule is divisibility-guarded: a mesh axis that does not divide its
dimension is dropped (replicated).  A spec is a tuple with one entry per
dimension: a mesh-axis name, a tuple of two or more names, or ``None``
(a one-name tuple is written as the name, as ``PartitionSpec`` keeps
it).  A mesh is axis names with sizes: a mapping, any object with
``axis_names`` and ``devices.shape`` (the reference's fake mesh), or a
DTensor ``DeviceMesh``.  The parameter trees carry the reference's leaf
names, so the path rules apply unchanged.

The placements (:func:`param_shardings`, :func:`state_shardings`,
:func:`batch_shardings`, :func:`cache_shardings`) are those specs on a
``DeviceMesh``, through ``parallel.placements``: one
``parallel.Sharding`` (mesh, a placement per mesh axis; an axis of one
rank replicates) per leaf.  So a leaf's local shard and
:func:`per_device_bytes` cannot disagree.
"""

from __future__ import annotations

import math
import re
from typing import Any, Mapping, Optional

from repro_torch import parallel as PX
from repro_torch.models import ModelConfig

FSDP_THRESHOLD = 8_000_000_000  # params; above this, shard states over data

_FSDP = "__fsdp__"  # placeholder resolved per config


def mesh_axis_sizes(mesh: Any) -> dict:
    """{axis name: size} of a mapping, a mesh-like object or a
    ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh: Any, batch_size: int) -> Optional[tuple]:
    """Largest prefix of ("pod", "data") that divides the batch."""
    sizes = mesh_axis_sizes(mesh)
    axes, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and batch_size % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes) or None


def _entry(ax):
    """A spec entry: a one-name tuple as the name."""
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


def activation_rules(mesh: Any, cfg: ModelConfig, batch_size: int) -> dict:
    """The logical activation axes' mesh axes, as the reference's
    ``parallel.shard`` annotations read them."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    return {
        "batch": batch_axes(mesh, batch_size),
        "seq": None,
        "embed": None,
        "heads": "model" if cfg.n_heads % m == 0 else None,
        "kv_heads": "model" if cfg.n_kv_heads % m == 0 else None,
        "ffn": "model",
        "vocab": "model",
        "experts": None,
        "layers": None,
    }


# (path regex, spec template); the first match wins.  _FSDP resolves to
# "data" (or None) per config.
_PARAM_RULES = [
    (r"embed/embedding$", ("model", _FSDP)),            # (V, D)
    (r"head/w$", (_FSDP, "model")),                     # (D, V)
    (r"dec_pos$", (None, None)),
    (r"(attn|self_attn|cross_attn)/w[qkv]$", (_FSDP, "model")),
    (r"(attn|self_attn|cross_attn)/wo$", ("model", _FSDP)),
    # the MoE rules precede the generic w_up / w_gate / w_down ones: expert
    # weights carry a leading (E,) axis
    (r"moe/router$", (_FSDP, None)),
    (r"moe/w_(up|gate)$", (None, _FSDP, "model")),      # (E, D, F)
    (r"moe/w_down$", (None, "model", _FSDP)),           # (E, F, D)
    (r"(ffn|rec)/?w_up$|w_up$", (_FSDP, "model")),
    (r"w_gate$", (_FSDP, "model")),
    (r"w_down$", ("model", _FSDP)),
    (r"mixer/in_proj$", (_FSDP, "model")),
    (r"mixer/out_proj$", ("model", _FSDP)),
    (r"mixer/conv_w$", (None, "model")),
    (r"mixer/conv_b$", ("model",)),
    (r"rec/w_main$|rec/w_gate_br$", (_FSDP, "model")),
    (r"rec/w_out$", ("model", _FSDP)),
    (r"rec/w[ax]$", (_FSDP, "model")),
    (r"rec/conv_w$", (None, "model")),
    (r"rec/conv_b$|rec/b[ax]$|rec/lam$", ("model",)),
]


def _spec_for_path(path: str, shape: tuple, mesh: Any, fsdp: bool) -> tuple:
    """One parameter leaf's spec from its "/"-joined path.  Stacked leaves
    (``units/``, ``enc/``, ``dec/``) carry a leading layer axis that the
    2-D templates do not cover."""
    sizes = mesh_axis_sizes(mesh)
    ndim = len(shape)
    n_prefix = 1 if re.match(r"^(units|enc|dec)/", path) else 0
    template: tuple = ()
    for rx, tpl in _PARAM_RULES:
        if re.search(rx, path):
            template = tpl
            break
    template = (None,) * n_prefix + tuple(template)
    template = (template + (None,) * (ndim - len(template)))[:ndim]
    out, used = [], set()
    for dim, ax in zip(shape, template):
        if ax == _FSDP:
            ax = "data" if fsdp else None
        if ax is None or ax in used or ax not in sizes or dim % sizes[ax] != 0:
            out.append(None)
            continue
        used.add(ax)
        out.append(ax)
    return tuple(out)


def _fsdp(cfg: ModelConfig) -> bool:
    if cfg.force_fsdp is not None:
        return cfg.force_fsdp
    return cfg.param_count() >= FSDP_THRESHOLD


def _map_paths(fn, tree: dict, prefix: str = "") -> dict:
    return {
        k: _map_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict) else fn(f"{prefix}{k}", v)
        for k, v in tree.items()
    }


def param_partition_specs(params: dict, mesh: Any, cfg: ModelConfig) -> dict:
    """A spec per leaf of a parameter-shaped tree (anything with
    ``.shape``: tensors, meta tensors)."""
    fsdp = _fsdp(cfg)
    return _map_paths(lambda path, leaf: _spec_for_path(path, tuple(leaf.shape), mesh, fsdp),
                      params)


def state_partition_specs(state, mesh: Any, cfg: ModelConfig) -> dict:
    """A ``TrainState``'s specs: {"params", "m", "v", "error"}: the
    moments and the error feedback (``None`` without compression) take
    their parameters' specs; the step counters and the PRNG key are
    replicated scalars, kept on the host in the port."""
    pspec = lambda tree: param_partition_specs(tree, mesh, cfg)  # noqa: E731
    return {
        "params": pspec(state.params),
        "m": pspec(state.opt.m),
        "v": pspec(state.opt.v),
        "error": None if state.compress is None else pspec(state.compress.error),
    }


def batch_partition_specs(batch: dict, mesh: Any, batch_size: int) -> dict:
    """Each batch leaf's leading dim over :func:`batch_axes`."""
    ax = _entry(batch_axes(mesh, batch_size))
    return {k: (ax,) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def cache_partition_specs(cache: dict, mesh: Any, cfg: ModelConfig, batch_size: int) -> dict:
    """A spec per decode-cache leaf, dense and paged layouts.

    Dense leaves shard the batch over data and kv_heads over "model" (the
    sequence over "model" when kv_heads does not divide).  Paged-pool
    leaves (``(nu, n_attn, n_pages, block, Hkv[, Dh])``) shard the page
    axis over "data" (pooled capacity grows with the data axis at
    constant per-device memory) and kv_heads over "model", each
    divisibility-guarded."""
    sizes = mesh_axis_sizes(mesh)
    m = sizes.get("model", 1)
    bax = _entry(batch_axes(mesh, batch_size))
    kv_div = cfg.n_kv_heads % m == 0 if cfg.n_kv_heads else False
    kv_ax = "model" if kv_div else None
    seq_ax = None if kv_div else "model"

    def guard(axes, shape) -> tuple:
        res = []
        for dim, ax in zip(shape, axes):
            names = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
            sz = math.prod(sizes.get(a, 1) for a in names)
            res.append(ax if ax is not None and dim % sz == 0 else None)
        return tuple(res)

    out = {}
    for k, v in cache.items():
        shape, nd = tuple(v.shape), v.dim()
        if k == "pos":
            spec = (bax,)
        elif k in ("k_pages", "v_pages"):
            spec = guard([None, None, "data", None, kv_ax, None], shape)
        elif k in ("k_scale_pages", "v_scale_pages"):
            spec = guard([None, None, "data", None, kv_ax], shape)
        elif k in ("k", "v", "ck", "cv"):  # (..., B, S, Hkv, Dh), 1-2 stack axes
            spec = guard([None] * (nd - 4) + [bax, seq_ax, kv_ax, None], shape)
        elif k in ("k_scale", "v_scale"):  # (..., B, S, Hkv)
            spec = guard([None] * (nd - 3) + [bax, seq_ax, kv_ax], shape)
        elif k in ("ssm_conv", "rec_conv"):
            spec = (None,) * (nd - 3) + (bax, None, "model" if shape[-1] % m == 0 else None)
        elif k == "ssm_state":  # (nu, n, B, H, P, N): heads over model
            spec = (None, None, bax, "model" if shape[-3] % m == 0 else None, None, None)
        elif k == "rec_h":
            spec = (None, None, bax, "model" if shape[-1] % m == 0 else None)
        else:  # quant_step (a scalar) and any bookkeeping leaf
            spec = (None,) * nd
        out[k] = spec
    return out


def spec_shards(spec: Optional[tuple], sizes: dict) -> int:
    """How many ways a spec splits its leaf: the product of the sizes of
    the mesh axes it names."""
    n = 1
    for ax in spec or ():
        for a in () if ax is None else ax if isinstance(ax, tuple) else (ax,):
            n *= sizes.get(a, 1)
    return n


def per_device_bytes(tree: Any, specs: Any, sizes: dict) -> int:
    """Bytes each device holds of ``tree`` under ``specs`` (the same
    nesting, a spec per leaf): each leaf's bytes over its
    :func:`spec_shards`."""
    if isinstance(tree, dict):
        return sum(per_device_bytes(v, specs[k], sizes) for k, v in tree.items())
    return tree.numel() * tree.element_size() // spec_shards(specs, sizes)


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh: the specs above through parallel.placements.
# ---------------------------------------------------------------------------


def _shardings(specs: Any, mesh) -> Any:
    """A ``parallel.Sharding`` per spec of a (nested) dict of specs."""
    if isinstance(specs, dict):
        return {k: _shardings(v, mesh) for k, v in specs.items()}
    if specs is None:
        return None
    return PX.Sharding(mesh, PX.placements(specs, mesh.mesh_dim_names, mesh.shape))


def param_shardings(params: dict, mesh, cfg: ModelConfig) -> dict:
    """A placement per parameter leaf (:func:`param_partition_specs`)."""
    return _shardings(param_partition_specs(params, mesh, cfg), mesh)


def state_shardings(state, mesh, cfg: ModelConfig) -> dict:
    """A ``TrainState``'s placements (:func:`state_partition_specs`):
    {"params", "m", "v", "error"}."""
    return _shardings(state_partition_specs(state, mesh, cfg), mesh)


def batch_shardings(batch: dict, mesh, batch_size: int) -> dict:
    """Each batch leaf's leading dim over :func:`batch_axes`."""
    return _shardings(batch_partition_specs(batch, mesh, batch_size), mesh)


def cache_shardings(cache: dict, mesh, cfg: ModelConfig, batch_size: int) -> dict:
    """A placement per decode-cache leaf, dense and paged layouts
    (:func:`cache_partition_specs`)."""
    return _shardings(cache_partition_specs(cache, mesh, cfg, batch_size), mesh)
