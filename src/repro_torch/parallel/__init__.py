"""The logical-axis sharding context (``repro/parallel/__init__.py``), on
DTensor, and the serving mesh's collectives around the paged kernels.

Models annotate activations with logical axis names (``shard(x, ("batch",
"seq", "embed"))``); a launcher installs a device mesh and a logical →
mesh-axis table (:func:`axis_rules`).  Outside any context :func:`shard`
is the identity, so the same model code runs on one device and on a
mesh.  Inside one, it redistributes ``x`` (a DTensor; a plain tensor is
taken as replicated, as every rank holds the same one) to the placements
the rules give.  Serving installs no rules, as the reference's engine
never does: its sharding is the entry points' (``launch/specs.py``).

A partition spec names, for each tensor dimension, a mesh axis, a tuple
of mesh axes, or ``None``; DTensor's placements name, for each mesh
dimension, ``Shard(d)`` or ``Replicate()``.  :func:`placements` turns one
into the other.  A tensor dimension spread over a tuple of axes takes
them in mesh order, each shard splitting the previous one: the block a
rank holds is at the row-major index of its coordinates on those axes,
as JAX lays out ``PartitionSpec(("pod", "data"))``.

:class:`PoolShards` is what a sharded serving step tells the paged
attention layers (``models/attention.py``) through :func:`use_pool_shards`:
which of the slot, page and kv-head axes are split, over which groups,
and the collectives that gather them.  No context is installed on a mesh
whose axes are all of size 1, so such a step runs exactly the unsharded
code.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Sequence

import torch

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_axis_rules", default=None)
_POOL: contextvars.ContextVar = contextvars.ContextVar("repro_torch_pool_shards", default=None)


class Sharding(NamedTuple):
    """A DTensor layout: the mesh and one placement per mesh dimension
    (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    placements: tuple

    def local_shape(self, shape: Sequence[int]) -> tuple:
        """This rank's shard of a tensor of global ``shape``."""
        return local_box(self, shape)[0]


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Optional[Sequence], mesh_axes: Sequence[str]) -> tuple:
    """A partition spec → one placement per mesh axis of ``mesh_axes``
    (``Shard(d)`` where tensor dimension d names the axis, else
    ``Replicate()``).  A dimension's tuple of axes must be in mesh order,
    and an axis may shard one dimension only."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate()] * len(mesh_axes)
    for d, entry in enumerate(spec or ()):
        names = _axes(entry)
        idx = [list(mesh_axes).index(n) if n in mesh_axes else None for n in names]
        if None in idx:
            raise KeyError(f"spec {tuple(spec)} names an axis outside the mesh {tuple(mesh_axes)}")
        if idx != sorted(idx):
            raise ValueError(f"dimension {d}'s axes {names} are not in mesh order "
                             f"{tuple(mesh_axes)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {mesh_axes[i]!r} shards two dimensions of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def local_box(sh: Sharding, shape: Sequence[int]) -> tuple[tuple, tuple]:
    """(local shape, global offset) of this rank's shard."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(tuple(shape), sh.mesh, list(sh.placements))


def local_slices(sh: Sharding, shape: Sequence[int]) -> tuple:
    """This rank's shard of a host array of global ``shape``, as slices."""
    size, off = local_box(sh, shape)
    return tuple(slice(o, o + n) for o, n in zip(off, size))


def place(x: torch.Tensor, sh: Sharding):
    """A DTensor of ``sh`` from a tensor every rank holds whole: each rank
    keeps its own shard (a view of ``x``; no collective)."""
    return place_local(x[local_slices(sh, x.shape)], sh, x.shape)


def place_local(local: torch.Tensor, sh: Sharding, shape: Sequence[int]):
    """A DTensor of global ``shape`` around this rank's shard ``local``."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local(x):
    """The local shard of a DTensor (the same storage), anything else as
    it is; dicts, lists and tuples leaf by leaf."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    if isinstance(x, dict):
        return {k: local(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(local(v) for v in x)
    return x


def current() -> Optional[tuple]:
    """The installed (mesh, rules), or ``None``."""
    return _CTX.get()


@contextlib.contextmanager
def axis_rules(mesh, rules: Mapping[str, Optional[object]]):
    """Install (mesh, logical → mesh table) for :func:`shard`.  ``rules``
    maps a logical axis to a mesh axis, a tuple of them, or ``None``."""
    token = _CTX.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _CTX.reset(token)


def spec_for(names: Sequence[Optional[str]]) -> tuple:
    """Logical axis names → a partition spec under the current rules
    (``()``, replicated, outside a context)."""
    ctx = _CTX.get()
    if ctx is None:
        return ()
    _, rules = ctx
    return tuple(rules.get(n) if n is not None else None for n in names)


def sharding_for(names: Sequence[Optional[str]]) -> Optional[Sharding]:
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, _ = ctx
    return Sharding(mesh, placements(spec_for(names), mesh.mesh_dim_names))


def shard(x, names: Sequence[Optional[str]]):
    """Constrain ``x``'s layout by logical names; the identity outside a
    context."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if len(names) != x.dim():
        raise ValueError(f"rank mismatch: {tuple(names)} vs {tuple(x.shape)}")
    sh = sharding_for(names)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sh.mesh, [Replicate()] * sh.mesh.ndim, run_check=False)
    return x.redistribute(sh.mesh, sh.placements)


# ---------------------------------------------------------------------------
# The serving mesh's collectives.
# ---------------------------------------------------------------------------


def all_gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """``t`` from each of the ``n`` ranks of ``group``, concatenated along
    ``dim`` in the group's rank order (a mesh axis' coordinate order)."""
    import torch.distributed as dist

    wire = (t.view(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bool) if t.dtype == torch.bool else out


@dataclasses.dataclass(frozen=True)
class PoolShards:
    """One rank's place on a ``(data, model)`` serving mesh: the axis
    sizes and coordinates, the groups of ranks along each axis, and which
    axes the entry points split (``slots``: the slot axis over data;
    ``pages``: the pool's page axis over data; ``heads``: its kv heads
    over model).  An axis that is not split (size 1, or a dimension it
    does not divide) is whole on every rank and gathers nothing."""

    data: int
    model: int
    d: int
    m: int
    data_group: Any
    model_group: Any
    slots: bool
    pages: bool
    heads: bool

    def gather_slots(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return all_gather(t, self.data_group, self.data, dim) if self.slots else t

    def gather_pages(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return all_gather(t, self.data_group, self.data, dim) if self.pages else t

    def gather_heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(t, self.model_group, self.model, dim) if self.heads else t

    def own_heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``model`` equal blocks of ``dim`` (kv heads,
        or the query heads grouped over them)."""
        if not self.heads:
            return t
        n = t.shape[dim] // self.model
        return t.narrow(dim, self.m * n, n)

    def keep_own_pages(self, whole: torch.Tensor, mine: torch.Tensor) -> None:
        """Copy this rank's pages of a gathered layer pool back into its
        shard (nothing to do where the pages are not split: ``whole`` is
        the shard)."""
        if self.pages:
            mine.copy_(whole.narrow(0, self.d * mine.shape[0], mine.shape[0]))


def pool_shards() -> Optional[PoolShards]:
    """The installed :class:`PoolShards`, or ``None`` (an unsharded step,
    or a mesh whose axes are all of size 1)."""
    return _POOL.get()


@contextlib.contextmanager
def use_pool_shards(ps: Optional[PoolShards]):
    token = _POOL.set(ps)
    try:
        yield
    finally:
        _POOL.reset(token)
