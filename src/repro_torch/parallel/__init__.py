"""The logical-axis sharding context (``repro/parallel/__init__.py``), on
DTensor, the wrappers a step on a mesh needs around ops with no DTensor
rule, and the serving mesh's collectives around the paged kernels.

Models annotate activations with logical axis names (``shard(x, ("batch",
"seq", "embed"))``); a launcher installs a device mesh and a logical →
mesh-axis table (:func:`axis_rules`).  Outside any context :func:`shard`
is the identity, so the same model code runs on one device and on a
mesh.  Inside one, it redistributes ``x`` (a DTensor; a plain tensor is
taken as replicated, as every rank holds the same one) to the placements
the rules give.  Serving installs no rules, as the reference's engine
never does: its sharding is the entry points' (``launch/specs.py``).

Where DTensor has no sharding rule, or the reference's numbers need the
whole operand, a model calls a wrapper that is the identity off a mesh:
:func:`on_whole` (the custom autograd Functions: crossbar reads, stochastic
Sigmoid gates, WTA trials, on replicated operands), :func:`batch_local`
(per-sequence ops on each rank's rows: the MoE dispatch and combine, as
the reference's ``shard_map``), :func:`along` (a scan along one dimension
on each rank's block: the RG-LRU scan), :func:`take_rows` and :func:`pick_last` (a
vocab-parallel lookup, the label's logit), :func:`write` / :func:`write_at` (in-place cache writes on each
rank's block), :func:`unflatten` and :func:`whole_dim` (a dimension a mesh
axis cannot split evenly, or a reduction over a split one, gathered
first).  :func:`flat_index` and :func:`reduce_over_shards` let AdamW and
gradient compression work on each rank's block of a leaf with the
unsharded draws and sums.

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


def placements(spec: Optional[Sequence], mesh_axes: Sequence[str],
               sizes: Optional[Sequence[int]] = None) -> tuple:
    """A partition spec → one placement per mesh axis of ``mesh_axes``
    (``Shard(d)`` where tensor dimension d names the axis, else
    ``Replicate()``).  A dimension's tuple of axes must be in mesh order,
    and an axis may shard one dimension only.  With the axes' ``sizes``,
    an axis of one rank splits nothing and is ``Replicate()`` (the same
    local tensor; some DTensor versions refuse a view across a dimension
    "sharded" over one rank)."""
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
    if sizes is not None:
        out = [Replicate() if n == 1 else p for p, n in zip(out, sizes)]
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

    stride, n = [], 1
    for size in reversed(tuple(shape)):   # the whole tensor's contiguous strides
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def split(x) -> bool:
    """Whether ``x`` is a DTensor that a mesh axis of more than one rank
    splits (its local shard is not the whole tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements))


def block(x) -> Optional[tuple]:
    """(global shape, local shape, global offset) of a DTensor's local
    shard; ``None`` for anything else."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    size, off = local_box(Sharding(x.device_mesh, tuple(x.placements)), x.shape)
    return tuple(x.shape), tuple(size), tuple(off)


def flat_index(blk: Optional[tuple], a: int, b: int, device=None):
    """Global flat indices of the local flat slice ``[a, b)`` of a block
    (:func:`block`): an int, the first of a contiguous run (a whole leaf,
    or a block whose trailing dimensions are whole), or else an int64
    tensor of ``b - a`` indices.  ``blk=None`` is a whole leaf: ``a``."""
    if blk is None:
        return a
    shape, size, off = blk
    lead = 0
    while lead < len(shape) and size[lead] == 1:
        lead += 1
    if all(size[d] == shape[d] for d in range(lead + 1, len(shape))):
        start, stride = 0, 1
        for d in reversed(range(len(shape))):
            start += off[d] * stride
            stride *= shape[d]
        return start + a
    rest = torch.arange(a, b, dtype=torch.int64, device=device)
    idx = torch.zeros_like(rest)
    stride = 1
    for d in reversed(range(len(shape))):
        idx += (rest % size[d] + off[d]) * stride
        rest = rest // size[d]
        stride *= shape[d]
    return idx


def reduce_over_shards(values: torch.Tensor, like, op: str = "sum") -> torch.Tensor:
    """``values`` (this rank's, a plain tensor) reduced with ``op`` over the
    mesh axes a DTensor ``like`` is split on: each leaf's sum or max counted
    once, whatever the mesh axes that replicate it.  ``like`` a plain
    tensor, or a DTensor split on no axis: ``values`` as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not split(like):
        return values
    pl = [Partial(op) if isinstance(p, Shard) else Replicate() for p in like.placements]
    return DTensor.from_local(values, like.device_mesh, pl, run_check=False).full_tensor()


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


def whole(x):
    """A DTensor's full value as a plain tensor (a collective every rank
    joins where it is split or partial); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


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
    return Sharding(mesh, placements(spec_for(names), mesh.mesh_dim_names, mesh.shape))


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


def on_whole(fn, *args):
    """``fn(*args)`` on whole operands: every DTensor argument is
    redistributed to ``Replicate()`` and passed as its local tensor, and
    every tensor ``fn`` returns is wrapped as a replicated DTensor on the
    same mesh (a later :func:`shard` then slices it with no collective).
    The custom autograd Functions (the crossbar read, the stochastic
    Sigmoid, the WTA trials) have no DTensor sharding rule, and their
    noise counters and range scales are those of the whole operands, so
    they run so on a mesh: each rank computes the whole result, bit-equal
    to the unsharded one, and DTensor's autograd carries the gradients back
    to each input's placement.  Without a DTensor argument, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor) else a
               for a in args))

    def wrap(t):
        return DTensor.from_local(t, mesh, rep, run_check=False) if isinstance(t, torch.Tensor) else t

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def along(fn, dim: int, *args):
    """``fn(*args)`` on each rank's block, for an op that mixes entries
    along dimension ``dim`` alone (a scan over the sequence) and has no
    DTensor rule: every DTensor argument (all of one shape) takes the
    first one's placements with ``dim`` whole (:func:`whole_dim`), and every
    output is laid out so.  Off a mesh, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor

    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    lay = whole_dim(first, dim)
    mesh, pl = lay.device_mesh, lay.placements
    out = fn(*(a.redistribute(mesh, pl).to_local() if isinstance(a, DTensor) else a
               for a in args))

    def wrap(t):
        return DTensor.from_local(t, mesh, pl, run_check=False) if isinstance(t, torch.Tensor) else t

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def batch_local(fn, args: Sequence, dims: Sequence[Optional[int]], out_dims):
    """``fn(*args)`` on this rank's rows of the batch, for an op that acts
    on every batch row alone and has no DTensor sharding rule (the MoE
    dispatch's scatters and cumsums, its combine's gathers): argument i is
    split on its dimension ``dims[i]`` over the mesh axes the rules give
    "batch" (``None``: replicated), and every output on ``out_dims`` (a
    tuple for a tuple of outputs; ``None`` where an output is not a
    tensor).  The counterpart of the reference's ``shard_map`` over the
    batch axes.  Outside a context, or without a DTensor argument,
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ctx = _CTX.get()
    if ctx is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh, rules = ctx
    bax = _axes(rules.get("batch"))

    def pl(d):
        return tuple(Shard(d) if d is not None and n in bax and k > 1 else Replicate()
                     for n, k in zip(mesh.mesh_dim_names, mesh.shape))

    def to_local(a, d):
        if isinstance(a, DTensor):   # a replicated argument's gradient: a partial sum
            grad = [Partial() if d is None and n in bax else p
                    for n, p in zip(mesh.mesh_dim_names, pl(d))]
            return a.redistribute(mesh, pl(d)).to_local(grad_placements=grad)
        return a[local_slices(Sharding(mesh, pl(d)), a.shape)] if isinstance(a, torch.Tensor) else a

    out = fn(*(to_local(a, d) for a, d in zip(args, dims)))

    def wrap(t, d):
        return DTensor.from_local(t, mesh, pl(d), run_check=False) if isinstance(t, torch.Tensor) else t

    if not isinstance(out, tuple):
        return wrap(out, out_dims)
    items = [wrap(t, d) for t, d in zip(out, out_dims)]
    return type(out)(*items) if hasattr(out, "_fields") else tuple(items)


def take_rows(w, idx):
    """``w[idx]``: rows of a table ``w`` (V, D) at integer ``idx``.  On a
    mesh (``w`` a DTensor) the table's row axis may be split (the vocab
    over "model"): its columns are gathered whole, each rank looks up the
    rows of its own block, zero elsewhere, and the partial results are
    summed over the axes that split the rows (one all-reduce); the rows
    keep ``idx``'s batch split.  Where no axis splits the rows, the lookup
    is ``w[idx]`` on the local table, the unsharded op, bit for bit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(w, DTensor):
        return w[idx]
    mesh = w.device_mesh
    wpl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in w.placements]
    w = w.redistribute(mesh, wpl)
    if isinstance(idx, DTensor):
        ipl = [Replicate() if isinstance(wp, Shard) else p for wp, p in zip(wpl, idx.placements)]
        idx = idx.redistribute(mesh, ipl).to_local()
    else:
        ipl = [Replicate()] * mesh.ndim
    size, off = local_box(Sharding(mesh, tuple(wpl)), w.shape)
    # a rank looks up only its rows of idx: where idx is split and the table
    # is not, its table gradient is a partial sum over those ranks
    wl = w.to_local(grad_placements=[Partial() if isinstance(ip, Shard) and not isinstance(wp, Shard)
                                     else wp for wp, ip in zip(wpl, ipl)])
    if size[0] == w.shape[0]:
        rows = wl[idx]
    else:
        rel = idx.long() - off[0]
        ok = (rel >= 0) & (rel < size[0])
        rows = torch.where(ok[..., None], wl[rel.clamp(0, size[0] - 1)], 0)
    opl = [Partial() if isinstance(wp, Shard) else ip for wp, ip in zip(wpl, ipl)]
    return reduce_partial(DTensor.from_local(rows, mesh, opl, run_check=False))


def pick_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]``: each row's entry of ``x``'s
    last dimension at ``idx`` (the label's logit).  On a mesh whose axes
    split that dimension (the vocab over "model") each rank picks from its
    own block, zero elsewhere, and the picks are summed over those axes:
    DTensor's own gather would build its gradient at the whole logits'
    size on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return x.gather(-1, idx[..., None])[..., 0]
    x = reduce_partial(x)
    mesh, d = x.device_mesh, x.dim() - 1
    ipl = [p if isinstance(p, Shard) and p.dim < d else Replicate() for p in x.placements]
    if isinstance(idx, DTensor):
        il = idx.redistribute(mesh, ipl).to_local()
    else:
        il = idx[local_slices(Sharding(mesh, tuple(ipl)), idx.shape)]
    size, off = local_box(Sharding(mesh, tuple(x.placements)), x.shape)
    xl = x.to_local()
    if size[d] == x.shape[d]:
        picks = xl.gather(-1, il[..., None])[..., 0]
    else:
        rel = il.long() - off[d]
        ok = (rel >= 0) & (rel < size[d])
        picks = torch.where(ok, xl.gather(-1, rel.clamp(0, size[d] - 1)[..., None])[..., 0], 0)
    opl = [Partial() if isinstance(p, Shard) and p.dim == d else ip
           for p, ip in zip(x.placements, ipl)]
    return reduce_partial(DTensor.from_local(picks, mesh, opl, run_check=False))


def write(dst, src, dim: Optional[int] = None, start: int = 0) -> None:
    """``dst.copy_(src)`` in place, or with ``dim`` the rows ``[start, start
    + src.shape[dim])`` of ``dst`` along ``dim``.  On a mesh (``dst`` a
    DTensor: a cache leaf) each rank writes what falls in its own block of
    ``dst``, from ``src`` laid out as ``dst`` (whole along ``dim``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(dst, DTensor):
        (dst if dim is None else dst.narrow(dim, start, src.shape[dim])).copy_(src)
        return
    mesh = dst.device_mesh
    d = None if dim is None else dim % dst.dim()
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == d else p for p in dst.placements)
    if isinstance(src, DTensor):
        sl = src.redistribute(mesh, pl).to_local()
    else:
        sl = src[local_slices(Sharding(mesh, pl), src.shape)]
    dl = dst.to_local()
    if d is None:
        dl.copy_(sl)
        return
    _, off = local_box(Sharding(mesh, tuple(dst.placements)), dst.shape)
    o, n = off[d], dl.shape[d]
    lo, hi = max(o, start), min(o + n, start + src.shape[d])
    if hi > lo:
        dl.narrow(d, lo - o, hi - lo).copy_(sl.narrow(d, lo - start, hi - lo))


def write_at(buf, new, pos) -> None:
    """Each slot's row ``new[b, 0]`` written at row ``pos[b]`` (clamped to
    the window) of ``buf`` (B, S, ...), in place.  On a mesh (``buf`` a
    DTensor) each rank writes its own slots' rows, and where the window is
    split (the sequence over "model") only the rank whose block holds a
    row writes it (the others write back what they hold)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(buf, DTensor):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf.index_put_((rows, pos.long().clamp(0, buf.shape[1] - 1)), new[:, 0])
        return
    mesh = buf.device_mesh
    npl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in buf.placements)
    ppl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in buf.placements)

    def lay(t, pl):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl).to_local()
        return t[local_slices(Sharding(mesh, pl), t.shape)]

    bl, nl, pl = buf.to_local(), lay(new, npl), lay(pos, ppl)
    if not split(buf):   # the unsharded write, on the whole local cache
        rows = torch.arange(bl.shape[0], device=bl.device)
        bl.index_put_((rows, pl.long().clamp(0, bl.shape[1] - 1)), nl[:, 0])
        return
    _, off = local_box(Sharding(mesh, tuple(buf.placements)), buf.shape)
    at = pl.long().clamp(0, buf.shape[1] - 1) - off[1]
    own = (at >= 0) & (at < bl.shape[1])
    at = at.clamp(0, bl.shape[1] - 1)
    rows = torch.arange(bl.shape[0], device=bl.device)
    keep = bl[rows, at]
    mask = own.view((-1,) + (1,) * (keep.dim() - 1))
    bl.index_put_((rows, at), torch.where(mask, nl[:, 0], keep))


def unflatten(x, dim: int, sizes: Sequence[int]):
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  On
    a mesh whose axes split that dimension into blocks the leading size
    does not divide (8 kv heads, or 12 heads, over a model axis of 16),
    the dimension is gathered first, as the reference's rules then
    replicate it."""
    from torch.distributed.tensor import DTensor, Shard

    d = dim % x.dim()
    if isinstance(x, DTensor):
        ways = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == d:
                ways *= x.device_mesh.size(i)
        if sizes[0] % ways:
            x = whole_dim(x, d)
    return x.reshape(x.shape[:d] + tuple(sizes) + x.shape[d + 1:])


def same_grad_layout(x):
    """``x`` itself, whose gradient is brought to ``x``'s own placements
    before it flows on (identity on a plain tensor).  Put after a reshape
    that merges dimensions a mesh axis could not split evenly (heads that
    were gathered): the gradient may come back split along the merged
    dimension, and DTensor cannot view it apart again."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def whole_dim(x, dim: int):
    """``x`` with dimension ``dim`` whole on every rank (the mesh axes that
    split it gathered, pending reductions carried out), its other
    placements kept; anything else as it is.  For an op whose DTensor rule
    cannot take a split reduction dimension (an argmax over the vocab)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    d = dim % x.dim()
    pl = [Replicate() if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim == d) else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def reduce_partial(x):
    """``x`` with every pending reduction (a ``Partial`` placement) carried
    out, so that it is replicated over those mesh axes; anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in x.placements])


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
