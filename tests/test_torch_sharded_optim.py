"""AdamW's and gradient compression's draws on a shard, on a fake 4 × 4
mesh in one process (``FakeStore``: no devices, each collective a no-op).

A rank's block of a leaf split over the mesh is not contiguous in flat
order; ``parallel.flat_index`` gives its global flat indices, and the
threefry draws there are the whole draw's at those indices.  So each
rank's stochastically rounded moments and compressed gradients are,
bit for bit, its slice of the unsharded ones.  The fake group runs no
collective, so ``global_norm``'s and compression's cross-rank reductions
are held here by what they issue (one all-reduce per placement group, a
max over the leaf's split), and by value on real gloo ranks in
``tests/test_torch_sharded_train.py``.
"""

import contextlib

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.optim import adamw as AD
from repro_torch.optim import compress as CP
from repro_torch.optim import global_norm

SHAPE = (2, 8, 16)   # a stacked leaf: (units, rows, cols)
PLACEMENTS = {
    "model_cols": (Replicate(), Shard(2)),
    "data_rows_model_cols": (Shard(1), Shard(2)),
    "data_cols": (Shard(2), Replicate()),
    "model_rows": (Replicate(), Shard(1)),
}
RANKS = [0, 6, 15]
KEY = R.fold_in(R.PRNGKey(3), 7)


@contextlib.contextmanager
def mesh44(rank: int):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _leaf(seed: int = 0) -> torch.Tensor:
    """f32 values whose every 2 × 4 block of (rows, cols) holds the leaf's
    largest magnitude, 1.0: a block's own max is the whole leaf's, so the
    fake group's no-op max cannot hide a wrong scale."""
    x = torch.rand(SHAPE, generator=torch.Generator().manual_seed(seed)) * 1.8 - 0.9
    x[:, ::2, ::4] = 1.0
    return x


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_flat_index_names_the_blocks_entries(name, rank):
    whole = torch.arange(torch.Size(SHAPE).numel()).reshape(SHAPE)
    with mesh44(rank) as mesh:
        sh = PX.Sharding(mesh, PLACEMENTS[name])
        blk = PX.block(PX.place(whole.float(), sh))
        want = whole[PX.local_slices(sh, SHAPE)].reshape(-1)
        n = want.numel()
        for a, b in ((0, n), (1, n - 3)):
            at = PX.flat_index(blk, a, b)
            got = torch.arange(at, at + b - a) if isinstance(at, int) else at
            assert torch.equal(got, want[a:b])


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_adamw_rounding_bits_on_a_shard(name, rank):
    """A rank's moments round with the bits the unsharded leaf has there,
    in one slice or in two (AdamW's chunks)."""
    x = _leaf()
    want = AD._sround(x.reshape(-1), torch.bfloat16, KEY, 0).reshape(SHAPE)
    with mesh44(rank) as mesh:
        sh = PX.Sharding(mesh, PLACEMENTS[name])
        d = PX.place(x, sh)
        blk, xl = PX.block(d), d.to_local().reshape(-1)
        n = xl.numel()
        whole = AD._sround(xl, torch.bfloat16, KEY, PX.flat_index(blk, 0, n))
        parts = torch.cat([AD._sround(xl[a:b], torch.bfloat16, KEY, PX.flat_index(blk, a, b))
                           for a, b in ((0, n // 2), (n // 2, n))])
        mine = want[PX.local_slices(sh, SHAPE)].reshape(-1)
        assert torch.equal(whole.view(torch.int16), mine.view(torch.int16))
        assert torch.equal(parts.view(torch.int16), mine.view(torch.int16))


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_compression_on_a_shard(name, rank):
    """A rank's compressed block is its slice of the unsharded leaf's
    (the grid from the leaf's max, the uniforms at the block's indices);
    the max is taken over the ranks the leaf is split across: an
    all-reduce per splitting axis, none for a leaf no axis splits."""
    x = _leaf(1)
    want = CP._quantize_leaf(x, KEY)
    with mesh44(rank) as mesh:
        sh = PX.Sharding(mesh, PLACEMENTS[name])
        d = PX.place(x, sh)
        with CommDebugMode() as comm:
            got = CP._quantize_leaf(d.to_local(), KEY, d)
        # one all-reduce of the max over each mesh axis that splits the leaf
        assert comm.get_total_counts() == sum(isinstance(p, Shard) for p in PLACEMENTS[name])
        assert torch.equal(got, want[PX.local_slices(sh, SHAPE)])
        rep = PX.place(x, PX.Sharding(mesh, (Replicate(), Replicate())))
        with CommDebugMode() as comm:
            assert torch.equal(CP._quantize_leaf(rep.to_local(), KEY, rep), want)
        assert comm.get_total_counts() == 0


def test_global_norm_reduces_once_per_placement():
    """Replicated leaves sum locally, as unsharded, bit for bit; split
    leaves add one all-reduce per set of placements, not one a leaf."""
    tree = {"a": _leaf(2), "b": {"c": _leaf(3), "d": _leaf(4)[0], "e": _leaf(5)}}
    want = global_norm(tree)
    with mesh44(5) as mesh:
        rep = (Replicate(), Replicate())
        placed = {k: PX.place(v, PX.Sharding(mesh, rep)) for k, v in
                  (("a", tree["a"]), ("d", tree["b"]["d"]))}
        with CommDebugMode() as comm:
            got = global_norm({"a": placed["a"], "b": {"d": placed["d"]}})
        assert comm.get_total_counts() == 0
        assert torch.equal(got, global_norm({"a": tree["a"], "b": {"d": tree["b"]["d"]}}))
        split = {"a": PX.place(tree["a"], PX.Sharding(mesh, PLACEMENTS["model_cols"])),
                 "b": {"c": PX.place(tree["b"]["c"], PX.Sharding(mesh, PLACEMENTS["model_cols"])),
                       "d": placed["d"],
                       "e": PX.place(tree["b"]["e"], PX.Sharding(mesh, PLACEMENTS["data_cols"]))}}
        with CommDebugMode() as comm:
            got = global_norm(split)
        counts = comm.get_comm_counts()
        assert sum(counts.values()) == 2 and all(str(k).endswith(".all_reduce") for k in counts)
        assert got.shape == want.shape and not isinstance(got, type(split["a"]))
