"""The port's meshes, sharding context and placements
(``repro_torch.launch.mesh``, ``repro_torch.parallel``, the placements of
``repro_torch.launch.sharding`` and ``specs.paged_cache_shardings``), on
fake process groups (``FakeStore``: ranks with no devices and no traffic).

* ``make_host_mesh``'s refusals (the reference's messages,
  ``src/repro/launch/mesh.py:23-47``) and the ranks that sit a smaller
  mesh out;
* ``make_production_mesh`` at world 256 and 512;
* ``shard`` as the identity outside a context, and a redistribution
  inside one;
* the partition spec → placements conversion, tuple axes in mesh order
  laid out row-major as JAX lays them;
* every placement's local shard on a fake 16 × 16 mesh summing to
  ``per_device_bytes`` for stablelm-3b and granite-moe-3b-a800m: the
  parameters, the train state, a batch, the dense and the paged cache.
"""

import contextlib
import itertools

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import parallel as PX
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as LM
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.train import TrainConfig

ARCHS = ["stablelm-3b", "granite-moe-3b-a800m"]


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh16():
    with fake_group(256):
        yield LM.make_production_mesh(device="cpu")


def test_host_mesh_refusals():
    with fake_group(4):
        with pytest.raises(ValueError, match="model axis 3 does not divide the 4 local devices"):
            LM.make_host_mesh(model=3, device="cpu")
        with pytest.raises(ValueError, match="model axis 0 does not divide"):
            LM.make_host_mesh(model=0, device="cpu")
        with pytest.raises(ValueError, match=r"mesh \(3, 2\) needs 6 devices, have 4"):
            LM.make_host_mesh(model=2, data=3, device="cpu")
        with pytest.raises(ValueError, match=r"mesh \(0, 1\) needs 0 devices"):
            LM.make_host_mesh(model=1, data=0, device="cpu")
        mesh = LM.make_host_mesh(model=2, device="cpu")
        assert LM.mesh_shape(mesh) == {"data": 2, "model": 2}
        assert tuple(mesh.get_coordinate()) == (0, 0)


@pytest.mark.parametrize("rank,inside", [(0, True), (1, True), (2, False), (3, False)])
def test_ranks_past_the_mesh_sit_it_out(rank, inside):
    """A (2, 1) mesh on a group of 4: ranks 2 and 3 are in none of its
    groups."""
    with fake_group(4, rank):
        mesh = LM.make_host_mesh(model=1, data=2, device="cpu")
        assert LM.mesh_shape(mesh) == {"data": 2, "model": 1}
        assert LM.in_mesh(mesh) is inside


@pytest.mark.parametrize("multi_pod,world,shape", [(False, 256, {"data": 16, "model": 16}),
                                                   (True, 512, {"pod": 2, "data": 16,
                                                                "model": 16})])
def test_production_mesh(multi_pod, world, shape):
    with fake_group(world):
        mesh = LM.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert LM.mesh_shape(mesh) == shape
        assert SH.mesh_axis_sizes(mesh) == shape
    with fake_group(128):
        with pytest.raises(RuntimeError, match="bigger than default world size 128"):
            LM.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_shard_is_the_identity_without_context():
    x = torch.arange(12.0).reshape(3, 4)
    assert PX.current() is None
    assert PX.shard(x, ("batch", "embed")) is x
    assert PX.spec_for(("batch", "embed")) == ()
    assert PX.sharding_for(("batch", "embed")) is None


def test_shard_redistributes_inside_a_context(mesh16):
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    with PX.axis_rules(mesh16, {"batch": "data", "embed": "model", "seq": None}):
        assert PX.spec_for(("batch", None, "embed")) == ("data", None, "model")
        assert PX.sharding_for(("batch", "embed")).placements == (Shard(0), Shard(1))
        y = PX.shard(x, ("batch", "embed"))
        assert isinstance(y, DTensor)
        assert y.placements == (Shard(0), Shard(1))
        assert y.to_local().shape == (4, 2)
        assert torch.equal(y.to_local(), x[:4, :2])      # rank 0's block
        z = PX.shard(y, ("seq", "embed"))                # batch → replicated
        assert z.placements == (Replicate(), Shard(1))
        with pytest.raises(ValueError, match="rank mismatch"):
            PX.shard(x, ("batch",))
    assert PX.current() is None


def test_spec_to_placements():
    axes = ("pod", "data", "model")
    assert PX.placements((("pod", "data"), None, "model"), axes) == (
        Shard(0), Shard(0), Shard(2))
    assert PX.placements(("data",), axes) == (Replicate(), Shard(0), Replicate())
    assert PX.placements((None, None), axes) == (Replicate(),) * 3
    assert PX.placements((), ("data", "model")) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="not in mesh order"):
        PX.placements((("data", "pod"),), axes)
    with pytest.raises(ValueError, match="shards two dimensions"):
        PX.placements(("data", "data"), axes)
    with pytest.raises(KeyError, match="outside the mesh"):
        PX.placements(("expert",), axes)


def test_tuple_axes_lay_out_row_major():
    """A dimension over ("pod", "data") on a (2, 16, 16) mesh: the rank at
    (p, d, m) holds block p·16 + d, as JAX's PartitionSpec(("pod", "data"))
    lays it out, whatever its model coordinate."""
    pl = PX.placements((("pod", "data"), "model"), ("pod", "data", "model"))
    for p, d, m in itertools.product(range(2), range(16), (0, 5, 15)):
        size, off = _compute_local_shape_and_global_offset((64, 32), (2, 16, 16), [p, d, m], pl)
        assert size == (2, 2)
        assert off == ((p * 16 + d) * 2, m * 2)


def _local_bytes(tree, shardings) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v, shardings[k]) for k, v in tree.items())
    return torch.Size(shardings.local_shape(tree.shape)).numel() * tree.element_size()


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_match_per_device_bytes(mesh16, arch):
    """Each leaf's local shard on rank 0 of the fake 16 × 16 mesh, summed,
    equals ``per_device_bytes`` of the partition specs it is built from."""
    cfg = get_config(arch)
    sizes = SH.mesh_axis_sizes(mesh16)
    shape = SHAPES["train_4k"]

    params = SP.params_specs(cfg)
    got = _local_bytes(params, SH.param_shardings(params, mesh16, cfg))
    assert got == SH.per_device_bytes(params, SH.param_partition_specs(params, mesh16, cfg),
                                      sizes)
    assert got < SH.per_device_bytes(params, SH.param_partition_specs(params, {}, cfg), sizes)

    state = SP.train_state_specs(cfg, TrainConfig())
    sh, specs = SH.state_shardings(state, mesh16, cfg), SH.state_partition_specs(
        state, mesh16, cfg)
    trees = {"params": state.params, "m": state.opt.m, "v": state.opt.v}
    for name, tree in trees.items():
        assert _local_bytes(tree, sh[name]) == SH.per_device_bytes(tree, specs[name], sizes)
    assert sh["error"] is None

    batch = SP.train_batch_specs(cfg, shape)
    assert _local_bytes(batch, SH.batch_shardings(batch, mesh16, shape.global_batch)) == \
        SH.per_device_bytes(batch, SH.batch_partition_specs(batch, mesh16, shape.global_batch),
                            sizes)

    dense = SP.init_decode_cache(cfg, 32, 256, device="meta")
    assert _local_bytes(dense, SH.cache_shardings(dense, mesh16, cfg, 32)) == \
        SH.per_device_bytes(dense, SH.cache_partition_specs(dense, mesh16, cfg, 32), sizes)

    paged = SP.paged_decode_cache_specs(cfg, 32, 4096, 16)
    sh = SP.paged_cache_shardings(cfg, mesh16, 32, 4096, 16)
    assert sh == SH.cache_shardings(paged, mesh16, cfg, 32)
    got = _local_bytes(paged, sh)
    assert got == SH.per_device_bytes(paged, SH.cache_partition_specs(paged, mesh16, cfg, 32),
                                      sizes)
    # the pool's page axis over data, its kv heads over model where they divide
    kv_split = cfg.n_kv_heads % 16 == 0
    assert sh["k_pages"].placements == (Shard(2), Shard(4) if kv_split else Replicate())
    assert sh["pos"].placements == (Shard(0), Replicate())
