"""The dry run's mesh terms: a step on DTensors over a fake process group
(``FakeStore``, one process), counted as its rank 0 runs it.

- a column-parallel then row-parallel MLP forward on a fake ``(1, m)``
  mesh issues exactly one all-reduce, of its (B, S, D) output, counted as
  twice its bytes (the reference's formula);
- on a 1 × 1 fake mesh a cell's temp, FLOPs and bytes accessed equal the
  unsharded step's, and nothing is sent;
- on the 16 × 16 mesh a cell's per-device counts are its rank's own: the
  batch and the heads split (FLOPs a sixteenth of the unsharded step's at
  the rank's batch share), the collectives counted and matched against
  ``CommDebugMode``.
"""

import contextlib
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import parallel as PX
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.models import layers as L
from repro_torch.train import TrainConfig

SMOKE = {"train": dataclasses.replace(SHAPES["train_4k"], global_batch=4, seq_len=32),
         "prefill": dataclasses.replace(SHAPES["prefill_32k"], global_batch=2, seq_len=64),
         "decode": dataclasses.replace(SHAPES["decode_32k"], global_batch=2, seq_len=64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def fake_group(world: int):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("m", [2, 4])
def test_column_then_row_mlp_counts_one_all_reduce(m):
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    b, s, d, f = 2, 8, cfg.d_model, cfg.d_ff
    params = {"ffn": {"w_up": torch.empty(d, f, device="meta"),
                      "w_gate": torch.empty(d, f, device="meta"),
                      "w_down": torch.empty(f, d, device="meta")}}
    with fake_group(m):
        mesh = LM.make_host_mesh(model=m, device="cpu")
        sh = SH.param_shardings(params, mesh, cfg)
        p = {k: PX.place(v, sh["ffn"][k]) for k, v in params["ffn"].items()}
        x = torch.empty(b, s, d, device="meta")
        colls, comm = D.Collectives(), CommDebugMode()
        with comm, colls, PX.axis_rules(mesh, SH.activation_rules(mesh, cfg, b)), \
                implicit_replication():
            y = L.mlp_apply(p, x, cfg)
    assert tuple(y.shape) == (b, s, d)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert counts == {"c10d_functional.all_reduce": 1}
    rec = colls.record()
    assert rec["count"] == 1 and rec["all-reduce"] == 2 * b * s * d * 4
    assert rec["total_bytes"] == rec["all-reduce"]


@pytest.mark.parametrize("kind", list(SMOKE))
@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m", "mamba2-1.3b",
                                  "whisper-small"])
def test_one_by_one_mesh_counts_equal_unsharded(arch, kind):
    """Temp, FLOPs and bytes accessed as the unsharded step's (``torch``'s
    own bookkeeping on host tensors aside, ``LiveBytes``), and no
    collective.  DTensor runs a decode step's final argmax as ``max.dim``
    (4 bytes more accessed here)."""
    cfg = get_smoke_config(arch)
    shape, tcfg = SMOKE[kind], TrainConfig(microbatches=2)
    with fake_group(1):
        mesh = LM.make_host_mesh(model=1, device="cpu")
        L._ROPE_FREQS.clear()   # the RoPE frequencies are built once a process
        plain = D.count_step(cfg, shape, tcfg, SP.cell_inputs(cfg, shape, tcfg))
        L._ROPE_FREQS.clear()
        meshed = D.count_step(cfg, shape, tcfg, SP.cell_inputs(cfg, shape, tcfg), mesh)
    assert meshed["flops"] == plain["flops"] > 0
    assert meshed["temp_bytes"] == plain["temp_bytes"]
    extra = 4 if kind == "decode" else 0
    assert plain["bytes_accessed"] <= meshed["bytes_accessed"] <= plain["bytes_accessed"] + extra
    assert meshed["collectives"]["count"] == meshed["collectives"]["total_bytes"] == 0


def test_production_mesh_counts_a_ranks_share():
    """stablelm-3b's decode cell on the 16 × 16 mesh: rank 0 sends what
    CommDebugMode counts, and its FLOPs are exactly a sixteenth of the
    unsharded step's at its batch share (128 / 16 rows): its 32 heads, the
    MLP's columns and the vocabulary split evenly over the model axis."""
    cfg, shape = get_config("stablelm-3b"), SHAPES["decode_32k"]
    rec = D.run_cell("stablelm-3b", "decode_32k", "single")
    share = dataclasses.replace(shape, global_batch=shape.global_batch // 16)
    whole = D.count_step(cfg, share, TrainConfig(), SP.cell_inputs(cfg, share, TrainConfig()))
    coll = rec["collectives"]
    assert coll["count"] == coll["comm_debug_count"] > 0
    assert coll["total_bytes"] == sum(coll[k] for k in RL.COLLECTIVE_OPS) > 0
    assert coll["reduce-scatter"] == 0   # a forward step: its row-parallel products all-reduce
    assert rec["roofline"]["collective_s"] == coll["total_bytes"] / RL.LINK_BW
    assert rec["per_device_batch"] == 8
    assert rec["cost"]["flops"] == whole["flops"] / 16
    assert rec["temp_bytes"] < whole["temp_bytes"]
