"""The port's dry-run tooling (``repro_torch.configs.cells``,
``launch/specs``' meta input specs, ``launch/sharding``'s policy,
``launch/roofline``, ``launch/dryrun``, ``launch/report``) against the
reference on the CPU.

- ``cells()`` and ``ASSIGNED_ARCHS``: equal to the reference's, in order.
- Every full-size arch's parameter, AdamW moment and error-feedback leaf
  (``train_state_specs`` with and without compression), every batch
  leaf, every dense decode-cache leaf at every decode cell and every
  paged-cache leaf: the reference's ``jax.eval_shape`` name, shape and
  dtype.  The step counters and the PRNG key are host values in the port
  and are left out.  Every port leaf is on ``meta``.
- The partition spec of every parameter, moment and cache leaf, on the
  reference's two fake meshes (16 × 16 and 2 × 16 × 16): equal to the
  reference's ``_spec_for_path`` and ``cache_partition_specs`` as tuples;
  ``per_device_bytes`` equal to the same sum over the reference's specs;
  ``tests/test_distribution.py``'s policy cases.
- ``model_flops`` equal to the reference's at every cell; the roofline's
  tie-break (``tests/test_distribution.py:174-200``) at the H100's
  constants, with the collective term and without it.
- A train, a prefill and a decode step of each LM family's smoke config
  and whisper's on meta: FLOPs equal to the same step's on real CPU
  tensors, the peak of live bytes and the bytes accessed within the few
  bytes of host scalars (``HOST_SCALAR_BYTES``).
- ``dryrun.py`` writes its records and ``report.py`` renders them, SKIP
  rows included.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import cells as j_cells
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import roofline as JRL
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro.train import TrainConfig as JTrainConfig
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, ShapeSpec, cells, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as REP
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.train import TrainConfig

PAGED = dict(batch=8, n_pages=64, block_size=16)


class FakeMesh:
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {
    "single": FakeMesh(("data", "model"), (16, 16)),
    "multi": FakeMesh(("pod", "data", "model"), (2, 16, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(kp) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp)


def _jflat(tree) -> dict:
    """{path: ShapeDtypeStruct} of a reference tree."""
    return {_path(kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tflat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same_leaves(port: dict, ref: dict) -> None:
    """Same names; each port leaf on meta with the reference's shape and dtype."""
    tf, jf = _tflat(port), _jflat(ref)
    assert sorted(tf) == sorted(jf)
    for name, leaf in tf.items():
        assert leaf.is_meta, name
        assert tuple(leaf.shape) == tuple(jf[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == jnp.dtype(jf[name].dtype).name, name


def _decode_cells():
    return [(a, s) for a, s, _ in j_cells() if J_SHAPES[s].kind == "decode"]


@pytest.fixture(scope="module")
def ref_states():
    """The reference's eval_shape train states, with and without compression."""
    return {(a, c): JSP.train_state_specs(j_config(a), JTrainConfig(compress_grads=c))
            for a in J_ARCHS for c in (False, True)}


def test_cells_and_archs_equal_reference():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert cells() == j_cells() and len(cells()) == 32
    assert cells(include_skipped=True) == j_cells(include_skipped=True)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_train_state_and_batch_specs_equal_reference(arch, ref_states):
    for compress in (False, True):
        ref = ref_states[(arch, compress)]
        st = SP.train_state_specs(get_config(arch), TrainConfig(compress_grads=compress))
        _same_leaves(st.params, ref.params)
        _same_leaves(st.opt.m, ref.opt.m)
        _same_leaves(st.opt.v, ref.opt.v)
        assert (st.compress is None) == (ref.compress is None) == (not compress)
        if compress:
            _same_leaves(st.compress.error, ref.compress.error)
    _same_leaves(SP.params_specs(get_config(arch)), JSP.params_specs(j_config(arch)))
    for shape in SHAPES:
        _same_leaves(SP.train_batch_specs(get_config(arch), SHAPES[shape]),
                     JSP.train_batch_specs(j_config(arch), J_SHAPES[shape]))
        _same_leaves(SP.prefill_batch_specs(get_config(arch), SHAPES[shape]),
                     JSP.prefill_batch_specs(j_config(arch), J_SHAPES[shape]))


@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_decode_cache_specs_equal_reference(arch, shape):
    _same_leaves(SP.decode_cache_specs(get_config(arch), SHAPES[shape]),
                 JSP.decode_cache_specs(j_config(arch), J_SHAPES[shape]))
    ins = SP.input_specs(arch, shape)
    assert ins["kind"] == "decode" and ins["token"].is_meta
    assert tuple(ins["token"].shape) == (SHAPES[shape].global_batch,)


@pytest.mark.parametrize("arch", [a for a in J_ARCHS if a != "whisper-small"])
def test_paged_cache_specs_equal_reference(arch):
    for kv in ("same", "int8"):
        jc = dataclasses.replace(j_config(arch), kv_cache_dtype=kv)
        tc = dataclasses.replace(get_config(arch), kv_cache_dtype=kv)
        _same_leaves(SP.paged_decode_cache_specs(tc, **PAGED),
                     JSP.paged_decode_cache_specs(jc, **PAGED))


def test_paged_cache_specs_refuse_encdec():
    with pytest.raises(ValueError, match="token-LM only"):
        SP.paged_decode_cache_specs(get_config("whisper-small"), **PAGED)


def _ref_param_specs(arch, tree, mesh) -> dict:
    cfg = j_config(arch)
    fsdp = cfg.force_fsdp if cfg.force_fsdp is not None else (
        cfg.param_count() >= JSH.FSDP_THRESHOLD)
    return {name: tuple(JSH._spec_for_path(name, leaf.shape, mesh, fsdp))
            for name, leaf in _jflat(tree).items()}


def _ref_bytes(tree, specs: dict, mesh) -> int:
    sizes = JSH.mesh_axis_sizes(mesh)
    total = 0
    for name, leaf in _jflat(tree).items():
        n = 1
        for ax in specs[name]:
            for a in () if ax is None else ax if isinstance(ax, tuple) else (ax,):
                n *= sizes[a]
        total += math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize // n
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", J_ARCHS)
def test_partition_specs_and_bytes_equal_reference(arch, mesh, ref_states):
    fake = MESHES[mesh]
    sizes = SH.mesh_axis_sizes(fake)
    assert sizes == JSH.mesh_axis_sizes(fake)
    ref = ref_states[(arch, True)]
    want = _ref_param_specs(arch, ref.params, fake)
    st = SP.train_state_specs(get_config(arch), TrainConfig(compress_grads=True))
    got = SH.state_partition_specs(st, fake, get_config(arch))
    for part in ("params", "m", "v", "error"):
        assert _tflat(got[part]) == want, part
    assert SH.per_device_bytes(st.params, got["params"], sizes) == _ref_bytes(
        ref.params, want, fake)
    for shape in SHAPES:
        if J_SHAPES[shape].kind != "decode" or shape in _skips(arch):
            continue
        b = SHAPES[shape].global_batch
        jcache = JSP.decode_cache_specs(j_config(arch), J_SHAPES[shape])
        jspec = {k: tuple(v) for k, v in
                 JSH.cache_partition_specs(jcache, fake, j_config(arch), b).items()}
        cache = SP.decode_cache_specs(get_config(arch), SHAPES[shape])
        tspec = SH.cache_partition_specs(cache, fake, get_config(arch), b)
        assert tspec == jspec, shape
        assert SH.per_device_bytes(cache, tspec, sizes) == _ref_bytes(jcache, jspec, fake)
        batch = SP.prefill_batch_specs(get_config(arch), SHAPES[shape])
        assert SH.batch_partition_specs(batch, fake, b) == {
            k: tuple(JP(JSH.batch_axes(fake, b), *(None,) * (v.dim() - 1)))
            for k, v in batch.items()}
    if arch != "whisper-small":
        for kv in ("same", "int8"):
            jc = dataclasses.replace(j_config(arch), kv_cache_dtype=kv)
            tc = dataclasses.replace(get_config(arch), kv_cache_dtype=kv)
            jspec = JSH.cache_partition_specs(JSP.paged_decode_cache_specs(jc, **PAGED), fake,
                                              jc, PAGED["batch"])
            tspec = SH.cache_partition_specs(SP.paged_decode_cache_specs(tc, **PAGED), fake, tc,
                                             PAGED["batch"])
            assert tspec == {k: tuple(v) for k, v in jspec.items()}


def _skips(arch):
    from repro.configs import skip_shapes

    return skip_shapes(arch)


def test_divisibility_guard_drops_axes():
    """heads=56 is not divisible by model=16 → replicated, not padded."""
    fake = MESHES["single"]
    rules = SH.activation_rules(fake, get_config("deepseek-coder-33b"), 256)
    assert rules["heads"] is None and rules["kv_heads"] is None
    assert rules["ffn"] == "model" and rules["batch"] == ("data",)
    assert SH.activation_rules(fake, get_config("stablelm-3b"), 256)["heads"] == "model"
    for arch in ("deepseek-coder-33b", "stablelm-3b", "recurrentgemma-2b"):
        for b in (1, 2, 256):
            assert SH.activation_rules(fake, get_config(arch), b) == JSH.activation_rules(
                fake, j_config(arch), b)


def test_batch_axes_adapt_to_batch_size():
    fake = MESHES["multi"]
    assert SH.batch_axes(fake, 256) == ("pod", "data")
    assert SH.batch_axes(fake, 1) is None
    assert SH.batch_axes(fake, 2) == ("pod",)
    assert SH.batch_axes({"data": 4, "model": 2}, 8) == ("data",)


def test_param_rules_shard_big_models_fsdp():
    cfg = get_config("nemotron-4-340b")  # > FSDP threshold
    leaf = torch.empty((96, 18432, 73728), dtype=torch.bfloat16, device="meta")
    specs = SH.param_partition_specs({"units": {"l0": {"ffn": {"w_up": leaf}}}},
                                     {"data": 1, "model": 1}, cfg)
    assert specs["units"]["l0"]["ffn"]["w_up"] == (None, "data", "model")


def test_paged_pool_partition_specs_on_fake_mesh():
    """``tests/test_distribution.py:235-273``'s cases on the port's smoke
    configs and a (data=2, model=2) mesh."""
    fake = FakeMesh(("data", "model"), (2, 2))
    cfg = get_smoke_config("stablelm-3b")  # kv_heads=4: divisible by 2
    specs = SH.cache_partition_specs(
        SP.paged_decode_cache_specs(cfg, batch=4, n_pages=8, block_size=8), fake, cfg, 4)
    assert specs["k_pages"] == specs["v_pages"] == (None, None, "data", None, "model", None)
    assert specs["pos"] == ("data",)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    specs8 = SH.cache_partition_specs(
        SP.paged_decode_cache_specs(cfg8, batch=4, n_pages=8, block_size=8), fake, cfg8, 4)
    assert specs8["k_pages"] == (None, None, "data", None, "model", None)
    assert specs8["k_scale_pages"] == specs8["v_scale_pages"] == (None, None, "data", None,
                                                                  "model")
    assert specs8["quant_step"] == ()
    cfg1 = get_smoke_config("recurrentgemma-2b")  # kv_heads=1: heads replicate
    specs1 = SH.cache_partition_specs(
        SP.paged_decode_cache_specs(cfg1, batch=4, n_pages=8, block_size=8), fake, cfg1, 4)
    assert specs1["k_pages"] == (None, None, "data", None, None, None)
    odd = SH.cache_partition_specs(
        SP.paged_decode_cache_specs(cfg, batch=4, n_pages=7, block_size=8), fake, cfg, 4)
    assert odd["k_pages"] == (None, None, None, None, "model", None)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in j_cells()])
def test_model_flops_equal_reference(arch, shape):
    assert RL.model_flops(get_config(arch), SHAPES[shape]) == JRL.model_flops(
        j_config(arch), J_SHAPES[shape])


def test_roofline_dominant_term_tie_break():
    """Tied times resolve by listed order (compute, memory, collective);
    with collectives not measured the term is absent."""
    def rec(flops, bytes_, coll):
        return {"cost": {"flops": flops, "bytes accessed": bytes_},
                "collectives": None if coll is None else {"total_bytes": coll},
                "model_flops_per_chip": flops}

    f = RL.PEAK_FLOPS
    t = RL.roofline_terms(rec(f, RL.HBM_BW, RL.LINK_BW))
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    assert t["dominant"] == "compute"
    assert RL.roofline_terms(rec(f, RL.HBM_BW, 0.0))["dominant"] == "compute"
    assert RL.roofline_terms(rec(f, 3 * RL.HBM_BW, 0.0))["dominant"] == "memory"
    assert RL.roofline_terms(rec(f, 0.0, 3 * RL.LINK_BW))["dominant"] == "collective"
    t = RL.roofline_terms(rec(f, RL.HBM_BW, None))
    assert t["collective_s"] is None and t["dominant"] == "compute" and t["bound_s"] == 1.0
    assert RL.roofline_terms(rec(f, 2 * RL.HBM_BW, None))["dominant"] == "memory"
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW, RL.HBM_PER_DEVICE) == (989e12, 3.35e12, 450e9,
                                                                          80e9)


# the prefill cell's 64 positions hold whisper's smoke decoder prompt
SMOKE_SHAPES = (ShapeSpec("train", 16, 4, "train"), ShapeSpec("prefill", 64, 2, "prefill"),
                ShapeSpec("decode", 32, 2, "decode"))
HOST_SCALAR_BYTES = 64


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m", "recurrentgemma-2b",
                                  "mamba2-1.3b", "llava-next-34b", "whisper-small"])
def test_meta_counts_equal_cpu_counts(arch):
    cfg = get_smoke_config(arch)
    # the accumulation over microbatches once, at the cheapest arch
    tcfg = TrainConfig(microbatches=2 if arch == "stablelm-3b" else 1)
    for shape in SMOKE_SHAPES:
        meta = D.count_step(cfg, shape, tcfg, SP.cell_inputs(cfg, shape, tcfg))
        cpu = D.count_step(cfg, shape, tcfg, D.real_inputs(cfg, shape, tcfg, "cpu"))
        assert meta["flops"] > 0, shape.kind
        assert meta["flops"] == cpu["flops"], (shape.kind, meta, cpu)
        # host scalars: the micro-batched loss's is copied to meta (a real
        # copy there, none on the CPU); a 0-dim constant built on the CPU is
        # a new storage there (lift_fresh), on meta none
        for k in ("temp_bytes", "bytes_accessed"):
            assert abs(meta[k] - cpu[k]) <= HOST_SCALAR_BYTES, (shape.kind, k, meta, cpu)


def test_train_step_leaves_nothing_live():
    """Once a train step has returned, nothing it made is live but the
    cached RoPE frequencies: no reference cycle holds its gradients until
    Python's cyclic collector runs (a self-referring closure in
    ``tree_unflatten`` did, and the card's peak then carried the last
    step's gradients)."""
    import gc

    cfg = get_smoke_config("stablelm-3b")
    shape, tcfg = SMOKE_SHAPES[0], TrainConfig()
    ins = D.real_inputs(cfg, shape, tcfg, "cpu")
    step = D.make_step(cfg, shape, tcfg)
    gc.collect()
    gc.disable()
    try:
        live = D.LiveBytes(held=D.input_tree(ins))
        with live:
            step(ins)
        assert live.peak > 0 and live.live <= HOST_SCALAR_BYTES, live.live
    finally:
        gc.enable()


def test_dryrun_records_and_report(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    D.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out", str(out)])
    D.main(["--arch", "stablelm-3b", "--shape", "long_500k", "--mesh", "single",
            "--out", str(out)])
    results = json.loads(out.read_text())
    assert set(results) == {"mamba2-1.3b|long_500k|single", "mamba2-1.3b|long_500k|multi",
                            "stablelm-3b|long_500k|skipped"}
    rec = results["mamba2-1.3b|long_500k|single"]
    cfg, shape = get_config("mamba2-1.3b"), SHAPES["long_500k"]
    coll = rec["collectives"]   # measured on the fake 16 x 16 group, rank 0
    assert rec["per_device_batch"] == 1
    assert coll["count"] == coll["comm_debug_count"] > 0
    assert coll["total_bytes"] == sum(coll[k] for k in RL.COLLECTIVE_OPS) > 0
    assert rec["params"] == cfg.param_count()
    assert rec["model_flops_global"] == RL.model_flops(cfg, shape)
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / 256
    assert rec["args_bytes"]["per_device"] < rec["args_bytes"]["whole"]
    assert rec["cost"]["flops"] > 0 and "step_counts" not in rec   # rank 0's own counts
    assert rec["roofline"] == RL.roofline_terms(rec)
    assert rec["roofline"]["collective_s"] == coll["total_bytes"] / RL.LINK_BW
    REP.main([str(out)])
    text = capsys.readouterr().out
    assert "## cells ok: 2; failed: 0" in text
    assert "| stablelm-3b | long_500k | - | SKIP |" in text
    assert "| mamba2-1.3b | long_500k | single |" in text and "fits 80 GB" in text
    assert "FLOPs (matrix ops only)" in text
    assert "not measured" not in text
    crow = [ln for ln in text.splitlines() if ln.startswith("| mamba2-1.3b | long_500k | ")
            and ln.endswith(f" | {coll['count']} |")]
    assert crow and REP.fmt_bytes(coll["all-reduce"]) in crow[0]
    row = [ln for ln in text.splitlines() if ln.startswith("| mamba2-1.3b | long_500k | ")
           and "memory" in ln]
    assert row and f"| {REP.fmt_s(rec['roofline']['collective_s'])} |" in row[0]
    REP.main([str(out), "--compact"])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 3 and rows[2].startswith("| mamba2-1.3b | long_500k | ")
    assert "| yes · yes |" in rows[2] and "(memory) |" in rows[2]
