"""Sharded training on DTensor meshes against the unsharded port.

Two gloo ranks are spawned once for the module (``tests/_sharded_train_worker.py``,
one intra-op thread a rank) and train stablelm-3b smoke at f32 (B = 4,
S = 16, three steps) on ``(data, model)`` meshes of 1 × 2 and 2 × 1:
digital, ``analog_stochastic``, int8 gradient compression and two
microbatches, plus analog with two microbatches on 2 × 1, recurrentgemma-2b
(analog) and granite-moe-3b-a800m on 1 × 2.  The same runs without a mesh
(this process) are the yardstick; the unsharded port is held to the
reference by ``tests/test_torch_train.py``, and here once more through a
1 × 1 mesh from the reference's own state (the reference's sharded
training cannot run on the installed jax, ROADMAP C).

Tolerances, and why:

- losses and gradient norms: 1e-5 relative, the port's loss tolerance (``PERF.md`` §2).  A
  sharded step sums some products and reductions in another order (a
  row-parallel product's partial sums over "model", the vocab's log-sum-exp,
  a microbatch's rows over "data"); measured: below 1e-7 relative;
- parameters after three steps: within the error budget of a flipped
  update, ``2 · Σ_t lr_t · (U + wd · max|p|)`` with ``U = 1.01`` bounding
  AdamW's normalised step ``|m̂ / (√v̂ + ε)|`` over three steps (1.001 by
  Cauchy-Schwarz at b1 = 0.9, b2 = 0.95); and 99.9% of them within 1e-6
  (measured: all within 2e-7);
- the first step's crossbar reads: bit-equal (the kernels run on whole
  operands: the same inputs, scale and noise counters);
- checkpoints re-sharded either way: bit-equal; a sharded restart: the
  uninterrupted sharded run's losses, bit-equal (the same state, keys and
  batches).
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))
import _sharded_train_worker as W  # noqa: E402

LOSS_RTOL = 1e-5
U_BOUND = 1.01
PARAM_CLOSE = 0.999
PARAM_ATOL = 1e-6
WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train")
    mp.spawn(W.train, args=(WORLD, str(out / "store"), str(out)), nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def unsharded():
    cache = {}

    def get(arch, analog, overrides):
        key = (arch, analog, tuple(sorted(overrides.items())))
        if key not in cache:
            cache[key] = W.run_steps(arch, analog, overrides, None, reads=analog)
        return cache[key]

    return get


def _case(name):
    if name in W.EXTRA:
        return W.EXTRA[name][1:]
    return W.CASES[name.rsplit("_", 1)[0]]


RUNS = [f"{c}_{m}" for m in W.MESHES for c in W.CASES] + list(W.EXTRA)


def test_gloo_ranks_finished(gloo):
    for r, res in enumerate(gloo):
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"


@pytest.mark.parametrize("name", RUNS)
def test_sharded_losses_equal_unsharded(gloo, unsharded, name):
    got, want = gloo[0][name]["losses"], unsharded(*_case(name))["losses"]
    assert len(got) == W.STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert gloo[1][name]["losses"] == got   # every rank reads the same whole loss
    # AdamW's update is nearly blind to a gradient's scale; its norm is not
    np.testing.assert_allclose(gloo[0][name]["grad_norms"], unsharded(*_case(name))["grad_norms"],
                               rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", RUNS)
def test_sharded_params_within_budget(gloo, unsharded, name):
    from repro_torch.optim import warmup_cosine

    got, want = gloo[0][name]["params"], unsharded(*_case(name))["params"]
    tcfg = W.train_config(_case(name)[2])
    pmax = max(float(p.abs().max()) for p in want)
    lrs = [tcfg.opt.lr * warmup_cosine(t, warmup=tcfg.warmup_steps, total=tcfg.total_steps)
           for t in range(W.STEPS)]
    budget = 2 * sum(lrs) * (U_BOUND + tcfg.opt.weight_decay * pmax)
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got, want)])
    assert float(diff.max()) <= budget, (float(diff.max()), budget)
    assert float((diff <= PARAM_ATOL).float().mean()) >= PARAM_CLOSE
    for a, b in zip(got, gloo[1][name]["params"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["analog_1x2", "analog_2x1"])
def test_first_step_reads_bit_equal(gloo, unsharded, name):
    got, want = gloo[0][name]["reads"], unsharded(*_case(name))["reads"]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_checkpoint_unsharded_loads_onto_mesh(gloo):
    for res in gloo:   # each rank's blocks are the unsharded leaves' slices
        assert res["ckpt_to_mesh"] and all(res["ckpt_to_mesh"])


def test_checkpoint_sharded_loads_unsharded(gloo):
    for res in gloo:
        assert res["ckpt_from_mesh"] and all(res["ckpt_from_mesh"])


def test_sharded_restart_reproduces_losses(gloo):
    for r, res in enumerate(gloo):
        clean, fault = res["loop"]["clean"], res["loop"]["fault"]
        assert clean["restarts"] == 0 and fault["restarts"] == 1
        assert clean["rank"] == fault["rank"] == r
        assert [s for s, _ in clean["losses"]] == list(range(W.STEPS + 1))
        # the restart reloads step 2's checkpoint and runs steps 2.. again
        assert dict(fault["losses"]) == dict(clean["losses"])


def test_global_norm_sums_each_leaf_once(gloo):
    for res in gloo:
        for name, (got, want) in res["norms"].items():
            assert math.isclose(got, want, rel_tol=1e-6), name


def test_one_rank_mesh_matches_reference(tmp_path):
    """The step on a 1 × 1 gloo mesh (one rank, this process) from the
    reference's bridged state, against the reference's steps: losses
    within the port's 1e-5 (``tests/test_torch_train.py``'s tolerance for
    the unsharded port), and bit-equal to the unsharded port's."""
    import jax
    import torch.distributed as dist

    from repro.configs import get_smoke_config as j_smoke
    from repro.data import lm_batch as j_lm_batch
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import init_train_state as j_init_train_state
    from repro.train import make_train_step as j_make_train_step
    from repro_torch.bridge import train_state_from_numpy
    from repro_torch.launch import mesh as LM
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.step import place_state

    jc = dataclasses.replace(j_smoke("stablelm-3b"), dtype="float32", remat_policy="full")
    tc = W.config("stablelm-3b", False)
    jstate = j_init_train_state(jax.random.PRNGKey(0), jc, JTrainConfig())
    jstep = jax.jit(j_make_train_step(jc, JTrainConfig()))
    tcfg = TrainConfig()
    tstep = make_train_step(tc, tcfg)

    def bridged():
        st = jax.tree.map(np.asarray, jstate)
        f32 = lambda t: jax.tree.map(lambda x: np.array(x, np.float32), t)  # noqa: E731
        return train_state_from_numpy(f32(st.params), f32(st.opt.m), f32(st.opt.v), int(st.opt.step),
                                      int(st.step), jax.random.key_data(jstate.rng), tc, tcfg,
                                      device="cpu")

    jl, tl, ml = [], [], []
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = LM.make_host_mesh(model=1, device="cpu")
        plain, placed = bridged(), place_state(bridged(), mesh, tc)
        for i in range(2):
            batch = j_lm_batch(jc, batch=W.B, seq=W.S, step=i)
            jstate, jm = jstep(jstate, batch)
            tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
            plain, pm = tstep(plain, tb)
            placed, mm = tstep(placed, tb)
            jl.append(float(jm["loss"]))
            tl.append(float(pm["loss"]))
            ml.append(float(mm["loss"]))
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(ml, jl, rtol=LOSS_RTOL, atol=0)
    assert ml == tl
