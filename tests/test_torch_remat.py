"""``remat_policy`` in the port (``models/layers.remat``): each decoder unit
runs under ``torch.utils.checkpoint`` as the reference's scan body runs
under ``jax.checkpoint``; the encoder-decoder checkpoints every layer
whatever the policy says, as the reference does.

- Under ``"full"``, ``"dots"`` and ``"nothing"`` the loss and every
  gradient are bit-equal on the CPU, digital and in the two analog
  modes, at stablelm-3b's and whisper-small's smoke configs (f32): the
  recompute draws the same threefry noise.
- Against the reference within 1e-5 (f32 products summed in another
  order): digital under the reference's default ``"nothing"``; analog
  under its ``"full"``, the one policy its interpret-mode Pallas kernel
  runs under on the CPU.  The three port policies being bit-equal, each
  is so held.  whisper-small ignores the policy (every layer is
  checkpointed); its loss and gradients are held against the
  reference's in the three modes in ``tests/test_torch_encdec.py``
  (the reference's checkpoint patched to the identity in the analog
  ones, ROADMAP C), which runs the port's checkpointed layers.
- What the backward holds: the bytes live once the forward has returned
  (``dryrun.LiveBytes``; a non-reentrant checkpoint keeps its saved
  products in its own cache, which ``saved_tensors_hooks`` do not see).
  Digital: ``"nothing"`` < ``"dots"`` < ``"full"``.  Analog: every
  projection is a crossbar read, a custom Function and no product, as
  XLA sees the reference's Pallas calls, so ``"dots"`` holds what
  ``"nothing"`` holds, and less than ``"full"``.
- The crossbar reads of a step: once under ``"full"``, twice under the
  others (the backward's recompute), every one of whisper's twice.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.data import lm_batch as j_lm_batch
from repro.models import get_model_fns as j_fns
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.kernels import ops as KOPS
from repro_torch.launch.dryrun import LiveBytes
from repro_torch.models import get_model_fns as t_fns
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.optim import tree_leaves

ATOL = 1e-5
POLICIES = ("full", "dots", "nothing")
MODES = ("digital", "analog_linear", "analog_stochastic")
ARCHS = ("stablelm-3b", "whisper-small")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, mode: str, policy: str):
    jc = dataclasses.replace(j_smoke(arch), dtype="float32", remat_policy=policy)
    tc = dataclasses.replace(t_smoke(arch), dtype="float32", remat_policy=policy)
    if mode != "digital":
        jc = dataclasses.replace(jc, analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    return jc, tc


@pytest.fixture(scope="module")
def inputs():
    """Each arch's reference init (key 0) and a batch, shared by every
    case."""
    out = {}
    for arch in ARCHS:
        jc, _ = _cfgs(arch, "digital", "full")
        jp = jax.jit(j_fns(jc).init, static_argnums=1)(jax.random.PRNGKey(0), jc)
        batch = {k: np.asarray(v) for k, v in j_lm_batch(jc, batch=2, seq=12, step=0).items()}
        out[arch] = (jax.tree.map(np.asarray, jp), batch)
    return out


def _reference(arch, mode, policy, inputs):
    """The reference's loss and gradient leaves under ``policy``."""
    jc, _ = _cfgs(arch, mode, policy)
    jp, batch = inputs[arch]
    key = None if mode == "digital" else jax.random.PRNGKey(2)
    (loss, _), grads = jax.value_and_grad(
        lambda p: j_fns(jc).loss(p, batch, jc, key), has_aux=True)(jp)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port(arch, mode, policy, inputs, reads=None):
    """The port's loss, gradient leaves and the bytes live between the
    forward and the backward."""
    _, tc = _cfgs(arch, mode, policy)
    jp, batch = inputs[arch]
    tp = params_from_numpy(jp, tc, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    key = None if mode == "digital" else tuple(
        int(v) for v in np.asarray(jax.random.key_data(jax.random.PRNGKey(2))))
    live = LiveBytes(held=(leaves, tbatch))
    with live:
        loss, _ = t_fns(tc).loss(tp, tbatch, tc, key)
    held = live.live
    if reads is not None:
        reads["forward"] = len(reads["calls"])
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, held


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policies_bit_equal_and_match_reference(arch, mode, inputs):
    runs = {p: _port(arch, mode, p, inputs) for p in POLICIES}
    loss, grads, _ = runs["full"]
    for p in ("dots", "nothing"):
        assert torch.equal(runs[p][0], loss), p
        for a, b in zip(runs[p][1], grads, strict=True):
            assert torch.equal(a, b), p
    if arch == "whisper-small":
        return
    jl, jg = _reference(arch, mode, "nothing" if mode == "digital" else "full", inputs)
    assert abs(float(loss) - jl) <= ATOL
    for a, b in zip(jg, grads, strict=True):
        np.testing.assert_allclose(b.numpy(), a, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_held_bytes_follow_the_policy(mode, inputs, monkeypatch):
    held = {p: _port("stablelm-3b", mode, p, inputs)[2] for p in POLICIES}
    if mode == "digital":
        assert held["nothing"] < held["dots"] < held["full"], held
    else:
        assert held["nothing"] == held["dots"] < held["full"], held
    # the encoder-decoder checkpoints every layer whatever the policy says:
    # it holds less than its forward with no checkpoint
    whisper = {p: _port("whisper-small", mode, p, inputs)[2] for p in POLICIES}
    assert len(set(whisper.values())) == 1, whisper
    monkeypatch.setattr(ED, "remat", lambda policy, fn, *args: fn(*args))
    assert whisper["full"] < _port("whisper-small", mode, "full", inputs)[2]


@pytest.mark.parametrize("arch", ARCHS)
def test_recompute_reads_the_crossbar_again(arch, inputs, monkeypatch):
    real = KOPS.crossbar_mac_sim
    counts = {}
    for policy in POLICIES:
        reads = {"calls": []}

        def counted(*a, reads=reads, **kw):
            reads["calls"].append(1)
            return real(*a, **kw)

        monkeypatch.setattr(KOPS, "crossbar_mac_sim", counted)
        _port(arch, "analog_stochastic", policy, inputs, reads)
        counts[policy] = (reads["forward"], len(reads["calls"]))
    fwd = counts["full"][0]
    assert fwd > 0
    twice = {"full": 1 if arch == "stablelm-3b" else 2, "dots": 2, "nothing": 2}
    assert counts == {p: (fwd, fwd * twice[p]) for p in POLICIES}, counts


def test_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        with torch.enable_grad():
            L.remat("some", lambda x: x, torch.ones(1, requires_grad=True))
