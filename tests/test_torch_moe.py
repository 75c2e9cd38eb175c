"""The port's MoE block (``repro_torch/models/moe.py``) and the
``moe_lm`` family's analog training against ``repro`` on the CPU, on the
reference's parameters carried across by ``bridge``, inputs drawn with
numpy.

Tolerances, and why:

- the dispatch (slot of every assignment, the ``(B, E, C)`` token index
  and gate buffers, the dump column and the pad row, ``frac``) is
  integer bookkeeping and copies: equal, bit for bit;
- the combine: each token's kept outputs summed in ascending expert id in
  the output dtype, the order of the reference's scatter-add, so equal bit
  for bit at f32 with k = 4 of E = 8 (where the order shows) and, in bf16,
  within ``BF16_ULPS`` bf16 ulps of the output's largest magnitude (every
  add rounds; measured: equal);
- ``moe_apply``'s output within ``MOE_ATOL``: the router's f32 products
  and the experts' matrix products sum in another order than XLA's;
  ``aux`` within ``AUX_ATOL`` (a sum of E products of f32 means);
  gradients within ``GRAD_ATOL``;
- the WTA router: threefry, the uniform and ``erf_inv`` are bit-equal
  across the packages but ``log1p`` is not (ROADMAP C), so a vote count
  may differ by one; expert sets agree on at least ``ROUTER_AGREEMENT``
  of the tokens, and their vote shares agree within ``SHARE_ATOL`` where
  they do (a share carries the ``1e-6·softmax(z)`` tie-break, whose
  softmax differs by an ulp between the packages);
- model losses within ``LOSS_ATOL`` and gradients within ``GRAD_ATOL``
  in both analog modes (digital: ``tests/test_torch_archs.py``).  In
  ``analog_stochastic`` the comparison
  holds only where every routing decision agrees, so the test first
  holds each of the port's router draws against the reference's router on
  the same logits and key (all agree at this seed), then the loss and the
  gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import analog as JA
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.models import moe as JMOE
from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import analog as TA
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.kernels import ops as KOPS
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TTF
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig, init_train_state, make_train_step

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]
BF16_ULPS = 1
MOE_ATOL = 2e-6
AUX_ATOL = 1e-7
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
ROUTER_AGREEMENT = 0.999
SHARE_ATOL = 1e-12
B, S = 3, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str = "granite-moe-3b-a800m", mode: str = "digital", **kw):
    kw.setdefault("dtype", "float32")
    jc = dataclasses.replace(jax_smoke(arch), **kw)
    tc = dataclasses.replace(get_smoke_config(arch), **kw)
    if mode != "digital":
        # the reference's analog modes as its TPU runs them; interpret-mode
        # Pallas cannot be rematerialised (ROADMAP C)
        jc = dataclasses.replace(jc, remat_policy="full", analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    return jc, tc


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _key_pair(key) -> tuple[int, int]:
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _block(jc, tc, seed: int = 3):
    """One MoE block's parameters from ``repro``'s init, in both packages,
    and an input x (B, S, d) drawn with numpy."""
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    x = np.random.default_rng(seed).standard_normal((B, S, jc.d_model)).astype(np.float32)
    return jp, tp, x


def _routes(seed: int, e: int, k: int):
    """Seeded router logits (B, S, E) and the reference's top-k of their
    softmax, normalized: (logits, gates, expert_ids) as numpy."""
    logits = np.random.default_rng(seed).standard_normal((B, S, e)).astype(np.float32)
    g, ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    return logits, np.asarray(g / g.sum(-1, keepdims=True)), np.asarray(ids)


def _ref_dispatch(x, logits, gates, ids, cap, jc):
    return jax.vmap(lambda xf, lg, gt, ei: JMOE._dispatch_group(xf, lg, gt, ei, cap, jc))(
        jnp.asarray(x), jnp.asarray(logits), jnp.asarray(gates), jnp.asarray(ids))


# ---------------------------------------------------------------------------
# The block.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_and_dtypes(arch, mlp):
    """The port's own init has the reference's leaves, shapes and dtypes
    in a bf16 model: ``router`` (d, E) f32, the experts (E, d, f) /
    (E, f, d) bf16, ``w_gate`` only for the gated MLPs."""
    jc = dataclasses.replace(jax_smoke(arch), mlp=mlp)
    tc = dataclasses.replace(get_smoke_config(arch), mlp=mlp)
    want = jax.eval_shape(lambda: JMOE.init_moe(jax.random.PRNGKey(0), jc))
    got = TMOE.init_moe(torch.Generator().manual_seed(0), tc)
    assert sorted(got) == sorted(want)
    assert ("w_gate" in got) == (mlp != "gelu")
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    lead = TMOE.init_moe(torch.Generator().manual_seed(0), tc, lead=(2,))
    assert tuple(lead["w_up"].shape) == (2, tc.n_experts, tc.d_model, tc.d_ff)
    # drawn in the model's dtype, then widened, as the reference's router
    assert torch.equal(got["router"], got["router"].to(torch.bfloat16).float())


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    """``max(int(S·k·cf/E), k)`` at the smoke configs, the full ones (the
    published factor 1.25) and the drop-free copies, at the decode,
    prefill-chunk and bucket lengths."""
    for jc, tc in ((jax_smoke(arch), get_smoke_config(arch)),
                   (jax_config(arch), get_config(arch))):
        for n in (1, 3, 8, 16, 23, 128, 2048):
            assert TMOE._capacity(n, tc) == JMOE._capacity(n, jc), n
    full = get_config(arch)
    if arch == "granite-moe-3b-a800m":
        assert [TMOE._capacity(n, full) for n in (1, 128, 2048)] == [8, 32, 512]
        free = dataclasses.replace(full, capacity_factor=5.0)   # E / k
        assert [TMOE._capacity(n, free) for n in (1, 128)] == [8, 128]
    else:
        assert [TMOE._capacity(n, full) for n in (1, 128, 2048)] == [2, 40, 640]
        free = dataclasses.replace(full, capacity_factor=4.0)
        assert TMOE._capacity(128, free) == 128


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_matches_reference(dtype, cf):
    """Slot assignment of every group at once: ``idx``, ``gate_slot``,
    ``frac`` and the gathered tokens equal the reference's per-group
    dispatch, in a case with overflow (cf 1.0 at k = 4 of E = 8: the dump
    column and the pad row are exercised) and one without."""
    jc, tc = _cfgs(dtype=dtype, moe_topk=4, n_experts=8, capacity_factor=cf)
    logits, gates, ids = _routes(5, 8, 4)
    x = np.random.default_rng(6).standard_normal((B, S, 8)).astype(np.float32)
    cap = JMOE._capacity(S, jc)
    xg, idx, gs, frac = _ref_dispatch(jnp.asarray(x).astype(dtype), logits, gates, ids, cap, jc)
    got = TMOE._dispatch_group(_t(x).to(getattr(torch, dtype)), _t(gates),
                               torch.from_numpy(ids.astype(np.int64)), cap, tc)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got.gate_slot.numpy(), np.asarray(gs))
    np.testing.assert_array_equal(got.frac.numpy(), np.asarray(frac))
    np.testing.assert_array_equal(got.xg.transpose(0, 1).float().numpy(),
                                  np.asarray(xg).astype(np.float32))
    dropped = int((~got.kept).sum())
    if cf == 1.0:
        assert dropped > 0 and (np.asarray(idx) == S).any()   # dump column and pad row
    else:
        assert dropped == 0
    # every kept assignment's slot holds its token and gate
    tok = np.arange(S * 4) // 4
    for b in range(B):
        for a in np.flatnonzero(got.kept[b].numpy()):
            e, c = ids[b].reshape(-1)[a], int(got.pos[b, a])
            assert int(got.idx[b, e, c]) == tok[a]
            assert float(got.gate_slot[b, e, c]) == gates[b].reshape(-1)[a]


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_matches_reference_in_its_order(dtype, cf):
    """The combine on the same expert outputs and slots: bit for bit at
    f32 (k = 4 of E = 8, where the order of the sum shows: the same sum
    in rank order parts from the reference), and within ``BF16_ULPS`` in
    bf16."""
    jc, tc = _cfgs(dtype=dtype, moe_topk=4, n_experts=8, capacity_factor=cf)
    logits, gates, ids = _routes(5, 8, 4)
    x = np.random.default_rng(6).standard_normal((B, S, 8)).astype(np.float32)
    cap = JMOE._capacity(S, jc)
    _, idx, gs, _ = _ref_dispatch(x, logits, gates, ids, cap, jc)
    out = jnp.asarray(np.random.default_rng(7).standard_normal((B, 8, cap, 8)),
                      jnp.float32).astype(dtype)
    want = np.asarray(jax.jit(jax.vmap(lambda o, i, g: JMOE._combine_group(o, i, g, S)))(
        out, idx, gs)).astype(np.float32)
    tids = torch.from_numpy(ids.astype(np.int64))
    disp = TMOE._dispatch_group(_t(x), _t(gates), tids, cap, tc)
    t_out = _t(np.asarray(out).astype(np.float32)).to(getattr(torch, dtype)).transpose(0, 1)
    got = TMOE._combine_group(t_out.contiguous(), disp.gate_slot, tids, disp.pos,
                              disp.kept).float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        # the order matters: each token's outputs summed in rank order
        w = t_out * disp.gate_slot.transpose(0, 1)[..., None]
        rank = torch.zeros((B, S, 8))
        for b in range(B):
            for a in range(S * 4):
                if disp.kept[b, a]:
                    e = int(tids[b].reshape(-1)[a])
                    rank[b, a // 4] += w[e, b, int(disp.pos[b, a])]
        assert not np.array_equal(rank.numpy(), want)
    else:
        ulp = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got - want).max() <= BF16_ULPS * ulp


@pytest.mark.parametrize("cf", [1.0, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    """Output and ``aux`` of the block, without drops (the smoke factor)
    and with them (cf 1.0), against the jitted reference."""
    kw = {} if cf is None else {"capacity_factor": cf}
    jc, tc = _cfgs(arch, **kw)
    jp, tp, x = _block(jc, tc)
    y, aux = jax.jit(lambda p, x: JMOE.moe_apply(p, x, jc))(jp, jnp.asarray(x))
    ty, taux = TMOE.moe_apply(tp, _t(x), tc)
    _close(ty.numpy(), y, MOE_ATOL)
    assert abs(float(taux) - float(aux)) <= AUX_ATOL
    ty2, none = TMOE.moe_apply(tp, _t(x), tc, with_aux=False)
    assert none is None and torch.equal(ty, ty2)
    cap = TMOE._capacity(S, tc)
    _, gates, ids = TMOE.route(tp, _t(x), tc)
    kept = TMOE._dispatch_group(_t(x), gates, ids, cap, tc).kept
    assert bool(kept.all()) == (cf is None)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_equals_dense_topk(arch):
    """``tests/test_models.py::test_moe_no_drop_equals_dense_topk`` for
    the port: with ample capacity the grouped dispatch is the explicit
    per-token top-k mixture of every expert's dense output."""
    _, cfg = _cfgs(arch, capacity_factor=8.0)
    p = TMOE.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    y, _ = TMOE.moe_apply(p, x, cfg)
    gates, ids = torch.topk(torch.softmax(x @ p["router"], -1), cfg.moe_topk)
    gates = gates / gates.sum(-1, keepdim=True)
    act = torch.nn.functional.silu if cfg.mlp == "swiglu" else (
        lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    dense = torch.stack([(act(x @ p["w_gate"][e]) * (x @ p["w_up"][e])) @ p["w_down"][e]
                         for e in range(cfg.n_experts)], dim=2)   # (B, S, E, D)
    want = sum(gates[..., j:j + 1] * dense.gather(
        2, ids[..., j, None, None].expand(-1, -1, 1, cfg.d_model))[:, :, 0]
        for j in range(cfg.moe_topk))
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("cf", [1.0, None])
def test_moe_gradients_match_reference(cf):
    """``jax.grad`` of a weighted sum of the output plus ``aux``, with
    respect to every leaf and to x, with and without drops."""
    kw = {} if cf is None else {"capacity_factor": cf}
    jc, tc = _cfgs(**kw)
    jp, tp, x = _block(jc, tc)
    r = np.random.default_rng(9).standard_normal((B, S, jc.d_model)).astype(np.float32)

    def jloss(p, xx):
        y, aux = JMOE.moe_apply(p, xx, jc)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = tree_leaves(tp)
    tx = _t(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, aux = TMOE.moe_apply(tp, tx, tc)
    tg = torch.autograd.grad((y * _t(r)).sum() + aux, leaves + [tx])
    for a, b in zip(jax.tree.leaves(jg) + [jgx], tg):
        _close(b.numpy(), a, GRAD_ATOL)


def test_wta_router_sets_agree_with_reference():
    """The ``analog_stochastic`` router (granite's k = 8 of E = 40, its
    T = 32 trials) on 2048 seeded token logits under one key: the expert
    sets agree on at least ``ROUTER_AGREEMENT`` of the tokens and the vote
    shares within ``SHARE_ATOL`` where they do; the digital route of the same call
    is the stable top-k."""
    jc, tc = _cfgs(mode="analog_stochastic")
    logits = 2.0 * np.random.default_rng(11).standard_normal((2048, 40)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jv, ji = JA.wta_router_topk(jc.analog, key, jnp.asarray(logits), 8)
    tv, ti = TA.wta_router_topk(tc.analog, _key_pair(key), _t(logits), 8)
    same = np.array([set(a) == set(b) for a, b in zip(ti.numpy(), np.asarray(ji))])
    assert same.mean() >= ROUTER_AGREEMENT, same.mean()
    _close(tv.numpy()[same], np.asarray(jv)[same], SHARE_ATOL)
    jv, ji = JA.wta_router_topk(jc.analog, None, jnp.asarray(logits), 8)
    tv, ti = TA.wta_router_topk(tc.analog, None, _t(logits), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# The model in the analog modes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["analog_linear", "analog_stochastic"])
def test_analog_loss_and_gradients_match_reference(mode, monkeypatch):
    """granite's smoke model: the loss, ``aux`` and every gradient equal the
    reference's (``use_pallas="on"``) within ``LOSS_ATOL`` / ``GRAD_ATOL``,
    with q, k, v and o of every layer on the crossbar.  The experts stay
    digital in both packages; ``analog_stochastic`` routes by the WTA race,
    whose every decision here is first held against the reference's
    router on the same logits and key."""
    jc, tc = _cfgs(mode=mode)
    jp = jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key = jax.random.PRNGKey(2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc, key),
        has_aux=True))(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    draws = []
    real = TA.wta_router_topk

    def recorded(acfg, k, logits, n):
        out = real(acfg, k, logits, n)
        draws.append((k, logits.detach().clone(), out[1]))
        return out

    monkeypatch.setattr(TA, "wta_router_topk", recorded)
    tl, tm = TTF.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
                         _key_pair(key))
    if mode == "analog_stochastic":
        assert len(draws) == tc.n_units
        for k, logits, ids in draws:
            _, want = JA.wta_router_topk(jc.analog, jnp.asarray(k, jnp.uint32),
                                         jnp.asarray(logits.numpy()), tc.moe_topk)
            np.testing.assert_array_equal(np.sort(ids.numpy(), -1), np.sort(np.asarray(want), -1))
    else:
        assert all(k is None for k, _, _ in draws)
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    assert abs(float(tm["aux"].detach()) - float(jm["aux"])) <= AUX_ATOL
    tg = torch.autograd.grad(tl, leaves)
    for a, b in zip(jax.tree.leaves(jg), tg):
        _close(b.numpy(), a, GRAD_ATOL)


def test_analog_stochastic_step_reads_attention_and_races_the_router(monkeypatch):
    """One ``analog_stochastic`` step of granite's smoke model through
    ``train/step.py``: finite loss and ``aux``; the crossbar reads q, k, v
    and o of every layer (the experts are digital einsums, as in the
    reference); one WTA race a layer routes its tokens; no
    ``sigmoid_sample``; the backward reads and races again, since it
    recomputes every unit (``remat_policy`` "nothing", the default)."""
    _, tc = _cfgs(mode="analog_stochastic")
    calls, sig, races = [], [], []
    real = KOPS.crossbar_mac
    real_wta = KOPS.wta_trial_counts

    def counted(x, w, key, cfg, binarize=False, **kw):
        calls.append((tuple(w.shape), binarize))
        return real(x, w, key, cfg, binarize=binarize, **kw)

    def raced(z, *a, **kw):
        races.append(tuple(z.shape))
        return real_wta(z, *a, **kw)

    monkeypatch.setattr(KOPS, "crossbar_mac", counted)
    monkeypatch.setattr(KOPS, "wta_trial_counts", raced)
    monkeypatch.setattr(KOPS, "sigmoid_sample", lambda *a, **kw: sig.append(1))
    tcfg = TrainConfig(warmup_steps=1, total_steps=4)
    state = init_train_state(0, tc, tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab, (2, 17))
                            .astype(np.int32))
    state, m = make_train_step(tc, tcfg)(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["aux"])) and float(m["aux"]) > 0
    d, hq, hkv = tc.d_model, tc.n_heads * tc.head_dim, tc.n_kv_heads * tc.head_dim
    assert tc.remat_policy == "nothing"
    assert calls == [((d, hq), False), ((d, hkv), False), ((d, hkv), False),
                     ((hq, d), False)] * tc.n_layers * 2
    assert races == [(2 * 16, tc.n_experts)] * tc.n_layers * 2
    assert not sig
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
