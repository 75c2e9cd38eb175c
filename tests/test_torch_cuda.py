"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor ``repro``, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the attention kernels within 2e-5 absolute / 1e-5 relative
of their plain versions on f32 inputs (only summation order differs);
``stoch_round`` and the int8 quantizer bit-identical to their plain
versions (integer hashing, exact f32 steps, no FMA contraction);
``wta_counts`` with equal row sums and at most 1% of its B·T decisions
flipped, because its Gaussians pass through log and cos; ``crossbar_mac``
with at least 99.95% of its comparator decisions equal and its linear
readout within 2e-5 / 1e-5 (its quantized weights and noise are
bit-identical, its f32 sums run in another order); a smoke-size analog
``lm_loss`` on the card within 1e-3 of the CPU's (a flipped comparator
decision moves one token's loss), its gradients finite.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

ATOL, RTOL = 2e-5, 1e-5
WTA_FLIP_FRACTION = 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pool(rng, n_pages, bs, hkv, dh, int8):
    if int8:
        kp = rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((n_pages, bs, hkv))) + 0.1).astype(np.float32)
        vs = (np.abs(rng.standard_normal((n_pages, bs, hkv))) + 0.1).astype(np.float32)
        return kp, vp, ks, vs
    kp = rng.standard_normal((n_pages, bs, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, bs, hkv, dh)).astype(np.float32)
    return kp, vp, None, None


def _decode_case(seed, b, h, hkv, dh, bs, w, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = b * w + 2
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    table = (rng.permutation(n_pages - 1)[: b * w] + 1).reshape(b, w).astype(np.int32)
    return q, kp, vp, table, ks, vs


def _prefill_case(seed, s, h, hkv, dh, bs, w, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = w + 4
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    table = (rng.permutation(n_pages - 1)[:w] + 1).astype(np.int32)
    return q, kp, vp, table, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind,local_window,softcap,hkv", [
    ("global", 0, 0.0, 4), ("local", 5, 30.0, 2),
])
def test_cuda_kernels_match_plain_versions(cuda_device, int8, kind, local_window, softcap, hkv):
    """Both attention kernels vs their plain versions on the card, f32
    inputs: only summation order differs, so the CPU bound holds."""
    kw = dict(kind=kind, local_window=local_window, softcap=softcap)
    q, kp, vp, table, ks, vs = _decode_case(7, 3, 4, hkv, 80, 16, 4, int8)
    table[2, 3] = -1
    pos = torch.tensor([63, 20, 40], dtype=torch.int32, device=cuda_device)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp, table)]
    sc = {} if not int8 else dict(
        k_scale=torch.from_numpy(ks).to(cuda_device),
        v_scale=torch.from_numpy(vs).to(cuda_device),
    )
    y_k = TOPS.paged_attention(*dev, pos, **kw, **sc)
    y_p = TREF.paged_attention_ref(*dev, pos, **kw, **sc)
    torch.testing.assert_close(y_k, y_p, atol=ATOL, rtol=RTOL)
    q, kp, vp, table, ks, vs = _prefill_case(8, 37, 4, hkv, 80, 16, 5, int8)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp, table)]
    sc = {} if not int8 else dict(
        k_scale=torch.from_numpy(ks).to(cuda_device),
        v_scale=torch.from_numpy(vs).to(cuda_device),
    )
    y_k = TOPS.paged_prefill_attention(*dev, 21, **kw, **sc)
    y_p = TREF.prefill_attention_ref(*dev, 21, **kw, **sc)
    torch.testing.assert_close(y_k, y_p, atol=ATOL, rtol=RTOL)


def _sr_input(shape, lo, hi):
    x = (np.random.default_rng(6).standard_normal(shape) * 0.8 * hi).astype(np.float32)
    x.flat[:6] = [lo - 1.0, lo, hi, hi + 1.0, 0.0, lo + (hi - lo) / 2]
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,step,lo,hi", [
    ((33, 70), 2.0 / 31, -1.0, 1.0),
    ((16, 520), 2.0 / 31, -1.0, 1.0),
    ((256, 80), 1.0, -127.0, 127.0),
    ((5, 1030), 0.1, -1.0, 1.0),
])
def test_cuda_stoch_round_bit_equal_to_plain(cuda_device, shape, step, lo, hi):
    from repro_torch.kernels import stoch_round as SR

    x = _sr_input(shape, lo, hi).to(cuda_device)
    kw = dict(step=step, lo=lo, hi=hi)
    seeds = torch.tensor([2**32 - 1], device=cuda_device)
    assert torch.equal(SR.stoch_round_cuda(x, seeds, **kw), TREF.stoch_round_ref(x, seeds, **kw))
    groups = torch.tensor([3, 2**31, 9], device=cuda_device)
    x3 = torch.cat([x, x, x])
    got = SR.stoch_round_cuda(x3, groups, **kw)
    assert torch.equal(got, TREF.stoch_round_ref(x3, groups, **kw))
    # the card's answer is the CPU's answer
    assert torch.equal(got.cpu(), TREF.stoch_round_ref(x3.cpu(), groups.cpu(), **kw))


@pytest.mark.cuda
def test_cuda_quantize_kv_pair_equals_cpu(cuda_device):
    """The int8 write path on the card (kernel) equals the CPU plain path on
    the same input, codes and scales, for the decode and prefill forms."""
    from repro_torch.kernels import stoch_round as SR

    rng = np.random.default_rng(7)
    for shape, seeds in (((8, 1, 32, 80), [2**32 - 1]), ((8, 16, 32, 80), list(range(8)))):
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3)
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        sd = torch.tensor(seeds)
        before = SR.launches
        got = TOPS.quantize_kv_pair_int8(k.to(cuda_device), v.to(cuda_device), sd.to(cuda_device))
        assert SR.launches == before + 2
        for g, w in zip(got, TOPS.quantize_kv_pair_int8(k, v, sd)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n_trials", [(5, 300, 16), (3, 8200, 3), (8, 50304, 4)])
def test_cuda_wta_counts_agree_with_plain(cuda_device, b, c, n_trials):
    from repro_torch.kernels import wta_counts as WTA

    z = torch.from_numpy(
        np.random.default_rng(c).standard_normal((b, c)).astype(np.float32) * 2
    ).to(cuda_device)
    seed = torch.tensor([2**32 - 1], device=cuda_device)
    kw = dict(n_trials=n_trials, vth0=2.897, sigma_z=1.702)
    got = WTA.wta_counts_cuda(z, seed, **kw).cpu()
    want = TREF.wta_counts_ref(z.cpu(), seed.cpu(), **kw)
    assert torch.equal(got.sum(-1), want.sum(-1))
    assert float((got - want).abs().sum()) <= 2 * WTA_FLIP_FRACTION * b * n_trials
    assert torch.equal(TOPS.wta_counts(z, seed, **kw).cpu(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("binarize", [True, False])
@pytest.mark.parametrize("physical", [False, True])
def test_cuda_crossbar_mac_matches_plain(cuda_device, binarize, physical):
    """The crossbar kernel at an odd shape (ragged K, N past the 128 pad)."""
    from repro_torch.kernels import crossbar_mac as CB

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((37, 203)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.uniform(-1.1, 1.1, (203, 131)).astype(np.float32)).to(cuda_device)
    sigma = torch.full((), 1.7 if binarize else 0.01, device=cuda_device)
    kw = dict(binarize=binarize, physical_noise=physical,
              noise_params=(1.6568e-11, 4.95e-05, 5.05e-05, 0.0109, 203.0))
    before = CB.launches
    got = CB.crossbar_mac_cuda(x, w, 2**32 - 7, sigma, **kw)
    assert CB.launches == before + 1
    want = TREF.crossbar_mac_ref(x, w, 2**32 - 7, sigma, **kw)
    if binarize:
        assert float((got == want).float().mean()) >= 0.9995
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_analog_lm_loss_with_backward(cuda_device):
    """Smoke stablelm-3b in analog-stochastic mode: loss and gradients on
    the card through the crossbar kernel, against the CPU's plain path."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.data import lm_batch
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.models import transformer as TF
    from repro_torch.optim import tree_leaves

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", analog=AnalogConfig(
        mode="analog_stochastic", device=calibrate_v_read(DeviceParams(), 64)))
    batch = lm_batch(cfg, batch=4, seq=32, step=0, device="cpu")
    out = {}
    for d in ("cpu", cuda_device):
        params = _tree_to(TF.init_lm(cfg, seed=2, device="cpu"), d)
        leaves = tree_leaves(params)
        before = CB.launches
        loss, _ = TF.lm_loss(params, {k: v.to(d) for k, v in batch.items()}, cfg, (0, 5))
        grads = torch.autograd.grad(loss, leaves)
        out[str(d)] = (float(loss.detach()), CB.launches - before)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert out["cpu"][1] == 0 and out[str(cuda_device)][1] == 7 * cfg.n_layers
    assert abs(out["cpu"][0] - out[str(cuda_device)][0]) <= 1e-3


def _tree_to(tree, d):
    return {k: _tree_to(v, d) if isinstance(v, dict) else v.to(d).requires_grad_(True)
            for k, v in tree.items()}
