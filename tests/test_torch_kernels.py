"""The port's attention kernels against the JAX reference.

On the CPU the port runs each kernel's plain PyTorch version; these tests
hold it against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode (as ``tests/test_kernels.py`` runs them), on the same numpy
inputs.  Tolerance: 2e-5 absolute / 1e-5 relative, the reference suite's
own kernel-vs-oracle bound (f32 throughout, only summation order and
transcendental rounding differ).  ``tests/test_torch_cuda.py`` holds the
CUDA kernels against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as JREF
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

ATOL, RTOL = 2e-5, 1e-5


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


def _both(fn_j, fn_t, arrays, kw):
    """Run the JAX and torch versions of one function on the same arrays."""
    y_j = fn_j(*[None if a is None else jnp.asarray(a) for a in arrays[:5]], **kw,
               k_scale=None if arrays[5] is None else jnp.asarray(arrays[5]),
               v_scale=None if arrays[6] is None else jnp.asarray(arrays[6]))
    y_t = fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays[:4]],
               arrays[4] if np.ndim(arrays[4]) == 0 else torch.from_numpy(arrays[4]),
               **kw,
               k_scale=None if arrays[5] is None else torch.from_numpy(arrays[5]),
               v_scale=None if arrays[6] is None else torch.from_numpy(arrays[6]))
    return np.asarray(y_j), y_t.numpy()


def _decode_case(seed, b, h, hkv, dh, bs, w, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = b * w + 2
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    # distinct pages per slot (page 0 = trash, never tabled)
    table = (rng.permutation(n_pages - 1)[: b * w] + 1).reshape(b, w).astype(np.int32)
    return q, kp, vp, table, ks, vs


@pytest.mark.parametrize("kind,local_window", [("global", 0), ("local", 5)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_plain_matches_reference(kind, local_window, softcap, int8):
    """GQA heads, positions at a block boundary / mid-block / first token /
    full window, both mask kinds, soft-capping, int8 scale planes: the
    port's plain version agrees with the reference oracle and the
    interpret-mode Pallas kernel."""
    q, kp, vp, table, ks, vs = _decode_case(0, 4, 4, 2, 16, 8, 3, int8)
    pos = np.asarray([15, 12, 0, 23], np.int32)
    kw = dict(kind=kind, local_window=local_window, softcap=softcap)
    arrays = (q, kp, vp, table, pos, ks, vs)
    y_ref, y_t = _both(JREF.paged_attention_ref, TREF.paged_attention_ref, arrays, kw)
    y_pl, _ = _both(
        lambda *a, **k: paged_attention_pallas(*a, **k, interpret=True),
        TREF.paged_attention_ref, arrays, kw,
    )
    np.testing.assert_allclose(y_t, y_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y_t, y_pl, atol=ATOL, rtol=RTOL)


def test_paged_attention_negative_ids_and_blocks_past_pos():
    """Table ids < 0 read the trash page 0, and pages past a slot's
    position never leak into its output (they hold 1e9 here)."""
    q, kp, vp, table, _, _ = _decode_case(1, 2, 4, 4, 16, 8, 4)
    pos = np.asarray([7, 12], np.int32)   # slot 0: block 0 only; slot 1: 0-1
    kp[table[0, 1:]] = 1e9
    vp[table[0, 1:]] = 1e9
    kp[table[1, 2:]] = 1e9
    vp[table[1, 2:]] = 1e9
    table[1, 0] = -1                      # reads page 0 instead
    arrays = (q, kp, vp, table, pos, None, None)
    y_ref, y_t = _both(JREF.paged_attention_ref, TREF.paged_attention_ref, arrays, {})
    np.testing.assert_allclose(y_t, y_ref, atol=ATOL, rtol=RTOL)
    short = table.copy()
    short[1, 0] = 0
    y_short = TREF.paged_attention_ref(
        *[torch.from_numpy(a) for a in (q, kp, vp, short[:, :2], pos)]
    ).numpy()
    np.testing.assert_allclose(y_t, y_short, atol=ATOL, rtol=RTOL)
    assert np.abs(y_t).max() < 10.0


def _prefill_case(seed, s, h, hkv, dh, bs, w, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = w + 4
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    table = (rng.permutation(n_pages - 1)[:w] + 1).astype(np.int32)
    return q, kp, vp, table, ks, vs


@pytest.mark.parametrize("kind,local_window", [("global", 0), ("local", 5)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("s,q0,int8", [(8, 0, False), (5, 16, False), (13, 8, True)])
def test_prefill_attention_plain_matches_reference(kind, local_window, softcap, s, q0, int8):
    """Whole-prompt and mid-prompt suffix chunks, ragged lengths spanning
    several blocks, both mask kinds, soft-capping, GQA and int8 pools."""
    q, kp, vp, table, ks, vs = _prefill_case(2, s, 4, 2, 16, 8, 4, int8)
    kw = dict(kind=kind, local_window=local_window, softcap=softcap)
    arrays = (q, kp, vp, table, np.int32(q0), ks, vs)
    y_ref, y_t = _both(JREF.prefill_attention_ref, TREF.prefill_attention_ref, arrays, kw)
    y_pl, _ = _both(
        lambda *a, **k: paged_prefill_attention_pallas(*a, **k, interpret=True),
        TREF.prefill_attention_ref, arrays, kw,
    )
    np.testing.assert_allclose(y_t, y_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y_t, y_pl, atol=ATOL, rtol=RTOL)


def test_prefill_attention_blocks_past_chunk_and_negative_ids():
    """Pages past the chunk's last query never leak in; ids < 0 read page 0."""
    q, kp, vp, table, _, _ = _prefill_case(3, 6, 4, 4, 16, 8, 4)
    kp[table[2:]] = 1e9                   # queries cover positions 8..13
    vp[table[2:]] = 1e9
    table[0] = -1
    arrays = (q, kp, vp, table, np.int32(8), None, None)
    y_ref, y_t = _both(JREF.prefill_attention_ref, TREF.prefill_attention_ref, arrays, {})
    np.testing.assert_allclose(y_t, y_ref, atol=ATOL, rtol=RTOL)
    assert np.abs(y_t).max() < 10.0


def test_full_width_head_dim_80():
    """stablelm-3b's head shape (MHA, Dh=80, bs=16) through both plain
    versions against the reference."""
    q, kp, vp, table, _, _ = _decode_case(4, 2, 4, 4, 80, 16, 3)
    pos = np.asarray([40, 17], np.int32)
    y_ref, y_t = _both(JREF.paged_attention_ref, TREF.paged_attention_ref,
                       (q, kp, vp, table, pos, None, None), {})
    np.testing.assert_allclose(y_t, y_ref, atol=ATOL, rtol=RTOL)
    q, kp, vp, table, _, _ = _prefill_case(5, 20, 4, 4, 80, 16, 3)
    y_ref, y_t = _both(JREF.prefill_attention_ref, TREF.prefill_attention_ref,
                       (q, kp, vp, table, np.int32(16), None, None), {})
    np.testing.assert_allclose(y_t, y_ref, atol=ATOL, rtol=RTOL)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    """ops sends CPU tensors to the plain versions, bit for bit."""
    q, kp, vp, table, _, _ = _decode_case(6, 2, 4, 2, 16, 8, 2)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table)]
    pos = torch.tensor([9, 4], dtype=torch.int32)
    assert torch.equal(TOPS.paged_attention(*t, pos), TREF.paged_attention_ref(*t, pos))
    assert torch.equal(
        TOPS.paged_prefill_attention(t[0], t[1], t[2], t[3][0], 3),
        TREF.prefill_attention_ref(t[0], t[1], t[2], t[3][0], 3),
    )
