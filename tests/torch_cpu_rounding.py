"""Where the PyTorch port's CPU results can differ from the JAX package's by
rounding alone: a CPU measurement, no device involved.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_cpu_rounding.py

Prints one line per measurement:

1. f32 ``sqrt``, ``rsqrt``, ``exp`` and ``log1p`` over 2**20 random values
   (uniform in [1e-3, 1e3), and in (-1, 1) for log1p): the share on which
   torch's result differs from numpy's correctly rounded ``sqrt`` or from
   jax's own function;
2. ``repro_torch.random.normal`` against ``jax.random.normal`` on a
   (32, 50304) draw: the bit-equal share and the worst ulp distance, with
   torch's ``log1p`` (the port's) and with jax's fed in (``erf_inv``
   alone);
3. the K rows of ``tests/test_torch_int8.py``'s first prefill chunk
   before quantization, unit by unit, port against reference: the
   bit-equal share, the worst |Δk| over the row's max |k| (the scale), and
   the worst relative difference of a row's max |k|; then the int8 pool's
   first-chunk K scales after the two-chunk prefill, worst relative
   difference.  Both as the port stands and with its ``rmsnorm``'s
   ``rsqrt`` replaced by ``1 / sqrt`` (the same model under other
   rounding).  The test's ``MODEL_SCALE_RTOL`` is set from these.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JTF
from repro_torch import random as R
from repro_torch.bridge import paged_cache_from_numpy, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TTF


def transcendentals(n: int = 1 << 20) -> None:
    rng = np.random.default_rng(0)
    x = rng.uniform(1e-3, 1e3, n).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ref_sqrt = np.sqrt(x)
    rows = {
        "sqrt torch vs numpy": torch.sqrt(xt).numpy() != ref_sqrt,
        "sqrt jax vs numpy": np.asarray(jnp.sqrt(xj)) != ref_sqrt,
        "rsqrt torch vs jax": torch.rsqrt(xt).numpy() != np.asarray(jax.lax.rsqrt(xj)),
        "exp torch vs jax": (torch.exp(xt / 100).numpy()
                             != np.asarray(jnp.exp(jnp.asarray((xt / 100).numpy())))),
    }
    y = rng.uniform(-1, 1, n).astype(np.float32)
    rows["log1p torch vs jax"] = (torch.log1p(torch.from_numpy(y)).numpy()
                                  != np.asarray(jnp.log1p(jnp.asarray(y))))
    for name, diff in rows.items():
        print(f"{name}: {diff.mean():.4f} of {n} f32 values differ")


def normals() -> None:
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    pair = tuple(int(w) for w in np.asarray(jax.random.key_data(key), np.uint32))
    shape = (32, 50304)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    for label, log1p in (("torch log1p", torch.log1p),
                         ("jax log1p", lambda t: torch.from_numpy(
                             np.array(jnp.log1p(jnp.asarray(t.numpy())))))):
        saved, torch.log1p = torch.log1p, log1p
        try:
            got = R.normal(pair, shape).numpy()
        finally:
            torch.log1p = saved
        ulp = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))
        print(f"normal {shape} with {label}: {(got == want).mean():.4f} bit-equal, "
              f"worst {ulp.max():.0f} ulp")


def _first_chunk_scales(tcfg, tp, jcfg, jp) -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_torch_int8.py``'s two-chunk prefill in both packages;
    the K scale planes after it."""
    bs, n_pages = 8, 12
    toks = np.random.default_rng(3).integers(0, 256, (1, 28)).astype(np.int32)
    row = np.asarray([3, 7, 1, 9], np.int32)
    seeds = np.asarray([2**32 - 3, 5, 2**31 + 1, 99], np.uint32)
    jc = dict(JTF.init_paged_decode_cache(jcfg, 2, n_pages, bs),
              quant_step=jnp.asarray(2**31 - 2, jnp.int32))
    tc = paged_cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    jpool = {k: jc[k] for k in JTF.PAGE_POOL_LEAVES}
    jst, tst = JTF.init_prefill_state(jcfg), TTF.init_prefill_state(tcfg, "cpu")
    for lo, hi in [(0, 16), (16, 28)]:
        sd = seeds[lo // bs : -(-hi // bs)]
        jpool, jst, _ = JTF.lm_prefill_chunk(
            jp, jnp.asarray(toks[:, lo:hi]), jcfg, jpool, jst, jnp.asarray(row),
            jnp.asarray(lo, jnp.int32), 32, jnp.asarray(sd))
        _, tst, _ = TTF.lm_prefill_chunk(
            tp, torch.from_numpy(toks[:, lo:hi]), tcfg, tc, tst, torch.from_numpy(row), lo,
            torch.from_numpy(sd.astype(np.int64)))
    # the first chunk's two blocks sit on pages 3 and 7 of every unit
    pages = row[:2]
    return (tc["k_scale_pages"].numpy()[:, :, pages],
            np.asarray(jpool["k_scale_pages"])[:, :, pages])


def _first_chunk_k_rows(tcfg, tp, jcfg, jp) -> tuple[np.ndarray, np.ndarray]:
    """The first chunk's K rows as each unit hands them to its quantizer,
    (units, 16, Hkv, Dh) in both packages: the port's at
    ``ops.write_kv_int8``, the reference's at ``quantize_kv_pair_int8``
    inside its compiled scan over units (a debug callback)."""
    from repro.kernels import ops as JOPS
    from repro_torch.kernels import ops as TOPS

    got, want = [], []
    jq, tw = JOPS.quantize_kv_pair_int8, TOPS.write_kv_int8

    def jrec(k, v, seed):
        jax.debug.callback(lambda a: want.append(np.asarray(a)), k, ordered=True)
        return jq(k, v, seed)

    def trec(k, *args, **kw):
        got.append(k[0].detach().numpy().copy())
        return tw(k, *args, **kw)

    bs, n_pages = 8, 12
    toks = np.random.default_rng(3).integers(0, 256, (1, 16)).astype(np.int32)
    row = np.asarray([3, 7, 1, 9], np.int32)
    seeds = np.asarray([2**32 - 3, 5], np.uint32)
    jc = dict(JTF.init_paged_decode_cache(jcfg, 2, n_pages, bs),
              quant_step=jnp.asarray(2**31 - 2, jnp.int32))
    tc = paged_cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    jpool = {k: jc[k] for k in JTF.PAGE_POOL_LEAVES}
    JOPS.quantize_kv_pair_int8, TOPS.write_kv_int8 = jrec, trec
    try:
        out = JTF.lm_prefill_chunk(jp, jnp.asarray(toks), jcfg, jpool, JTF.init_prefill_state(jcfg),
                                   jnp.asarray(row), jnp.asarray(0, jnp.int32), 32,
                                   jnp.asarray(seeds))
        jax.block_until_ready(out)
        jax.effects_barrier()
        TTF.lm_prefill_chunk(tp, torch.from_numpy(toks), tcfg, tc, TTF.init_prefill_state(tcfg, "cpu"),
                             torch.from_numpy(row), 0, torch.from_numpy(seeds.astype(np.int64)))
    finally:
        JOPS.quantize_kv_pair_int8, TOPS.write_kv_int8 = jq, tw
    # the reference quantizes block by block: two blocks of bs rows a unit
    want = np.stack([np.concatenate(want[i:i + 2]) for i in range(0, len(want), 2)])
    return np.stack(got), want


def int8_scales() -> None:
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32", kv_cache_dtype="int8")
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32",
                               kv_cache_dtype="int8")
    jp = JTF.init_lm(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")

    def one_over_sqrt(p, x, eps=1e-6):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (1.0 / torch.sqrt(var + eps)) * (1.0 + p["scale"])).to(x.dtype)

    for label, norm in (("as the port stands", TTF.rmsnorm), ("rsqrt -> 1/sqrt", one_over_sqrt)):
        saved, TTF.rmsnorm = TTF.rmsnorm, norm
        try:
            k_got, k_want = _first_chunk_k_rows(tcfg, tp, jcfg, jp)
            got, want = _first_chunk_scales(tcfg, tp, jcfg, jp)
        finally:
            TTF.rmsnorm = saved
        for u, (a, b) in enumerate(zip(k_got, k_want)):
            amax_a, amax_b = np.abs(a).max(-1), np.abs(b).max(-1)
            print(f"first-chunk K rows before quantization, unit {u}, {label}: "
                  f"{(a == b).mean():.4f} of {a.size} bit-equal, worst |Δk| / max|k| "
                  f"{(np.abs(a - b).max(-1) / amax_b).max():.3e}, worst row max|k| relative "
                  f"difference {(np.abs(amax_a - amax_b) / amax_b).max():.3e}")
        rel = np.abs(got - want) / np.abs(want)
        print(f"int8 first-chunk K scales, port vs reference, {label}: worst relative "
              f"difference {rel.max():.3e} over {rel.size} scales")


if __name__ == "__main__":
    transcendentals()
    normals()
    int8_scales()
