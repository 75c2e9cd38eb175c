#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab DIR   # wta_counts and stoch_round: DIR's vs these

Phases, each fatal on failure (non-zero exit, no result line):

1. device: print ``nvidia-smi``'s name and power limit; no CUDA → exit 1.
2. build: compile every CUDA source of the port with nvcc (in parallel);
   print each kernel's registers, shared memory and spills as ptxas
   reports them.
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it: both attention kernels at
   stablelm-3b's full width (first, whether one slot's decode output is
   bit-identical at every window width W = 8, 16, 32 and at two slot
   indices, which decides how phase 4c gates its streams; then whether a
   speculative verify's 32 rows (k = 4 steps of B = 8 slots) are
   bit-identical to the draft rows that computed the same slot and
   position, launched with the draft batch's cluster split (required) and
   with their own (printed), and the verify shape at W = 32 against its
   plain version, timed beside its byte bound and SDPA; bf16 and int8
   pools; decode at B=8 over
   W=32, at B=1 over W=32 and at the serve profile's positions 100-130,
   each also at every cluster size; plus small GQA / local / soft-cap
   cases), ``stoch_round`` bit-identical at the int8 decode write,
   the int8 prefill chunk and the 2048² quantizer row (also one element
   into its storage, off the 16-byte grid), the fused int8 KV write
   bit-identical (trash page 0 aside) at the decode write and a 128-token
   prefill chunk, ``wta_counts`` within its agreement bound at the serving
   head's width and at (256, 128), and there exactly equal to the counts
   of every column drawn in full, with its launch shape and the head's
   device time at nine others, the premises of its pruning checked over
   every value the draw's uniforms can take, and the issue estimate of
   the plain Box-Muller path counted from the SASS of
   ``wta_draw_probe_kernel`` beside its SFU bound; with kernel times per call (CUDA events
   over back-to-back calls) and on the device (the same, with the host's
   time hidden behind a spin kernel), plain and library times, and each
   kernel's bound; ``crossbar_mac`` (prepass + tensor-core GEMM) at the
   three stablelm-3b training shapes and at odd, physical-noise and
   canary cases, its prepass's pieces, levels and column sums
   bit-identical and row sums within f32 summation error, its GEMM held
   to the read's gates and timed at every compiled tile width, and the
   comparator decisions that one bf16 or TF32 pass of x, or two bf16
   pieces, would keep; ``wta_sample`` (the threefry WTA sampler) at the
   serving head (8 x 50304 bf16 logits, 32 trials, per-slot keys and
   steps, the three reads of R = 3), the first-token sample (1 x 50304)
   and the 10-class head (64 x 10, 100 trials, one key), its counts and
   decisions exactly equal to the plain version's (any difference
   printed), its draw's bits, uniforms and normals bit-equal to
   ``repro_torch.random`` across the counter's high word, and its time
   beside the issue estimate of its own SASS (``wta_sample_issue``), and
   at the FCNN's head (1024 x 10, one trial, one key); ``sigmoid_sample``
   (the FCNN's stochastic Sigmoid neurons) at the hidden layers' shapes
   ((1024, 500), (1024, 300), (128, 500), (128, 300)), an odd shape and
   nonzero counter offsets, its bits, uniforms, p and decisions exactly
   equal to the plain version's (any difference printed with u and p),
   timed beside its byte bound and the issue estimate of its own SASS
   (``sigmoid_sample_issue``).
4. serve: ``ServingEngine`` serves a 12-request shared-prefix trace at
   stablelm-3b full width (random seeded weights) four times, with a
   bf16 and an int8 KV pool, then with WTA sampling (``wta_head``,
   ``ServeConfig(seed=0)``) on the bf16 pool at one read and at three
   redundant reads a token, with prefix hits, chunked
   suffix prefill and copy-on-write, each through the compiled engine
   (the decode step captured as one CUDA graph per window width and
   replayed) and then eagerly (``graphs=False``): streams equal token for
   token (a divergence printed with both sides' tokens at it), launch
   counts equal; each run prints its captures, each capture's ms,
   ``compile_counts()`` (one ``serve_step`` per window width, fewer than
   decode steps), its widest graph's nodes by type, and the device
   memory its engine held, which must all be freed once it is dropped
   (under 32 MiB left).  The launch counts of the kernels each run goes
   through, reset just before and read just after (the counters add
   each graph's captured counts on every replay), must be > 0 (attention: one launch
   per layer and decode step; the int8 run: one fused write per
   attention launch; the WTA runs: R ``wta_sample`` launches per decode
   step, one per first token).  Each run ends in a profile of full-batch
   decode ticks (replays, for the compiled engine) with kernels per tick,
   the device busy share and the decode attention kernel's and the WTA
   sampler's shares of the device time.  Then the degraded serve
   (:func:`degraded_phase`): the WTA trace through the compiled engine on
   the ``sim_faulty`` backend with every knob at zero (the ``sim`` WTA
   stream token for token, analog counts = tokens computed x per-token
   counts exactly, = the ``sim`` run's), and again under the ladder
   (canary every tick, comparator offset 3 injected at tick 4 and taken
   back at tick 16, idle ticks until level 0): the ladder reaches level 2
   (R = 3 captured) and returns, its transitions printed, the canary's
   ``crossbar_mac`` launches equal its probes (reset just before, read
   just after), re-reads priced, every request ends with a typed reason,
   the tokens before tick 4 equal the zero-knob run's, the graph rebuilds
   and each recapture's ms printed, device memory after each rebuild
   within 32 MiB of before, under 32 MiB left once the engine is dropped;
   both print the Table I model's pJ per published token and TOPS/W (a
   model, not a measurement).  Then phase 4c (:func:`preempt_phase`),
   through the compiled engine with half the trace's reservations in the
   pool: (a) requests 0-7 at priority 1, 8-11 at priority 0 after 7 ticks,
   two forced preempts at tick 16, a spill budget of one record, greedy
   bf16: at least 3 preemptions, 1 restore and 1 dropped record, every
   stream phase 4's, each spill's bytes (the fixed-width record) and ms,
   each restore's ms, the preempting ticks' host ms beside the others';
   (b) the same with WTA sampling (phase 4's WTA streams); (c) on an int8
   pool (agreement printed, not gated); (d) chaos on bf16 and int8 pools:
   a prefill killed at tick 1, a NaN page at tick 5 (the victim's sanity
   code ``SANE_NAN`` through the decode kernel), a deadline storm at tick
   20; each run with typed done reasons, the allocator back to capacity,
   one signature per preemption entry point, the pool's addresses kept,
   no capture from a restore or a poison, its kernels launched, under 32
   MiB left.  Then host ms a full-batch tick in turns in
   one process: greedy and WTA, each compiled and eager, and WTA compiled
   on ``sim_faulty`` with the canary off and on every tick.  Then phase
   4d (:func:`spec_phase`), self-speculative decoding through the
   compiled engine (one captured round per (W, k)), the trace at 16 tokens
   a request: first a probe of one round's draft and verify logits
   (:func:`spec_probe`; bf16 and f32 weights, float and int8 pools:
   max|Δlogit| between each verify row and its draft row, rows not
   bit-equal, rows whose argmax or WTA decision differs); then (a) greedy
   k = 4, (b) WTA k = 3, (c) int8 greedy k = 4, (d) drafts reported wrong
   every other round (rollbacks; one ``spec_rollback`` signature), (e)
   forced preempts at ticks 1 and 3 under k = 3 (restores = preemptions);
   each with its acceptance, tokens a round, tok/s, decode step ms, TTFT,
   ``compile_counts()`` (one ``spec_round`` per width, fewer than rounds),
   captures and their ms, no capture inside a rollback, decode attention
   launches = 32·(k + 1) a round + 32 a plain tick, ``write_kv_int8`` and
   ``wta_sample`` launches exact, under 32 MiB left.  Where the probe
   finds the bf16 verify rows bit-equal to their drafts, (a), (b), (d),
   (e) are gated on phase 4's streams; otherwise the same runs on an f32
   copy of the weights are gated on its own plain serve, and the bf16
   agreement is printed (int8 never gated).  Then host ms of a replayed
   round against a replayed plain tick, in turns (:func:`spec_turns`).
5. entry points: ``ops.stoch_round_serving`` on the 2048² quantizer row
   and ``ops.wta_counts`` at the serving head's operating point (8 ×
   50304, 32 trials); each kernel's launches, reset just before and read
   just after, must be > 0.  Then through ``use_backend(FaultySimBackend)``
   (:func:`faulty_phase`): ``ops.crossbar_mac`` at the (1024, 2560) x
   (2560, 2560) training read with 0.1% stuck cells and drift at clock
   100 (the faulty weights equal the plain-torch transform on the card
   bit for bit, the CPU's within an ulp budget, the read within the
   linear gate of its plain version on them), and
   ``ops.wta_counts`` at the serving head with a comparator offset and
   read-noise inflation (within its agreement bound of the plain version
   at the shifted operating point).
6. train: RACA analog training (``--analog``) of stablelm-3b at full width
   and depth, batch 8 x 128, 3 steps through ``make_train_step``: finite
   losses, parameters changed, ``crossbar_mac`` launched 224 reads and
   224 prepasses per step (reset just before, read just after); step
   time, tokens/s, peak memory and a profiled step's split.
6b. FCNN: fcnn-mnist [784, 500, 300, 10] trained at full width through
   ``make_train_step`` (300 steps of batch 128, lr 3e-3, f32 moments,
   seed 0), then Fig. 6's protocol on 1024 images: digital accuracy and
   RACA accuracy at 1 / 4 / 16 / 64 votes beside the reference's CPU
   numbers; ``sigmoid_sample`` and ``wta_sample`` launched exactly 2 and 1
   times a vote (reset just before, read just after); accuracy gates of
   ``tests/test_system.py``; a profiled training step and 64-vote
   prediction.
7. reference: smoke-size prefill and decode logits on the card (kernels)
   agree with the same model on the CPU (plain versions), for a float and
   an int8 pool (whose written codes must agree too); two smoke-size
   analog training steps agree card vs CPU (losses, comparator
   decisions); a smoke-size WTA serve (R = 1 and 3; eager on the card,
   so that its sampler calls can be recorded) gives the same streams on
   the card and on the CPU (a divergence is printed with both sides'
   votes at it, and fails); five smoke FCNN training steps and its
   predictions agree card vs CPU.

The second-to-last line is the ``kernels`` JSON record; the last is
``{"ok": true, "device": {...}}``.  With ``--ab DIR`` only phases 1-2 run,
then :func:`ab_phase` holds DIR's wta_counts and stoch_round kernels
against this checkout's (outputs equal, device and per-call times in
turns).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor rate
# H100 SXM special-function rate: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz maximum boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# Kernel vs plain version: both accumulate in f32 from the same bf16/int8
# inputs and differ only in summation order and exp rounding (~1e-6
# relative); 2e-3 absolute and relative leaves room for int8 scores.
ATOL = RTOL = 2e-3
# Smoke-size f32 model, card (kernels, cuBLAS) vs CPU (plain versions).
REF_ATOL = 1e-4
# The same with an int8 pool.  Codes are bit-exact for equal f32 inputs,
# but K/V rows differ between cuBLAS and the CPU at f32 rounding (~1e-7
# relative), so an element within that distance of its rounding draw takes
# the neighbouring code: ~1e-5 per element, ~0.1 flips expected in the
# ~11k live codes.  Gate: at least 99.95% of the pool's codes equal, none
# more than one level apart; logits within 2e-2, since one flipped live
# code moved logits by up to ~3e-3 in a CPU trial at this size.
REF_INT8_CODES = 0.9995
REF_INT8_ATOL = 2e-2
# wta_counts kernel vs plain version: Gaussians through logf/cosf on both
# sides, so a trial can flip only where two voltages race within an ulp.
# Gate: equal row sums, and sum|Δcounts| <= 2 x 1% of the B·T decisions.
WTA_FLIP_FRACTION = 0.01
WTA_VTH0, WTA_SIGMA = 1.702**2, 1.702   # the serving head's operating point
# wta_sample kernel vs plain version on the card: both draw with CUDA's
# log1pf and round every other step once, so the bits, uniforms, normals,
# counts and decisions must be equal, as they were in every run.  Card vs
# CPU smoke WTA serve: token streams equal.
# Issue estimate: one warp instruction per scheduler per clock, 132 SMs x
# 4 schedulers x 1.98 GHz; a warp instruction holds the 16-lane ALU or FMA
# heavy pipe 2 clocks and the 4-lane XU (MUFU, conversions) 8 clocks.
ISSUE_PER_S = 132 * 4 * 1.98e9
# H100 SXM f32 FMA rate on the CUDA cores: 132 SMs x 128 lanes x 2 x 1.98 GHz
F32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9
# crossbar_mac vs its plain version: the quantized weights and the noise are
# bit-identical, the f32 products are summed in another order (the plain
# version's is cuBLAS's).  Linear readout: |Δ| <= 2·sqrt(K)·2**-24 times
# Σ_k |x_k·Wq_k| per element (twice the random-walk size of an f32 sum's
# rounding), and, with the physical noise model (σ from ΣWq, summed in
# another order too), 1e-5 of |out| besides.  Comparator readout: at least
# 99.95% of the decisions equal (tests/test_kernels.py:57's agreement).
CB_AGREEMENT = 0.9995
# stablelm-3b analog training: 7 crossbar reads per layer and forward
# (wq wk wv wo w_down linear, w_up w_gate binarized), none in the backward
CB_PER_LAYER = 7
TRAIN_STEPS = 3
# Smoke-size analog training, card vs CPU: the comparator decisions may
# flip where z + noise sits within f32 rounding of 0 (gate: >= 99.9% of the
# binary activations equal); a flipped hidden unit moves one token's loss
# by ~1e-2 at this size, so the mean loss gets 1e-3.
REF_TRAIN_AGREEMENT = 0.999
REF_TRAIN_LOSS_ATOL = 1e-3
# The paper's FCNN (fcnn-mnist [784, 500, 300, 10]), examples/
# train_mnist_raca.py's protocol: 300 steps of batch 128, lr 3e-3, f32
# moments without stochastic rounding, seed 0; Fig. 6's test set of 1024
# images, RACA votes under PRNGKey(7).  The reference's numbers for that
# protocol, run through repro on a CPU (examples/train_mnist_raca.py's
# log): loss 2.5568 at step 0 and 0.1208 at step 280, digital 0.9512,
# RACA 0.7754 / 0.8828 / 0.9365 / 0.9424 at 1 / 4 / 16 / 64 votes.
FCNN_STEPS, FCNN_BATCH, FCNN_LR, FCNN_TEST = 300, 128, 3e-3, 1024
FCNN_VOTES = (1, 4, 16, 64)
FCNN_REFERENCE_CPU = {"loss": {0: 2.5568, 280: 0.1208}, "digital": 0.9512,
                      "raca": {1: 0.7754, 4: 0.8828, 16: 0.9365, 64: 0.9424}}
# Smoke-size FCNN, card vs CPU: expectation-mode training is f32 products
# in another order (losses within 1e-5); hard votes can flip where u sits
# within ulps of p, so predictions agree on at least 98%.
REF_FCNN_LOSS_ATOL = 1e-5
REF_FCNN_AGREEMENT = 0.98


def log(msg: str) -> None:
    print(msg, flush=True)


# Timed calls rotate over this many independent input sets, so that the
# decode pools (42 MB each at full width) do not sit in the 50 MB L2 from
# one call to the next: the serving path meets each layer's pool cold.
ROTATE = 8


def cuda_ms(fns, iters: int = 24, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    cycling over ``fns`` (one closure per input set)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, iters: int = 24) -> float:
    """Mean device time of one call with the host's time between launches
    left out, which :func:`cuda_ms` includes and which dominates a call
    whose kernel takes a few microseconds.  A spin kernel holds the stream
    while all ``iters`` calls (cycling over ``fns``) are queued behind it,
    so CUDA events around them time the calls' launches back to back.  The
    start event must still be pending once the last call is queued, or the
    spin ran out before the host was done; the spin then grows and the
    window is timed again."""
    fns[0]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000                      # ~10 ms at the H100's 1.98 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("the host did not queue the timed calls within the spin")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def make_pool(gen, n_pages, bs, hkv, dh, int8, dev):
    shape = (n_pages, bs, hkv, dh)
    if int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device=dev) + 0.1
        vs = torch.rand(shape[:3], generator=gen, device=dev) + 0.1
        return kp, vp, dict(k_scale=ks, v_scale=vs)
    kp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return kp, vp, {}


def decode_case(gen, dev, b, h, hkv, dh, bs, w, int8, pos_range=None):
    """Random positions in [0, W·bs) with slot 0 at W·bs - 1, or, given
    ``pos_range``, uniform in that closed range (the serve profile's)."""
    n_pages = b * w + 1
    kp, vp, sc = make_pool(gen, n_pages, bs, hkv, dh, int8, dev)
    q = torch.randn((b, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * w] + 1)
    table = table.reshape(b, w).to(torch.int32)
    if pos_range is None:
        pos = torch.randint(0, w * bs, (b,), generator=gen, device=dev, dtype=torch.int32)
        pos[0] = w * bs - 1                   # one slot uses the whole table
    else:
        lo, hi = pos_range
        pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    nblk = (pos // bs + 1).clamp(max=w)
    cols = torch.arange(w, device=dev)[None]
    table = torch.where(cols < nblk[:, None], table, -1)  # unassigned ids past pos
    table[min(1, b - 1), 0] = -1              # a live id < 0 reads page 0
    return q, kp, vp, table.contiguous(), pos, sc


def prefill_case(gen, dev, s, q0, h, hkv, dh, bs, w, int8):
    n_pages = w + 2
    kp, vp, sc = make_pool(gen, n_pages, bs, hkv, dh, int8, dev)
    q = torch.randn((s, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:w] + 1).to(torch.int32)
    return q, kp, vp, table.contiguous(), q0, sc


def decode_bound(q, kp, table, pos, sc):
    b, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    live = int((pos // bs + 1).clamp(max=table.shape[1]).sum()) * bs  # keys read
    page_bytes = live * hkv * dh * kp.element_size() * 2
    if sc:
        page_bytes += live * hkv * 4 * 2
    nbytes = page_bytes + q.numel() * q.element_size() + b * h * dh * 4 \
        + table.numel() * 4 + pos.numel() * 4
    keys = int((pos + 1).clamp(max=table.shape[1] * bs).sum())   # unmasked keys
    flops = 4 * keys * h * dh
    return bound_record(nbytes, flops)


def prefill_bound(q, kp, table, q0, sc):
    s, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    nblk = min(table.shape[0], (q0 + s - 1) // bs + 1)
    live = nblk * bs
    page_bytes = live * hkv * dh * kp.element_size() * 2
    if sc:
        page_bytes += live * hkv * 4 * 2
    nbytes = page_bytes + q.numel() * q.element_size() + s * h * dh * 4 + table.numel() * 4
    keys = sum(min(q0 + i + 1, live) for i in range(s))
    flops = 4 * keys * h * dh
    return bound_record(nbytes, flops)


def bound_record(nbytes, flops, ops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "flops": flops,
    }


def sdpa_decode(q, kp, vp, table, pos):
    """Library yardstick: SDPA over the pre-gathered window (bf16 pools)."""
    import torch.nn.functional as F

    b, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    ids = table.long().clamp_min(0)
    k = kp[ids].reshape(b, -1, hkv, dh).transpose(1, 2).contiguous()
    v = vp[ids].reshape(b, -1, hkv, dh).transpose(1, 2).contiguous()
    mask = torch.arange(k.shape[2], device=q.device)[None, :] <= pos[:, None].long()
    qq = q[:, :, None, :]
    m = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=m, enable_gqa=hkv != h)


def sdpa_prefill(q, kp, vp, table, q0):
    import torch.nn.functional as F

    s, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    ids = table.long().clamp_min(0)
    k = kp[ids].reshape(-1, hkv, dh).transpose(0, 1)[None].contiguous()
    v = vp[ids].reshape(-1, hkv, dh).transpose(0, 1)[None].contiguous()
    qpos = q0 + torch.arange(s, device=q.device)[:, None]
    mask = (torch.arange(k.shape[2], device=q.device)[None, :] <= qpos)[None, None]
    qq = q.transpose(0, 1)[None].contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask, enable_gqa=hkv != h)


def time_kernel(rec, cases, kernel, plain, library, label) -> dict:
    """Kernel, plain and library times over rotating input sets; each case
    is ``(*args, kwargs)``; ``library`` (or None, where no one PyTorch call
    computes the function) takes the args and returns a closure."""
    def bind(fn, c):
        *args, sc = c
        return lambda: fn(*args, **sc)

    rec["ms"] = cuda_ms([bind(kernel, c) for c in cases])
    rec["device_ms"] = device_ms([bind(kernel, c) for c in cases])
    rec["plain_ms"] = cuda_ms([bind(plain, c) for c in cases])
    rec["library_ms"] = (
        cuda_ms([library(*c[:-1]) for c in cases]) if library is not None else None
    )
    log(f"  {label}: kernel {rec['ms']:.4f} ms per call ({rec['device_ms']:.4f} ms on the "
        f"device), plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {rec['bytes']} bytes, {rec['flops']} ops)")
    return rec


CASE_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "split_device_ms")


def split_sweep(cases, label) -> dict:
    """Device time of the decode kernel at every cluster size, to hold
    decode_geometry's pick against the others (the override is for this
    measurement only)."""
    from repro_torch.kernels import paged_attention as PA

    def bind(c, ns):
        *args, sc = c
        return lambda: PA.paged_attention_cuda(*args, **sc, n_split=ns)

    out = {ns: device_ms([bind(c, ns) for c in cases]) for ns in (1, 2, 4, 8)}
    log(f"  {label}: device ms by n_split " + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()))
    return out


def check(name, got, want, errs):
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, atol=ATOL, rtol=RTOL)
    log(f"  {name}: max|err| {err:.3e} (atol=rtol={ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    errs.append(err)


def decode_w_invariance(gen, dev) -> dict:
    """Whether one slot's decode attention output is bit-identical at
    every window width W its position allows (W = 8, 16, 32 at positions
    100-127; W = 16, 32 at 200-255) and at two slot indices of the B = 8
    batch (0 and 5): the windows and slots a preempted request meets that
    the unpreempted one did not.  ``decode_geometry`` picks the cluster
    split from W, and another split sums in another order."""
    from repro_torch.kernels import paged_attention as PA

    b, h, hkv, dh, bs = 8, 32, 32, 80, 16
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        kp, vp, sc = make_pool(gen, b * 32 + 1, bs, hkv, dh, int8, dev)
        table = (torch.randperm(b * 32, generator=gen, device=dev) + 1).reshape(b, 32)
        table = table.to(torch.int32)
        q = torch.randn((b, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
        same, worst = True, 0.0
        for (lo, hi), widths in (((100, 127), (8, 16, 32)), ((200, 255), (16, 32))):
            pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
            first = None
            for w in widths:
                for slot in (0, 5):
                    perm = list(range(b))
                    perm[0], perm[slot] = perm[slot], perm[0]
                    o = PA.paged_attention_cuda(q[perm], kp, vp, table[perm, :w].contiguous(),
                                                pos[perm], **sc)[slot]
                    if first is None:
                        first = o
                    same &= torch.equal(o, first)
                    worst = max(worst, float((o - first).abs().max()))
        splits = {w: PA.decode_geometry(b, h, hkv, dh, bs, w, kp.dtype)["n_split"]
                  for w in (8, 16, 32)}
        out[tag] = {"identical": bool(same), "max_abs_diff": worst, "n_split": splits}
        log(f"  decode {tag}, one slot at W = 8/16/32 and slots 0/5: bit-identical {same} "
            f"(max|diff| {worst:.3e}); n_split by W {splits}")
    return out


def verify_case(gen, dev, b, k, w, int8, pos_range):
    """A speculative verify's decode attention: k·B rows, row (j, s) slot
    s's query at position pos_s + j over slot s's table row (the table
    tiled k times), every page of the window live.  Returns the case and
    the k draft calls' (q, table, pos) it re-reads."""
    bs, h, dh = 16, 32, 80
    n_pages = b * w + 1
    kp, vp, sc = make_pool(gen, n_pages, bs, 32, dh, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).reshape(b, w)
    table = table.to(torch.int32).contiguous()
    lo, hi = pos_range
    pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randn((k * b, h, dh), generator=gen, device=dev, dtype=torch.bfloat16)
    vpos = (pos.repeat(k) + torch.arange(k, device=dev, dtype=torch.int32).repeat_interleave(b))
    drafts = [(q[j * b:(j + 1) * b], table, (pos + j).to(torch.int32)) for j in range(k)]
    return (q, kp, vp, table.repeat(k, 1).contiguous(), vpos.contiguous(), sc), drafts


def verify_bound(q, kp, table, pos, sc, b):
    """Bytes a verify must move: each slot's live pages once (its k rows
    share them), the k·B queries, outputs, table rows and positions; the
    operations of every row's unmasked keys."""
    kb, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    last = pos.reshape(-1, b).amax(dim=0)
    live = int((last // bs + 1).clamp(max=table.shape[1]).sum()) * bs
    nbytes = live * hkv * dh * kp.element_size() * 2 + (live * hkv * 4 * 2 if sc else 0)
    nbytes += q.numel() * q.element_size() + kb * h * dh * 4 + table.numel() * 4 + kb * 4
    keys = int((pos + 1).clamp(max=table.shape[1] * bs).sum())
    return bound_record(nbytes, 4 * keys * h * dh)


def verify_rows(gen, dev, errs, timing) -> dict:
    """The speculative verify's decode attention at the main path's shape
    (B = 8 slots, k = 4: 32 rows, bf16 and int8 pools): first whether each
    verify row is bit-equal to the draft row that computed the same
    (slot, position) at B = 8, at W = 8, 16 and 32, launched as the round
    launches it (``split_batch`` = 8: the draft batch's cluster split) and
    with the split the kernel would pick for 32 rows; then, at W = 32,
    against its plain version, timed beside its byte bound and SDPA."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref

    b, k = 8, 4
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        res = {"split_identical": True, "own_identical": True, "own_max_abs_diff": 0.0,
               "n_split": {}}
        for w, pr in ((8, (100, 124)), (16, (200, 252)), (32, (300, 508))):
            (q, kp, vp, table, vpos, sc), drafts = verify_case(gen, dev, b, k, w, int8, pr)
            want = torch.cat([PA.paged_attention_cuda(dq, kp, vp, dt, dp, **sc)
                              for dq, dt, dp in drafts])
            got = PA.paged_attention_cuda(q, kp, vp, table, vpos, split_batch=b, **sc)
            own = PA.paged_attention_cuda(q, kp, vp, table, vpos, **sc)
            res["split_identical"] &= torch.equal(got, want)
            res["own_identical"] &= torch.equal(own, want)
            res["own_max_abs_diff"] = max(res["own_max_abs_diff"], float((own - want).abs().max()))
            res["n_split"][w] = (PA.decode_geometry(b, 32, 32, 80, 16, w, kp.dtype)["n_split"],
                                 PA.decode_geometry(k * b, 32, 32, 80, 16, w, kp.dtype)["n_split"])
        log(f"  verify {tag} (32 rows = 4 steps x 8 slots) against its draft rows at W = 8/16/32: "
            f"bit-identical with the draft's split {res['split_identical']}, with its own "
            f"{res['own_identical']} (max|diff| {res['own_max_abs_diff']:.3e}); n_split (draft "
            f"B = 8, own 32 rows) by W {res['n_split']}")
        if not res["split_identical"]:
            raise AssertionError(f"verify {tag}: rows launched with the draft's split differ "
                                 "from their draft rows")
        cases = []
        for _ in range(ROTATE):
            case, _ = verify_case(gen, dev, b, k, 32, int8, (300, 508))
            cases.append(case)
        q, kp, vp, table, vpos, sc = cases[0]
        args = (q, kp, vp, table, vpos)

        def kernel(*a, **kw):
            return PA.paged_attention_cuda(*a, split_batch=b, **kw)

        check(f"decode {tag} verify 32 rows W=32", kernel(*args, **sc),
              ref.paged_attention_ref(*args, **sc), errs)
        geo = PA.decode_geometry(b, 32, 32, 80, 16, 32, kp.dtype)
        timing[tag] = time_kernel(
            verify_bound(q, kp, table, vpos, sc, b), cases, kernel, ref.paged_attention_ref,
            None if int8 else sdpa_decode,
            f"decode {tag} verify 32 rows W=32 (n_split {geo['n_split']} of B = 8)")
        out[tag] = res
    return out


def kernel_phase(dev) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"decode": [], "prefill": []}
    timing = {}
    w_invariance = decode_w_invariance(gen, dev)
    verify_timing = {}
    verify = verify_rows(gen, dev, errs["decode"], verify_timing)
    # full width: stablelm-3b heads (H = Hkv = 32, Dh = 80), bs = 16
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        # B=8 over W=32 (random positions, one slot at the end: the main
        # record), one slot over the whole window (the old grid used 32 of
        # 132 SMs), and the serve profile's eight slots at positions
        # 100-130 (W=16); each also timed at every cluster size
        extra = []
        for label, b, w, pr in (("B=8 W=32", 8, 32, None), ("B=1 W=32", 1, 32, None),
                                ("B=8 W=16 pos 100-130", 8, 16, (100, 130))):
            cases = [decode_case(gen, dev, b, 32, 32, 80, 16, w, int8, pr) for _ in range(ROTATE)]
            q, kp, vp, table, pos, sc = cases[0]
            args = (q, kp, vp, table, pos)
            geo = PA.decode_geometry(b, 32, 32, 80, 16, w, kp.dtype)
            check(f"decode {tag} {label}", PA.paged_attention_cuda(*args, **sc),
                  ref.paged_attention_ref(*args, **sc), errs["decode"])
            rec = time_kernel(
                decode_bound(q, kp, table, pos, sc), cases,
                PA.paged_attention_cuda, ref.paged_attention_ref,
                None if int8 else sdpa_decode,
                f"decode {tag} {label} (n_split {geo['n_split']}, grid {geo['grid']})",
            )
            rec["split_device_ms"] = split_sweep(cases, f"decode {tag} {label}")
            if label == "B=8 W=32":
                timing[("decode", tag)] = rec
            else:
                extra.append({"case": f"{tag} {label}", **{k: rec[k] for k in CASE_KEYS}})
        rec = verify_timing[tag]
        extra.append({"case": f"{tag} verify 32 rows (k = 4 x B = 8) W=32, split of B = 8",
                      **{k: rec.get(k) for k in CASE_KEYS}})
        timing[("decode", tag)]["cases"] = extra
        for q0 in (0, 128):
            cases = [prefill_case(gen, dev, 128, q0, 32, 32, 80, 16, 16, int8)
                     for _ in range(ROTATE if q0 else 1)]
            q, kp, vp, table, _, sc = cases[0]
            args = (q, kp, vp, table, q0)
            check(f"prefill {tag} S=128 q0={q0}", PF.paged_prefill_attention_cuda(*args, **sc),
                  ref.prefill_attention_ref(*args, **sc), errs["prefill"])
        timing[("prefill", tag)] = time_kernel(
            prefill_bound(q, kp, table, 128, sc), cases,
            PF.paged_prefill_attention_cuda, ref.prefill_attention_ref,
            None if int8 else sdpa_prefill, f"prefill {tag} S=128 q0=128",
        )
    # small cases: GQA, local windows, soft-capping, f32 queries on int8
    for kind, lw, cap, hkv in (("global", 0, 30.0, 8), ("local", 37, 0.0, 4), ("local", 20, 50.0, 32)):
        kw = dict(kind=kind, local_window=lw, softcap=cap)
        for int8 in (False, True):
            tag = f"{kind} lw={lw} cap={cap} Hkv={hkv} {'int8' if int8 else 'bf16'}"
            q, kp, vp, table, pos, sc = decode_case(gen, dev, 3, 32, hkv, 80, 16, 8, int8)
            if int8:
                q = q.float()
            args = (q, kp, vp, table, pos)
            check(f"decode {tag}", PA.paged_attention_cuda(*args, **kw, **sc),
                  ref.paged_attention_ref(*args, **kw, **sc), errs["decode"])
            q, kp, vp, table, _, sc = prefill_case(gen, dev, 37, 45, 32, hkv, 80, 16, 6, int8)
            args = (q, kp, vp, table, 45)
            check(f"prefill {tag}", PF.paged_prefill_attention_cuda(*args, **kw, **sc),
                  ref.prefill_attention_ref(*args, **kw, **sc), errs["prefill"])
    torch.cuda.synchronize()
    timing["stoch_round"], errs["stoch_round"] = stoch_round_kernels(gen, dev)
    timing["wta_counts"], errs["wta_counts"] = wta_kernels(gen, dev)
    (timing["crossbar_mac"], timing["crossbar_prepass"], errs["crossbar_mac"],
     errs["crossbar_prepass"]) = crossbar_kernels(gen, dev)
    timing["write_kv_int8"], errs["write_kv_int8"] = write_kernels(gen, dev)
    timing["wta_sample"], errs["wta_sample"] = wta_sample_kernels(gen, dev)
    timing["sigmoid_sample"], errs["sigmoid_sample"] = sigmoid_sample_kernels(gen, dev)
    return {"errs": errs, "timing": timing, "w_invariance": w_invariance, "verify": verify}


def stoch_round_kernels(gen, dev):
    """stoch_round vs its plain version, bit for bit, at the int8 decode
    write's rows (8 slots x 32 kv heads of Dh=80), the int8 prefill
    chunk's (8 blocks of 16 x 32 rows, one seed each) and bench_kernels.py's
    2048² row on the 2/31 grid, the shape its entry point runs here; times
    at each.  Returns (2048² record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stoch_round as SR

    def kv_rows(rows):  # the quantizer's input: x / max|x| · 127 per row
        x = torch.randn((rows, 80), generator=gen, device=dev)
        return x / x.abs().amax(-1, keepdim=True).clamp_min(1e-6) * 127.0

    def seeds(n):
        return torch.randint(0, 2**32, (n,), generator=gen, device=dev, dtype=torch.int64)

    def offset_by_one(x):   # the same values one element into their storage
        flat = torch.empty(x.numel() + 1, device=dev)
        y = flat[1:].view(x.shape)
        y.copy_(x)
        return y

    log_ptxas("stoch_round_kernel")
    cases = [
        ("decode write (8*32, 80), 1 seed", kv_rows(8 * 32), seeds(1), 1.0, -127.0, 127.0),
        ("prefill chunk 8 x (16*32, 80), 8 seeds", kv_rows(8 * 16 * 32), seeds(8), 1.0, -127.0, 127.0),
        ("quantizer (2048, 2048) step 2/31", torch.randn((2048, 2048), generator=gen, device=dev),
         seeds(1), 2.0 / 31, -1.0, 1.0),
        ("quantizer (2048, 2048) at storage offset 1",
         offset_by_one(torch.randn((2048, 2048), generator=gen, device=dev)), seeds(2),
         2.0 / 31, -1.0, 1.0),
    ]
    recs, errs = [], []
    for label, x, sd, step, lo, hi in cases:
        kw = dict(step=step, lo=lo, hi=hi)
        geo = SR.stoch_round_geometry(*x.shape)
        log(f"  stoch_round {label}: {geo.blocks} CTAs of {geo.ty} rows x {geo.tx} threads")
        got, want = SR.stoch_round_cuda(x, sd, **kw), ref.stoch_round_ref(x, sd, **kw)
        same = torch.equal(got, want)
        errs.append(float((got - want).abs().max()))
        log(f"  stoch_round {label}: bit-identical {same}, max|err| {errs[-1]:.3e}")
        if not same:
            raise AssertionError(f"stoch_round {label}: kernel differs from its plain version")
        copy = offset_by_one if x.storage_offset() else torch.clone
        recs.append(time_kernel(
            bound_record(8 * x.numel(), 0), [(copy(x), sd, kw) for _ in range(ROTATE)],
            SR.stoch_round_cuda, ref.stoch_round_ref, None, f"stoch_round {label}",
        ))
    recs[2]["cases"] = [{"case": label, **{a: r[a] for a in CASE_KEYS if a in r}}
                        for (label, *_), r in zip(cases[:2] + cases[3:], recs[:2] + recs[3:])]
    return recs[2], errs


def write_kernels(gen, dev):
    """The fused int8 KV write vs its plain version, bit for bit outside
    the trash page 0, at stablelm-3b's kv heads (Hkv 32, Dh 80, bs 16,
    bf16 rows): the decode write of 8 slots (one on the trash page, one
    past its table) and a 128-token prefill chunk of 8 blocks; times at
    each.  Returns (decode record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stoch_round as SR

    hkv, dh, bs, n_pages = 32, 80, 16, 8 * 32 + 1

    def pools():
        return [torch.randint(-127, 128, (n_pages, bs, hkv, dh), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2)] + \
               [torch.rand((n_pages, bs, hkv), generator=gen, device=dev) + 0.5 for _ in range(2)]

    def rows(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)

    def seeds(n):
        return torch.randint(0, 2**32, (n,), generator=gen, device=dev, dtype=torch.int64)

    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:8 * 32] + 1)
    table = table.reshape(8, 32).to(torch.int32)
    pos = torch.randint(0, 32 * 16, (8,), generator=gen, device=dev, dtype=torch.int32)
    pos[1], pos[2] = 40, 5000                       # the trash page; past the table
    table[1, 40 // bs] = -1
    row = table[0].contiguous()
    cases = [
        ("decode write, 8 slots", (8, 1, hkv, dh), 1, dict(table=table, pos=pos)),
        ("prefill chunk, 128 tokens", (1, 128, hkv, dh), 8, dict(table_row=row, b0=8)),
    ]
    recs, errs = [], []
    for label, shape, n_seeds, where in cases:
        k, v, sd = rows(shape), rows(shape), seeds(n_seeds)
        got = pools()
        want = [t.clone() for t in got]
        SR.write_kv_int8_cuda(k, v, *got, sd, **where)
        ref.write_kv_int8_ref(k, v, *want, sd, **where)
        same = all(torch.equal(g[1:], w_[1:]) for g, w_ in zip(got, want))
        errs.append(max(float((g[1:].float() - w_[1:].float()).abs().max())
                        for g, w_ in zip(got, want)))
        log(f"  write_kv_int8 {label}: codes and scales bit-identical outside page 0 {same}")
        if not same:
            raise AssertionError(f"write_kv_int8 {label}: kernel differs from its plain version")
        n_rows = k.numel() // dh if "table" in where else -(-shape[1] // bs) * bs * hkv
        # rows read (bf16) once, codes and scales written once, K and V
        nbytes = 2 * (k.numel() * 2 + n_rows * (dh + 4))
        sets = [(rows(shape), rows(shape), *pools(), sd, where) for _ in range(ROTATE)]
        recs.append(time_kernel(
            bound_record(nbytes, 0), sets, SR.write_kv_int8_cuda, ref.write_kv_int8_ref, None,
            f"write_kv_int8 {label}",
        ))
    recs[0]["cases"] = [{"case": cases[1][0], **{a: recs[1][a] for a in CASE_KEYS if a in recs[1]}}]
    return recs[0], errs


def wta_kernels(gen, dev):
    """wta_counts vs its plain version at the serving head's width (8 x
    50304, 32 trials) and at (256, 128) with 64 trials, and exactly equal
    there to the votes of a full draw (:func:`wta_counts.full_draw_counts`).
    Returns (head-shape record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_counts as WTA

    log_ptxas("wta_cluster_kernel", "wta_warp_kernel")
    r_max, cos_max = WTA.draw_bounds(dev)
    log(f"  wta draw over every uniform: largest radius {r_max!r}, largest |cos| {cos_max!r} "
        f"(the kernel's bounds need <= 1)")
    if not cos_max <= 1.0:
        raise AssertionError("wta_counts: |cosf| exceeds 1, so the radius does not bound the noise")
    issue = wta_issue_estimate(gen, dev)
    recs, errs = [], []
    resident = WTA.resident_warps(dev)
    for b, c, n_trials in ((8, 50304, 32), (256, 128, 64)):
        geo = WTA.wta_geometry(c, b * n_trials, resident)
        log(f"  wta_counts ({b}, {c}) T={n_trials}: " + (
            f"clusters of {geo.n_cta} CTAs of {geo.warps} warps x {geo.cols_per_cta} columns, "
            f"{b * n_trials} clusters ({resident} resident warps)" if geo.n_cta else
            f"one warp per (row, trial), every column drawn, "
            f"{-(-b * n_trials // WTA.WARPS)} CTAs of {WTA.WARPS} warps"))
        kw = dict(n_trials=n_trials, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
        zs = [torch.randn((b, c), generator=gen, device=dev) * WTA_SIGMA for _ in range(ROTATE)]
        seed = torch.randint(0, 2**32, (1,), generator=gen, device=dev, dtype=torch.int64)
        got, want = WTA.wta_counts_cuda(zs[0], seed, **kw), ref.wta_counts_ref(zs[0], seed, **kw)
        delta = float((got - want).abs().sum())
        sums_equal = torch.equal(got.sum(-1), want.sum(-1))
        errs.append(float((got - want).abs().max()))
        log(f"  wta_counts ({b}, {c}) T={n_trials}: row sums equal {sums_equal}, "
            f"sum|Δcounts| {delta:.0f} (bound {2 * WTA_FLIP_FRACTION * b * n_trials:.1f}), "
            f"votes {int(got.sum())}")
        if not sums_equal or delta > 2 * WTA_FLIP_FRACTION * b * n_trials:
            raise AssertionError("wta_counts: kernel disagrees with its plain version")
        # the pruning is exact: the counts of every column drawn in full
        # (the probe, the kernel's own logf and cosf) are the kernel's
        full = WTA.full_draw_counts(zs[0], seed, **kw)
        log(f"  wta_counts ({b}, {c}) T={n_trials}: equal to the full draw's counts "
            f"{torch.equal(got, full)} (sum|Δ| {float((got - full).abs().sum()):.0f})")
        if not torch.equal(got, full):
            raise AssertionError("wta_counts: the pruned kernel differs from a full draw")
        # bound: z read and counts written once, or 3 transcendentals
        # (log, sqrt, cos) per trial and element on the SFUs
        recs.append(time_kernel(
            bound_record(8 * b * c, 3 * b * c * n_trials, SFU_OPS_PER_S),
            [(z, seed, kw) for z in zs], WTA.wta_counts_cuda, ref.wta_counts_ref, None,
            f"wta_counts ({b}, {c}) T={n_trials}",
        ))
        elements = b * c * n_trials
        recs[-1]["cluster"], recs[-1]["cta_warps"] = geo.n_cta, geo.warps
        recs[-1]["issue_ms"] = issue["clocks"][issue["pipe"]] * elements / 32 / ISSUE_PER_S * 1e3
        log(f"  wta_counts ({b}, {c}) T={n_trials}: issue estimate of the plain path "
            f"{recs[-1]['issue_ms']:.4f} ms ({issue['instructions']} instructions a "
            f"trial-element, bound by {issue['pipe']}) beside the SFU bound "
            f"{recs[-1]['bound_ms']:.4f} ms")
    recs[0]["issue_instructions"], recs[0]["issue_pipe"] = issue["instructions"], issue["pipe"]
    recs[0]["geometry_device_ms"] = wta_sweep(gen, dev)
    recs[0]["cases"] = [{"case": "(256, 128) T=64", **{a: recs[1][a] for a in
                                                       CASE_KEYS + ("issue_ms", "cluster",
                                                                    "cta_warps")
                                                       if a in recs[1]}}]
    return recs[0], errs


def wta_sweep(gen, dev) -> dict:
    """Device time of the serving head's call (8 x 50304, 32 trials) at
    other launch shapes (the override is for this measurement only), each
    held to the same counts as wta_geometry's pick."""
    from repro_torch.kernels import wta_counts as WTA

    kw = dict(n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    zs = [torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA for _ in range(ROTATE)]
    seed = torch.randint(0, 2**32, (1,), generator=gen, device=dev, dtype=torch.int64)
    want = WTA.wta_counts_cuda(zs[0], seed, **kw)
    out = {}
    for n_cta, warps in ((8, 8), (8, 4), (8, 3), (4, 8), (4, 6), (4, 4), (2, 8), (2, 6), (1, 8)):
        geo = WTA.WtaGeometry(n_cta, warps, -(-50304 // n_cta // 4) * 4)
        if not torch.equal(WTA.wta_counts_cuda(zs[0], seed, **kw, geometry=geo), want):
            raise AssertionError(f"wta_counts: launch shape {geo} changes the counts")
        out[f"{n_cta}x{warps}"] = device_ms(
            [lambda z=z: WTA.wta_counts_cuda(z, seed, **kw, geometry=geo) for z in zs])
    log("  wta_counts (8, 50304) T=32: device ms by CTAs x warps a cluster, counts equal: "
        + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()))
    return out


def sass_of(name: str) -> str:
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu``."""
    import shutil

    from repro_torch.kernels import build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout


def wta_issue_estimate(gen, dev) -> dict:
    """The plain per-element path (one full Box-Muller draw, the voltage,
    the comparator) as ``wta_draw_probe_kernel`` compiles it: its voltages
    held against the plain version's, and its common path counted from
    ``cuobjdump -sass`` (:func:`sass_common_path`, :func:`issue_estimate`)."""
    from repro_torch.kernels import prng
    from repro_torch.kernels import wta_counts as WTA

    n, seed = 1 << 20, 20241216
    z = torch.randn((1, n), generator=gen, device=dev) * WTA_SIGMA
    got = WTA.draw_probe(z, torch.tensor([seed], device=dev), n_trials=1, vth0=WTA_VTH0,
                         sigma_z=WTA_SIGMA).reshape(1, n)
    idx = torch.arange(n, device=dev, dtype=torch.int64)   # row 0, trial 0: counter = column
    v = z + prng.gaussian(idx, seed) * torch.tensor(WTA_SIGMA, device=dev)
    want = torch.where(v > WTA_VTH0, v, torch.full_like(v, -float("inf")))
    equal = float((got == want).float().mean())
    log(f"  wta draw probe ({n} elements): {equal:.6f} bit-equal to the plain version's voltages")
    if equal < 1 - WTA_FLIP_FRACTION:
        raise AssertionError("wta draw probe disagrees with the plain version")
    est = issue_estimate(sass_common_path(sass_of("wta_counts"),
                                          "_ZN4raca21wta_draw_probe_kernelEPKfPfijjjff"))
    log(f"  wta draw probe SASS: {est['instructions']} instructions on the common path, "
        f"clocks per warp {est['clocks']}, bound by {est['pipe']}")
    return est


def wta_sample_case(gen, dev, n, c, dtype, *, layout, read=0, steps=True):
    """Logits at the serving head's spread, per-slot keys fold_in(base,
    rid) (or one key for the batch), and the fold words the sampler
    passes: the step, after the read index for a redundant read."""
    from repro_torch import random as R

    z = (torch.randn((n, c), generator=gen, device=dev) * 2.5).to(dtype)
    base = R.PRNGKey(int(torch.randint(0, 2**31, (1,), generator=gen, device=dev)))
    if layout == "one key":
        return z, torch.tensor([base] * n, dtype=torch.int64, device=dev), None, (n * c, c)
    keys = torch.tensor([R.fold_in(base, i) for i in range(n)], dtype=torch.int64, device=dev)
    words = [torch.full((n,), read, dtype=torch.int64, device=dev)] if read else []
    if steps:
        words.append(torch.randint(0, 64, (n,), generator=gen, device=dev, dtype=torch.int64))
    folds = torch.stack(words, dim=1) if words else None
    return z, keys, folds, (c, 0)


def check_wta_sample(label, z, keys, folds, layout, n_trials, errs) -> None:
    """The kernel against its plain version: counts and decisions exactly
    equal.  Where they are not, the rows that differ are printed with
    both sides' decisions and votes at them, and the check fails."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_sample as WS

    kw = dict(n_trials=n_trials, vth0=WTA_VTH0, sigma_z=WTA_SIGMA, layout=layout)
    got, got_dec = WS.wta_sample_cuda(z, keys, folds, **kw)
    want, want_dec = ref.wta_trial_counts_ref(z, keys, folds, **kw)
    exact = torch.equal(got, want) and torch.equal(got_dec, want_dec)
    errs.append(float((got - want).abs().max()))
    log(f"  wta_sample {label}: counts and decisions equal {exact}, votes {int(got.sum())} of "
        f"{z.shape[0] * n_trials} trials")
    if not exact:
        rows = sorted({r for r, _ in (got != want).nonzero().tolist()}
                      | set((got_dec != want_dec).nonzero().flatten().tolist()))
        log(f"    rows that differ: {rows[:8]} of {len(rows)}; sum|Δcounts| "
            f"{float((got - want).abs().sum()):.0f}, decisions kernel "
            f"{got_dec[rows[:8]].tolist()} plain {want_dec[rows[:8]].tolist()}")
        for r in rows[:2]:
            cols = (got[r] != want[r]).nonzero().flatten()[:4].tolist()
            log(f"    row {r}, columns {cols}: kernel votes {got[r, cols].tolist()}, plain "
                f"{want[r, cols].tolist()}")
        raise AssertionError(f"wta_sample {label}: kernel and plain version disagree")


def wta_sample_kernels(gen, dev):
    """wta_sample vs its plain version at the serving head (8 x 50304, 32
    trials, bf16 logits, per-slot keys with steps, reads 0-2 of R = 3), the
    first-token sample (1 x 50304, step 0) and wta_trials on the paper's
    10-class head (64 x 10, 100 trials, one key); its draw bit-equal to
    repro_torch.random (a slice printed); its time at the head beside the
    plain version's and the issue estimate of its SASS.  Returns (head
    record, max|err| list)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_sample as WS

    log_ptxas("wta_sample_kernel<bf16>", "wta_sample_kernel<f32>", "wta_sample_probe_kernel")
    wta_sample_draw(gen, dev)
    errs = []
    for read in range(3):
        case = wta_sample_case(gen, dev, 8, 50304, torch.bfloat16, layout="per slot", read=read)
        check_wta_sample(f"(8, 50304) T=32 per-slot keys, step, read {read} of R=3", *case, 32,
                         errs)
    check_wta_sample("(1, 50304) T=32 first token, step 0",
                     *wta_sample_case(gen, dev, 1, 50304, torch.float32, layout="per slot"), 32,
                     errs)
    check_wta_sample("(64, 10) T=100 one key",
                     *wta_sample_case(gen, dev, 64, 10, torch.float32, layout="one key"), 100,
                     errs)
    n, c, t = 8, 50304, 32
    sets = []
    for _ in range(ROTATE):
        z, keys, folds, layout = wta_sample_case(gen, dev, n, c, torch.bfloat16, layout="per slot")
        sets.append((z, keys, folds, dict(n_trials=t, vth0=WTA_VTH0, sigma_z=WTA_SIGMA,
                                          layout=layout)))
    # bytes: bf16 z read, keys and step words read, counts and decisions
    # written; operations: the issue estimate of the timed kernel's SASS
    nbytes = n * c * 2 + n * 3 * 8 + n * c * 4 + n * 4
    issue = wta_sample_issue(sass_of("wta_sample"), "wta_sample_kernel<bf16>", n, c, t, n_folds=1)
    rec = bound_record(nbytes, 0)
    if issue["ms"] > rec["bound_ms"]:
        rec.update(bound_ms=issue["ms"], bound_by="operations")
    rec["flops"] = 32 * issue["instructions"]
    rec = time_kernel(rec, sets, WS.wta_sample_cuda, ref.wta_trial_counts_ref, None,
                      f"wta_sample ({n}, {c}) T={t} bf16")
    rec["issue_ms"], rec["issue_pipe"] = issue["ms"], issue["pipe"]
    rec["issue_instructions"] = issue["column"]
    log(f"  wta_sample ({n}, {c}) T={t}: issue estimate {issue['ms']:.4f} ms (bound by "
        f"{issue['pipe']}); kernel at {issue['ms'] / rec['device_ms']:.2f} of it")
    rec["fcnn_head"] = wta_sample_fcnn_head(gen, dev, errs)
    return rec, errs


def wta_sample_fcnn_head(gen, dev, errs) -> dict:
    """wta_sample at the FCNN's head as ``fcnn_predict_raca`` calls it a
    vote: (1024, 10) f32 drives, one trial, one key (the (N·C, C) layout);
    counts exactly equal to the plain version's, then timed beside its
    byte bound and its SASS issue estimate."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wta_sample as WS

    n, c = FCNN_TEST, 10
    check_wta_sample(f"({n}, {c}) T=1 one key (FCNN head)",
                     *wta_sample_case(gen, dev, n, c, torch.float32, layout="one key"), 1, errs)
    sets = []
    for _ in range(ROTATE):
        z, keys, folds, layout = wta_sample_case(gen, dev, n, c, torch.float32, layout="one key")
        sets.append((z, keys, folds, dict(n_trials=1, vth0=WTA_VTH0, sigma_z=WTA_SIGMA,
                                          layout=layout)))
    # bytes: f32 z and the keys read, counts and decisions written
    rec = bound_record(n * c * 4 + n * 16 + n * c * 4 + n * 4, 0)
    issue = wta_sample_issue(sass_of("wta_sample"), "wta_sample_kernel<f32>", n, c, 1, n_folds=0)
    if issue["ms"] > rec["bound_ms"]:
        rec.update(bound_ms=issue["ms"], bound_by="operations")
    rec["flops"] = 32 * issue["instructions"]
    rec = time_kernel(rec, sets, WS.wta_sample_cuda, ref.wta_trial_counts_ref, None,
                      f"wta_sample ({n}, {c}) T=1 one key (FCNN head)")
    rec["issue_ms"] = issue["ms"]
    return {k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "issue_ms")}


def sigmoid_sample_check(label, acc, bias, beta, key, offset, errs) -> None:
    """The kernel against its plain version: decisions exactly equal, and
    its draw (the probe: bits, uniforms, p) equal to repro_torch.random's
    and torch.sigmoid's.  Differences are printed with their u and p, and
    fail."""
    from repro_torch import random as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigmoid_sample as SS

    m, n = acc.shape
    y = SS.sigmoid_sample_cuda(acc, bias, beta=beta, key=key, offset=offset)
    want = ref.sigmoid_sample_ref(acc, bias, beta=beta, key=key, offset=offset)
    bits, u, p, _ = SS.draw_probe(acc, bias, beta=beta, key=key, offset=offset)
    want_bits = R.random_bits(key, (m, n), acc.device, start=offset, count=m * n).reshape(m, n)
    want_u = R.uniform_from_bits(want_bits, 0.0, 1.0)
    want_p = torch.sigmoid(beta * (acc if bias is None else acc + bias))
    same = [torch.equal(bits, want_bits), torch.equal(u, want_u), torch.equal(p, want_p),
            torch.equal(y, want)]
    errs.append(float((y - want).abs().max()) if y.numel() else 0.0)
    log(f"  sigmoid_sample {label}: bits equal {same[0]}, uniforms {same[1]}, p {same[2]}, "
        f"decisions {same[3]}; {float(y.mean()) if y.numel() else 0:.4f} fire")
    if not all(same):
        for name, a, b in (("decision", y, want), ("p", p, want_p), ("u", u, want_u)):
            at = (a != b).nonzero()[:4].tolist()
            if at:
                log(f"    {name} differs at {at} of {int((a != b).sum())}: kernel "
                    f"{[float(a[i, j]) for i, j in at]}, plain {[float(b[i, j]) for i, j in at]}, "
                    f"u {[float(want_u[i, j]) for i, j in at]}, p {[float(want_p[i, j]) for i, j in at]}")
        raise AssertionError(f"sigmoid_sample {label}: kernel and plain version disagree")


def sigmoid_sample_kernels(gen, dev):
    """sigmoid_sample vs its plain version at the FCNN's hidden layers
    (Fig. 6's (1024, 500) and (1024, 300), the training batch's (128, 500)
    and (128, 300)), an odd (7, 33) and nonzero counter offsets (one across
    the high word), β = 1 and 0.7, with and without a bias; then its time
    at (1024, 500) and (1024, 300) beside its byte bound and the issue
    estimate of its own SASS.  Returns ((1024, 500) record, max|err| list)."""
    from repro_torch import random as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigmoid_sample as SS

    log_ptxas("sigmoid_sample_kernel", "sigmoid_sample_probe_kernel")
    errs = []

    def case(m, n, seed):
        acc = torch.randn((m, n), generator=gen, device=dev) * 4
        return acc, torch.randn((n,), generator=gen, device=dev), R.fold_in(R.PRNGKey(seed), n)

    for m, n, offset in ((1024, 500, 0), (1024, 300, 0), (128, 500, 0), (128, 300, 0),
                         (7, 33, 0), (7, 33, 2**32 - 100), (300, 17, 12345)):
        acc, bias, key = case(m, n, m + offset)
        for beta, b in ((1.0, bias), (0.7, bias), (1.0, None)):
            sigmoid_sample_check(f"({m}, {n}) offset {offset} beta {beta}"
                                 f"{'' if b is not None else ' no bias'}",
                                 acc, b, beta, key, offset, errs)
    sass = sass_of("sigmoid_sample")
    recs = {}
    for m, n in ((FCNN_TEST, 500), (FCNN_TEST, 300)):
        sets = [(*case(m, n, i)[:2], dict(beta=1.0, key=R.fold_in(R.PRNGKey(5), i), offset=0))
                for i in range(ROTATE)]
        # bytes: acc read, the bias read, y written (f32)
        rec = bound_record(m * n * 4 + n * 4 + m * n * 4, 0)
        issue = sigmoid_sample_issue(sass, m, n)
        if issue["ms"] > rec["bound_ms"]:
            rec.update(bound_ms=issue["ms"], bound_by="operations")
        rec["flops"] = 32 * issue["instructions"]
        rec = time_kernel(rec, sets, SS.sigmoid_sample_cuda, ref.sigmoid_sample_ref, None,
                          f"sigmoid_sample ({m}, {n})")
        rec["issue_ms"], rec["issue_pipe"] = issue["ms"], issue["pipe"]
        rec["issue_instructions"] = issue["path"]
        rec["byte_bound_ms"] = (m * n * 8 + n * 4) / HBM_BYTES_PER_S * 1e3
        log(f"  sigmoid_sample ({m}, {n}): issue estimate {issue['ms']:.4f} ms ({issue['path']} "
            f"SASS instructions a warp, bound by {issue['pipe']}), bytes "
            f"{rec['byte_bound_ms']:.4f} ms; kernel at {rec['bound_ms'] / rec['device_ms']:.2f} "
            f"of its bound")
        recs[(m, n)] = rec
    rec = recs[(FCNN_TEST, 500)]
    other = recs[(FCNN_TEST, 300)]
    rec["cases"] = [{"case": f"({FCNN_TEST}, 300)", **{k: other[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "issue_ms")}}]
    return rec, errs


def sigmoid_sample_issue(sass: str, m: int, n: int) -> dict:
    """Issue estimate of one ``sigmoid_sample_kernel`` launch from its own
    SASS: its common path (one element a thread: index, bias, sigmoid,
    hash, uniform, comparator, store) once per warp of the grid."""
    import re

    name = re.search(r"Function : (_ZN4raca21sigmoid_sample_kernel\S*)", sass).group(1)
    path = sass_common_path(sass, name)
    warps = -(-m * n // 256) * 8
    per_warp = issue_estimate(path)
    clocks = {k: warps * v for k, v in per_warp["clocks"].items()}
    pipe = max(clocks, key=clocks.get)
    log(f"  sigmoid_sample_kernel SASS: {len(path)} instructions on the common path "
        f"(clocks a warp {per_warp['clocks']}); ({m}, {n}): {warps} warps, bound by {pipe}")
    return {"path": len(path), "instructions": clocks["issue"], "clocks": clocks, "pipe": pipe,
            "ms": clocks[pipe] / ISSUE_PER_S * 1e3}


def wta_sample_issue(sass: str, kernel: str, n: int, c: int, n_trials: int, *,
                     n_folds: int) -> dict:
    """Issue estimate of one ``wta_sample_kernel`` call from its own SASS:
    per (row, trial) CTA, the scan loop's common path once per warp and
    column stride (one z load, hash, uniform, erf_inv, voltage,
    comparator, best update), each warp's path outside the loops (row
    and counter set-up, warp arg-max, exit), ``n_folds`` passes of the
    fold loop's body per warp, and warp 0's block arg-max and votes once.
    ``kernel`` is the short name ``wta_sample_kernel<bf16>`` or ``<f32>``."""
    from collections import Counter

    mangled = {"wta_sample_kernel<bf16>":
               "_ZN4raca17wta_sample_kernelI13__nv_bfloat16EEvPKT_PKlS6_iPfS7_iixxff",
               "wta_sample_kernel<f32>": "_ZN4raca17wta_sample_kernelIfEEvPKT_PKlS5_iPfS6_iixxff"}
    ins = sass_instructions(sass, mangled[kernel])
    loops = sass_loops(ins)
    has_ffma = [any(ins[k][2].startswith("FFMA") for k in range(h, e + 1)) for h, e in loops]
    scan = [lp for lp, f in zip(loops, has_ffma) if f]
    fold = [lp for lp, f in zip(loops, has_ffma) if not f]
    if len(scan) != 1 or len(fold) != 1:
        raise AssertionError(f"{kernel}: expected one scan loop and one fold loop, got "
                             f"{[(ins[h][0], ins[e][0]) for h, e in loops]}")

    def loads(path):
        return sum(op.startswith("LDG") for op in path)

    column = sass_walk(ins, scan[0][0], loop=scan[0])
    fold_body = sass_walk(ins, fold[0][0], loop=fold[0])
    if loads(column) != 1 or loads(fold_body) < 1:
        raise AssertionError(f"{kernel}: {loads(column)} loads a column stride, "
                             f"{loads(fold_body)} a fold pass")
    warp = sass_walk(ins, 0, first_exit=True)
    tail = sass_walk(ins, 0)[len(warp):]
    threads = min(-(-c // 32) * 32, 1024)
    strides = sum(max(0, -(-(c - 32 * w) // threads)) for w in range(threads // 32))
    per_cta = Counter()
    for path, k in ((column, strides), (warp, threads // 32),
                    (fold_body, threads // 32 * n_folds / loads(fold_body)), (tail, 1)):
        for op in path:
            per_cta[op] += k
    clocks = {p: n * n_trials * v for p, v in pipe_clocks(per_cta).items()}
    pipe = max(clocks, key=clocks.get)
    out = {"column": len(column), "warp": len(warp), "fold": len(fold_body) / loads(fold_body),
           "tail": len(tail), "instructions": clocks["issue"], "clocks": clocks, "pipe": pipe,
           "ms": clocks[pipe] / ISSUE_PER_S * 1e3}
    log(f"  {kernel} SASS: {out['column']} instructions a column stride "
        f"(clocks {pipe_clocks(Counter(column))}), {out['warp']} a warp outside the loops, "
        f"{out['fold']:.0f} a fold, {out['tail']} for warp 0's block arg-max; ({n}, {c}) "
        f"T={n_trials}, {n_folds} fold(s): {strides} column strides a CTA, bound by {pipe}, "
        f"{out['ms']:.4f} ms")
    return out


def wta_sample_draw(gen, dev) -> None:
    """The kernel's draw (``wta_sample_probe_kernel``) over 2**20 counters
    across the high word, against ``repro_torch.random`` on the card: bits,
    uniforms and normals bit-equal (a slice printed)."""
    from repro_torch import random as R
    from repro_torch.kernels import wta_sample as WS

    k, start, key = 1 << 20, 2**32 - (1 << 19), R.fold_in(R.PRNGKey(20241216), 7)
    z = torch.zeros(k, device=dev)
    bits, u, v = WS.draw_probe(z, key, start, vth0=-float("inf"), sigma_z=1.0)
    want_bits = R.random_bits(key, (2**33,), dev, start=start, count=k)
    want_u = R.uniform_from_bits(want_bits, R.NORMAL_LO, 1.0)
    want_n = R.erf_inv(want_u) * R.SQRT2_F32
    same = [torch.equal(bits, want_bits), torch.equal(u, want_u), torch.equal(v, want_n)]
    at = [0, 1, (1 << 19) - 1, 1 << 19]   # the last counter below 2**32, the first above
    log(f"  wta_sample draw over counters [{start}, {start + k}): bits equal {same[0]}, "
        f"uniforms equal {same[1]}, normals equal {same[2]} "
        f"({float((v == want_n).float().mean()):.7f} of them, max|Δ| "
        f"{float((v - want_n).abs().max()):.3e})")
    log(f"    at {at}: bits {bits[at].tolist()} / {want_bits[at].tolist()}, uniforms "
        f"{u[at].tolist()} / {want_u[at].tolist()}, normals {v[at].tolist()} / "
        f"{want_n[at].tolist()} (kernel / plain)")
    if not all(same):
        raise AssertionError("wta_sample draw disagrees with repro_torch.random")


def crossbar_case(gen, dev, m, k, n, *, binarize, binary_x=False, quantize=True,
                  physical=False, sigma=None):
    """Inputs as the analog training path hands them to the kernel: x (M, K)
    f32 (normed activations, or the binary product b_up·b_gate entering
    w_down), W (K, N) a bf16 N(0, 1/K) weight cast to f32 and divided by its
    range scale s (the physical path keeps W as it is), σ the calibrated
    read's 1.702 / s (comparator) or 0.01 (linear) on the card."""
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.kernels import ops

    x = torch.randn((m, k), generator=gen, device=dev)
    if binary_x:
        x = (x > 0.5).float()
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16).float()
    s = ops.range_scale(w)
    if physical:
        w = w / s * 1.2                 # a layer whose weights overrun the clip range
    else:
        w = w / s
    if sigma is None:
        sigma = (torch.tensor(1.702, device=dev) / s) if binarize else torch.full((), 0.01, device=dev)
    dp = calibrate_v_read(DeviceParams(), k)
    kw = dict(binarize=binarize, physical_noise=physical, noise_params=ops._noise_params(dp, k),
              quantize=quantize, qstep=ops._qstep(dp), w_min=dp.w_min, w_max=dp.w_max)
    seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=dev, dtype=torch.int64))
    return x, w.contiguous(), seed, sigma.reshape(()).float(), kw, s


def check_crossbar(label, x, w, seed, sigma, kw, errs):
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ref

    got = CB.crossbar_mac_cuda(x, w, seed, sigma, **kw)
    crossbar_gate(label, x, w, kw, got, ref.crossbar_mac_ref(x, w, seed, sigma, **kw), errs)


def crossbar_gate(label, x, w, kw, got, want, errs):
    """A read's output against its plain version's under the gates above;
    appends max|Δ| to ``errs``."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"crossbar_mac {label}: non-finite output")
    if kw["binarize"]:
        agree = float((got == want).float().mean())
        binary = bool(((got == 0) | (got == 1)).all())
        errs.append(float((got - want).abs().max()))
        log(f"  crossbar_mac {label}: {agree:.6f} of decisions equal (gate {CB_AGREEMENT})")
        if agree < CB_AGREEMENT or not binary:
            raise AssertionError(f"crossbar_mac {label}: kernel disagrees with its plain version")
        return
    worst = linear_err_over_tol(x, w, kw, got, want)
    err = (got - want).abs()
    errs.append(float(err.max()))
    log(f"  crossbar_mac {label}: max|err| {float(err.max()):.3e}, worst err/tol {worst:.3f}")
    if worst > 1.0:
        raise AssertionError(f"crossbar_mac {label}: kernel disagrees with its plain version")


def check_prepass(label, x, w, kw, errs):
    """The prepass against its plain version: x's pieces, the levels and
    (physical noise model) the integer column sums bit-identical; the f32
    row sums, summed in another order, within 2·sqrt(K)·2**-24·Σ|x|.
    Appends max|Δ| over all four outputs to ``errs``."""
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ref

    q = (kw["qstep"], kw["w_min"], kw["w_max"])
    xs, rowsum, ct, colsum = CB.crossbar_prepass_cuda(x, w, *q, physical_noise=kw["physical_noise"])
    xs_p, rowsum_p, ct_p, colsum_p = ref.crossbar_prepass_ref(x, w, *q)
    torch.cuda.synchronize()
    exact = max(float((xs.float() - xs_p).abs().max()), float((ct.float() - ct_p).abs().max()))
    if kw["physical_noise"]:
        exact = max(exact, float((colsum - colsum_p).abs().max()))
    d_row = (rowsum - rowsum_p).abs()
    worst = float((d_row / (2 * x.shape[1] ** 0.5 * 2.0**-24 * x.abs().sum(1)).clamp_min(1e-30)).max())
    errs.append(max(exact, float(d_row.max())))
    log(f"  crossbar prepass {label}: pieces, levels{', column sums' if kw['physical_noise'] else ''} "
        f"max|err| {exact:.3e}; row sums max|err| {float(d_row.max()):.3e}, worst err/tol {worst:.3f}")
    if exact != 0.0 or worst > 1.0 or not torch.isfinite(rowsum).all():
        raise AssertionError(f"crossbar prepass {label}: prepass disagrees with its plain version")


def crossbar_bound(m, k, n):
    """The read's bound as the kernel now does it: three bf16 tensor-core
    passes (3·2·M·K·N over the dense bf16 rate) against its bytes (x and
    W read as f32, out written, once each); and the f32 bound of the same
    product on the CUDA cores, kept beside it."""
    nbytes = 4 * (m * k + k * n + m * n)
    rec = bound_record(nbytes, 3 * 2 * m * k * n)
    rec["f32_bound_ms"] = bound_record(nbytes, 2 * m * k * n, F32_FLOPS_PER_S)["bound_ms"]
    return rec


def one_pass_shares(x, w, seed, sigma_cmp, kw):
    """What fewer passes of x keep: the share of comparator decisions (the
    calibrated read's σ) that the level-domain read with x rounded once to
    bf16 or TF32, or split into two bf16 pieces, shares with the plain
    version; and, for a linear read, the worst error over the linear gate.
    The kernel's own three-piece split is modelled beside them (plain
    PyTorch, f32 sums)."""
    from repro_torch.kernels import ref

    cmp_kw = dict(kw, binarize=True)
    want = ref.crossbar_mac_ref(x, w, seed, sigma_cmp, **cmp_kw)
    out = {}
    for label, pieces, fmt in (("bf16 x1", 1, "bf16"), ("tf32 x1", 1, "tf32"),
                               ("bf16 x2", 2, "bf16"), ("bf16 x3", 3, "bf16")):
        got = ref.crossbar_level_read(x, w, seed, sigma_cmp, pieces=pieces, fmt=fmt, **cmp_kw)
        out[label] = {"decisions_kept": float((got == want).float().mean())}
        if not kw["binarize"]:
            sigma = torch.full((), 0.01, device=x.device)
            lin = ref.crossbar_level_read(x, w, seed, sigma, pieces=pieces, fmt=fmt, **kw)
            out[label]["linear_err_over_tol"] = linear_err_over_tol(
                x, w, kw, lin, ref.crossbar_mac_ref(x, w, seed, sigma, **kw))
        del got
    return out


def linear_err_over_tol(x, w, kw, got, want):
    """Worst |got − want| over the linear gate 2·sqrt(K)·2**-24·Σ|x·Wq|
    (+ 1e-5·|out| with the physical noise model)."""
    from repro_torch.kernels import ref

    wq = ref.crossbar_quantize(w, kw["qstep"], kw["w_min"], kw["w_max"]) if kw["quantize"] else w
    tol = 2 * x.shape[1] ** 0.5 * 2.0**-24 * (x.abs() @ wq.abs())
    if kw["physical_noise"]:
        tol = tol + 1e-5 * want.abs()
    return float(((got - want).abs() / tol.clamp_min(1e-30)).max())


def crossbar_kernels(gen, dev):
    """crossbar_mac vs its plain version at stablelm-3b's training shapes
    (M = 8 x 128 tokens): the 2560² linear reads (wq wk wv wo), the
    2560→6912 comparator reads (w_up, w_gate) and the 6912→2560 linear
    read of the binary hidden layer (w_down); then the odd shape 257 x 513
    x 129 (valid K and the padded noise counter), the physical noise model
    and the serving canary's unquantized (1, 128) x (128, 8) read.  At the
    three training shapes: the prepass against its plain version, the
    GEMM at every compiled tile width held to the read's gates and timed,
    the read's time (prepass + GEMM) and the prepass's alone, and the
    decisions that fewer passes of x would keep.  Returns (2560² read
    record, prepass record, the read's max|err| list, the prepass's)."""
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ref

    errs, prep_errs, recs, preps = [], [], {}, {}
    for label, (m, k, n), opts in (
        ("(1024, 2560) x (2560, 2560) linear", (1024, 2560, 2560), dict(binarize=False)),
        ("(1024, 2560) x (2560, 6912) comparator", (1024, 2560, 6912), dict(binarize=True)),
        ("(1024, 6912) x (6912, 2560) linear", (1024, 6912, 2560),
         dict(binarize=False, binary_x=True)),
    ):
        cases = [crossbar_case(gen, dev, m, k, n, **opts) for _ in range(ROTATE)]
        x, w, seed, sigma, kw, scale = cases[0]
        q = (kw["qstep"], kw["w_min"], kw["w_max"])
        gkw = {a: b for a, b in kw.items() if a != "quantize"}
        want = ref.crossbar_mac_ref(x, w, seed, sigma, **kw)
        crossbar_gate(label, x, w, kw, CB.crossbar_mac_cuda(x, w, seed, sigma, **kw), want, errs)
        check_prepass(label, x, w, kw, prep_errs)
        parts = CB.crossbar_prepass_cuda(x, w, *q)
        for tn in CB.TILE_NS:   # every width the sweep times, held to the gates first
            crossbar_gate(f"{label}, GEMM at tile_n {tn}", x, w, kw,
                          CB.crossbar_gemm_cuda(*parts, k, seed, sigma, **gkw, tile_n=tn),
                          want, errs)
        del parts, want
        rec = time_kernel(
            crossbar_bound(m, k, n), [c[:5] for c in cases],
            CB.crossbar_mac_cuda, ref.crossbar_mac_ref,
            lambda x, w, sd, sg: (lambda: x @ w), f"crossbar_mac {label} (library: product only)",
        )
        prep_args = [(c[0], c[1], *q, {}) for c in cases]
        nbytes = 4 * (m * k + k * n) + 2 * (3 * m + n) * (-(-k // 64) * 64) + 4 * m
        preps[(m, k, n)] = time_kernel(
            bound_record(nbytes, 0), prep_args, CB.crossbar_prepass_cuda,
            ref.crossbar_prepass_ref, None, f"crossbar prepass {label}",
        )
        pre = [CB.crossbar_prepass_cuda(c[0], c[1], *q) + (k, c[2], c[3]) for c in cases]

        def gemm_at(p, tn):
            return lambda: CB.crossbar_gemm_cuda(*p, **gkw, tile_n=tn)

        rec["tile_device_ms"] = {tn: device_ms([gemm_at(p, tn) for p in pre]) for tn in CB.TILE_NS}
        rec["tile_n"] = CB.TILE_N
        rec["gemm_device_ms"] = rec["tile_device_ms"][CB.TILE_N]
        log(f"  crossbar GEMM {label}: device ms {rec['gemm_device_ms']:.4f} at tile_n "
            f"{rec['tile_n']}; by tile_n " + ", ".join(
                f"{tn}: {t:.4f}" for tn, t in rec["tile_device_ms"].items())
            + f"; f32 bound {rec['f32_bound_ms']:.4f} ms")
        del pre
        sigma_cmp = torch.tensor(1.702, device=dev) / scale   # the calibrated comparator
        rec["one_pass"] = one_pass_shares(x, w, seed, sigma_cmp, kw)
        log(f"  crossbar one pass of x, {label}: " + "; ".join(
            f"{name} " + ", ".join(f"{a} {b:.6f}" for a, b in v.items())
            for name, v in rec["one_pass"].items()))
        recs[(m, k, n)] = rec
        del cases
    for b in (False, True):
        tag = "comparator" if b else "linear"
        check_crossbar(f"odd 257 x 513 x 129 {tag}",
                       *crossbar_case(gen, dev, 257, 513, 129, binarize=b)[:5], errs)
        phys = crossbar_case(gen, dev, 192, 640, 200, binarize=b, physical=True)
        check_crossbar(f"physical noise 192 x 640 x 200 {tag}", *phys[:5], errs)
        check_prepass(f"physical noise 192 x 640 x 200 {tag}", phys[0], phys[1], phys[4], prep_errs)
    check_crossbar("canary (1, 128) x (128, 8) unquantized linear",
                   *crossbar_case(gen, dev, 1, 128, 8, binarize=False, quantize=False)[:5], errs)
    rec = recs[(1024, 2560, 2560)]
    rec["cases"] = [
        {"case": f"{m}x{k}x{n}", **{a: r[a] for a in CROSSBAR_KEYS}}
        for (m, k, n), r in recs.items() if (m, k, n) != (1024, 2560, 2560)
    ]
    prep = preps[(1024, 2560, 2560)]
    prep["cases"] = [{"case": f"{m}x{k}x{n}", **{a: r[a] for a in CASE_KEYS if a in r}}
                     for (m, k, n), r in preps.items() if (m, k, n) != (1024, 2560, 2560)]
    return rec, prep, errs, prep_errs


CROSSBAR_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "f32_bound_ms", "gemm_device_ms", "tile_n", "tile_device_ms", "one_pass")


# ---------------------------------------------------------------------------
# Phase 4: serve stablelm-3b at full width.
# ---------------------------------------------------------------------------


def serve_trace(vocab: int) -> list[list[int]]:
    """12 prompts of 16-300 tokens: four share a 128-token prefix (one cold,
    three partial hits), a 120-token prompt repeats at once (full hit that
    forks its unaligned boundary block copy-on-write), six are unrelated."""
    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(0, vocab, n).tolist()  # noqa: E731
    prefix, y = tok(128), tok(120)
    a = prefix + tok(72)
    prompts = [y, y, a, prefix + tok(72)]
    prompts += [tok(int(n)) for n in rng.integers(16, 301, 4)]
    prompts += [prefix + tok(72), a]
    prompts += [tok(int(n)) for n in rng.integers(16, 301, 2)]
    return prompts


def serve_phase(dev, w_invariant: bool) -> dict:
    """The 12-request trace at full width with a bf16 pool, then with an
    int8 pool, then with WTA sampling on the bf16 pool
    (``ServeConfig(seed=0)``) at one read and at three redundant reads a
    token, from the same weights; then the degraded serve and phase 4c
    (preemption and chaos; ``w_invariant``: phase 3's finding for the bf16
    decode kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    cfg = get_config("stablelm-3b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  init stablelm-3b ({cfg.n_layers}L d{cfg.d_model} H{cfg.n_heads} Dh{cfg.head_dim} "
        f"ff{cfg.d_ff} V{cfg.vocab} {cfg.dtype}) in {time.perf_counter() - t0:.1f} s")
    prompts = serve_trace(cfg.vocab)
    serve_warm_up(params, cfg, prompts, dev)
    res = {}
    for kv in ("same", "int8"):
        res[kv] = serve_once(params, dataclasses.replace(cfg, kv_cache_dtype=kv), prompts, dev)
    res["wta"] = serve_once(params, dataclasses.replace(cfg, wta_head=True), prompts, dev)
    res["wta_r3"] = serve_once(params, dataclasses.replace(cfg, wta_head=True), prompts, dev,
                               reads=3)
    res["degraded"] = degraded_phase(params, dataclasses.replace(cfg, wta_head=True), prompts,
                                     dev, res["wta"])
    log("== 4c: preemption with KV spill to host, deadlines and chaos (stablelm-3b, compiled)")
    res["preempt"] = preempt_phase(params, cfg, prompts, dev, res, w_invariant)
    log("== 4d: self-speculative decoding (stablelm-3b, compiled: one graph per (W, k))")
    res["spec"] = spec_phase(params, cfg, prompts, dev, res)
    same, int8 = res["same"]["outs"], res["int8"]["outs"]
    agree = sum(a == b for r in same for a, b in zip(same[r], int8[r]))
    total = sum(len(o) for o in same.values())
    log(f"  int8 vs bf16 pool greedy agreement: {agree}/{total} = {agree / total:.4f} "
        f"(random weights; not gated)")
    res["turns"] = tick_turns(params, cfg, dev)
    wta = res["wta"]["outs"]
    agree = sum(a == b for r in same for a, b in zip(same[r], wta[r]))
    log(f"  WTA vs greedy tokens: {agree}/{total} equal (random weights, near-flat logits: "
        f"WTA samples, so few should match)")
    if agree == total:
        raise AssertionError("the WTA serve emitted the greedy tokens: the sampler did not draw")
    r3 = res["wta_r3"]["outs"]
    agree = sum(a == b for r in wta for a, b in zip(wta[r], r3[r]))
    log(f"  WTA R=3 vs R=1 tokens: {agree}/{total} equal (the majority of three reads, read 0 "
        f"being R=1's; not gated)")
    return res


def serve_warm_up(params, cfg, prompts, dev) -> None:
    """Two requests through a compiled and an eager engine, untimed: the
    process's first model run pays one-time costs (cuBLAS handles and
    heuristics, lazy module loads, the first capture) that would
    otherwise land on the first measured run, the compiled bf16 one."""
    from repro_torch.serving import ServeConfig, ServingEngine

    t0 = time.perf_counter()
    for graphs in (True, False):
        eng = ServingEngine(params, cfg, ServeConfig(max_batch=8, max_len=512, kv_block_size=16,
                                                     prefill_chunk=128, max_new_tokens=8),
                            device=dev, graphs=graphs)
        for p in prompts[:2]:
            eng.submit(p)
        eng.run()
        del eng
    torch.cuda.empty_cache()
    log(f"  warm-up (2 requests, compiled and eager) in {time.perf_counter() - t0:.2f} s")


def tick_turns(params, cfg, dev, n_ticks: int = 5, rounds: int = 10) -> dict:
    """Host ms per full-batch decode tick in turns within one process (no
    profiler): six engines on the same weights, greedy and WTA sampling,
    each with the compiled step (CUDA graphs) and eagerly, and WTA compiled
    on the zero-knob ``sim_faulty`` backend with the canary off and on
    every tick, taking turns in an order that rotates every round; 8 slots
    at positions ≈ 128-230, each tick ending in the engine's own sync.  Host time moves between calls
    and phases, so only turns compare them.  Then the sampler alone,
    ``specs.sample_tokens`` on the engine's (8, 50304) bf16 logits with
    per-slot keys and steps against its greedy argmax: ms per call over 200
    calls ending in one sync, in turns, and at three redundant reads."""
    from repro_torch.launch import specs as SP
    from repro_torch.serving import ServeConfig, ServingEngine

    rng = np.random.default_rng(2)
    engines = {}
    wcfg = dataclasses.replace(cfg, wta_head=True)
    faulty = dict(device_backend="sim_faulty")
    for name, c, graphs, extra in (
            ("greedy", cfg, True, {}), ("wta", wcfg, True, {}),
            ("greedy eager", cfg, False, {}), ("wta eager", wcfg, False, {}),
            ("wta faulty", wcfg, True, faulty),
            ("wta faulty canary", wcfg, True, dict(faulty, canary_interval=1))):
        eng = ServingEngine(params, c, ServeConfig(max_batch=8, max_len=512, kv_block_size=16,
                                                   prefill_chunk=128, seed=0, **extra),
                            device=dev, graphs=graphs)
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab, 100).tolist(),
                       max_new_tokens=2 * rounds * n_ticks + 4)
        while eng._job_fifo or eng.sched.queued():
            eng.tick()
        eng.tick()
        engines[name] = eng
    torch.cuda.synchronize()
    names = list(engines)
    ms = {k: [] for k in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            eng = engines[name]
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                eng.tick()
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_ticks)
    out = {k: float(np.median(v)) for k, v in ms.items()}
    for name in names:
        log(f"  host ms per full-batch tick in turns ({rounds} x {n_ticks} ticks), {name}: "
            f"{[round(x, 2) for x in ms[name]]} (median {out[name]:.2f})")
    for name in ("greedy", "wta", "wta faulty", "wta faulty canary"):
        assert engines[name].compile_counts()["serve_step"] == 1, engines[name].compile_counts()
        assert engines[name]._rebuilds == 0
    probes = engines["wta faulty canary"].metrics()
    log(f"  canary every tick: {probes.canary_probes} probes, {probes.canary_failures} failed; "
        f"host ms a tick, medians: canary on {out['wta faulty canary']:.2f}, off "
        f"{out['wta faulty']:.2f} (sim_faulty, zero knobs), sim {out['wta']:.2f}")
    assert probes.canary_probes > 0 and probes.canary_failures == 0
    del engines
    torch.cuda.empty_cache()
    logits = (torch.randn((8, cfg.vocab), device=dev) * 2.5).to(torch.bfloat16)
    keys = torch.randint(0, 2**32, (8, 2), device=dev, dtype=torch.int64)
    steps = torch.arange(8, device=dev, dtype=torch.int64)
    calls = {"greedy": lambda: SP.sample_tokens(cfg, logits),
             "wta": lambda: SP.sample_tokens(wcfg, logits, keys, steps),
             "wta R=3": lambda: SP.sample_tokens(wcfg, logits, keys, steps, n_redundant=3)}
    per_call = {"greedy": [], "wta": [], "wta R=3": []}
    for name in ("greedy", "wta", "wta R=3", "wta R=3", "wta", "greedy"):
        calls[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            calls[name]()
        torch.cuda.synchronize()
        per_call[name].append((time.perf_counter() - t0) * 1e3 / 200)
    log(f"  sample_tokens (8, {cfg.vocab}) bf16, ms per call in turns (200 calls, one sync): "
        f"greedy {[round(x, 4) for x in per_call['greedy']]}, WTA "
        f"{[round(x, 4) for x in per_call['wta']]}, WTA R=3 "
        f"{[round(x, 4) for x in per_call['wta R=3']]}")
    return {"runs": ms, "median": out, "sample_tokens_ms": per_call}


def serve_once(params, cfg, prompts, dev, reads: int = 1) -> dict:
    """The trace through the compiled engine (CUDA graphs, the default on
    the card), its launch counts, captures and ``compile_counts()``, a
    profile of its decode ticks; then the same trace eagerly
    (``graphs=False``), whose streams and launch counts must be the
    same, and its profile."""
    kv = cfg.kv_cache_dtype
    log(f"  -- kv pool: {'int8 codes + f32 scales' if kv == 'int8' else cfg.dtype}, "
        f"{f'WTA (R={reads})' if cfg.wta_head else 'greedy'} sampling")
    runs = {mode: serve_run(params, cfg, prompts, dev, reads, graphs=mode == "graphs")
            for mode in ("graphs", "eager")}
    g, e = runs["graphs"], runs["eager"]
    diverged = [(r, next((i for i, (a, b) in enumerate(zip(g["outs"][r], e["outs"][r])) if a != b),
                         min(len(g["outs"][r]), len(e["outs"][r]))))
                for r in sorted(g["outs"]) if g["outs"][r] != e["outs"].get(r)]
    for r, i in diverged:
        log(f"  request {r}: graph and eager streams differ at token {i}: graphs "
            f"{g['outs'][r][max(i - 2, 0):i + 3]}, eager {e['outs'][r][max(i - 2, 0):i + 3]}")
    if diverged or sorted(g["outs"]) != sorted(e["outs"]):
        raise AssertionError(f"graph and eager streams differ in {len(diverged)} requests")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"replay-aware launch counts {g['launches']} differ from eager "
                             f"mode's {e['launches']}")
    n_tok = sum(len(o) for o in g["outs"].values())
    log(f"  graphs = eager: {len(g['outs'])} streams, {n_tok} tokens equal, launch counts equal; "
        f"tok/s {g['metrics']['tokens_per_s']:.1f} vs {e['metrics']['tokens_per_s']:.1f}, "
        f"decode step ms {g['decode_step_ms']:.2f} vs {e['decode_step_ms']:.2f}, TTFT mean ms "
        f"{g['metrics']['ttft_mean'] * 1e3:.1f} vs {e['metrics']['ttft_mean'] * 1e3:.1f}; "
        f"profiled tick host ms {g['profile']['host_ms']:.2f} vs {e['profile']['host_ms']:.2f}, "
        f"kernels {g['profile']['kernels']:.0f} vs {e['profile']['kernels']:.0f}, device busy "
        f"{g['profile']['busy']:.1%} vs {e['profile']['busy']:.1%}")
    out = dict(g)
    out["eager"] = {k: e[k] for k in ("metrics", "wall_s", "decode_step_ms", "profile")}
    return out


def serve_run(params, cfg, prompts, dev, reads: int, graphs: bool) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.serving import ServeConfig, ServingEngine

    scfg = ServeConfig(
        max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128,
        max_new_tokens=32, prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0,
        n_redundant_reads=reads,
    )
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev, graphs=graphs)
    for p in prompts:
        eng.submit(p)
    # the counters count graph replays too (each entry adds what its
    # capture counted, ops.add_launches)
    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode": PA.launches, "prefill": PF.launches, "stoch_round": SR.launches,
                "write_kv_int8": SR.write_launches, "wta_sample": WS.launches}
    m = eng.metrics()
    mode = "graphs" if graphs else "eager"
    log(f"  [{mode}] served {m.completed} requests, {m.total_tokens} tokens in {wall:.2f} s: "
        f"{m.tokens_per_s:.1f} tok/s, TTFT mean {m.ttft_mean * 1e3:.1f} ms p99 "
        f"{m.ttft_p99 * 1e3:.1f} ms, decode step {m.decode_step_ms:.2f} ms over "
        f"{m.decode_steps} steps, occupancy {m.occupancy_mean:.2f}")
    chunks = launches["prefill"] // cfg.n_layers
    log(f"  [{mode}] prefix hits {m.prefix_hits}, partial hits {m.prefix_partial_hits}, cow forks "
        f"{m.cow_forks}, prefill tokens {m.prefill_tokens} (saved {m.prefill_tokens_saved}), "
        f"launches decode {launches['decode']} prefill {launches['prefill']} write_kv_int8 "
        f"{launches['write_kv_int8']} stoch_round {launches['stoch_round']} wta_sample "
        f"{launches['wta_sample']} (per decode step: attention "
        f"{launches['decode'] / max(m.decode_steps, 1):.1f}; {chunks} prefill chunks)")
    counts = eng.compile_counts()
    captures = eng._decode.captures()
    log(f"  [{mode}] compile_counts {counts}; captures {len(captures)}: "
        + ", ".join(f"(W={w}, R={r}) {ms:.1f} ms" for (w, r), ms in captures))
    assert sorted(outs) == list(range(len(prompts))), "requests lost"
    assert all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o) for o in outs.values())
    assert m.evictions == {"length": len(prompts)}, m.evictions
    assert m.prefix_hits >= 1 and m.prefix_partial_hits >= 2 and m.cow_forks >= 1
    assert launches["decode"] > 0 and launches["prefill"] > 0, launches
    assert launches["stoch_round"] == 0, launches   # the fused write does the rounding
    if cfg.kv_cache_dtype == "int8":
        assert eng._cache["k_pages"].dtype == torch.int8
        # one fused K/V write beside every attention launch
        assert launches["write_kv_int8"] == launches["decode"] + launches["prefill"] > 0, launches
    else:
        assert launches["write_kv_int8"] == 0, launches
    # WTA: one launch per read and decode step, one per request's first token
    want = reads * m.decode_steps + len(prompts) if cfg.wta_head else 0
    assert launches["wta_sample"] == want, (launches, want)
    assert launches["decode"] == cfg.n_layers * m.decode_steps, launches
    # one entry per (window width, R), captured on the card, none per tick
    assert len(captures) == (counts["serve_step"] if graphs else 0), (captures, counts)
    assert all(r == reads for _, r in eng._decode.entries)
    assert m.decode_steps > counts["serve_step"], counts
    prof = profile_decode(eng, cfg.vocab, mode)
    if graphs:
        prof["graph_nodes"] = graph_nodes(eng)
    torch.cuda.synchronize()
    mem = {"serving_gib": (torch.cuda.memory_allocated() - mem0) / 2**30,
           "pool_gib": sum(t.numel() * t.element_size() for t in eng._cache.values()) / 2**30}
    del eng
    torch.cuda.empty_cache()
    mem["left_mib"] = (torch.cuda.memory_allocated() - mem0) / 2**20
    log(f"  [{mode}] device memory: {mem['serving_gib']:.3f} GiB held by the engine after the "
        f"run and profile (its KV pool {mem['pool_gib']:.3f} GiB), {mem['left_mib']:.1f} MiB "
        f"left once it is dropped")
    # a dropped engine leaves nothing behind (no reference cycle, no
    # per-capture stream whose cuBLAS workspace would outlive it)
    assert mem["left_mib"] < 32, mem
    return {"launches": launches, "metrics": dataclasses.asdict(m), "wall_s": wall, "outs": outs,
            "profile": prof, "decode_step_ms": m.decode_step_ms, "compile_counts": counts,
            "memory": mem,
            "captures": [[list(k), ms] for k, ms in captures]}


# The degraded serve's fault schedule: the comparator offset the canary
# must catch, injected at tick DEGRADE_TICK and taken back at RECOVER_TICK
DEGRADE_TICK, RECOVER_TICK, DEGRADE_OFFSET = 4, 16, 3.0


def degraded_phase(params, cfg, prompts, dev, sim_wta: dict) -> dict:
    """The trace with WTA sampling through the compiled engine on the
    ``sim_faulty`` backend, twice.  (a) Every knob at zero: the ``sim``
    WTA serve's stream token for token (``sim_wta``), and analog counts
    that equal ``tokens_computed × per-token counts`` (and the other
    per-event counts) exactly and equal the ``sim`` run's.  (b) The
    ladder: the canary every tick, ``DegradationPolicy(trip_after=2,
    recover_after=2)``, ``degrade_device(comparator_offset=3)`` at tick 4
    and ``recover_device`` at tick 16, then idle ticks until level 0: the
    ladder must reach level 2 (R = 3 captured) and come back, the canary's
    ``crossbar_mac`` launches must equal its probes, re-reads must be
    priced, every request must end with a typed reason, and the tokens
    published before tick 4 must be (a)'s.  Both print the Table I
    model's energy per published token."""
    from repro_torch.core import cost_model as CM

    res = {"zero": degraded_run(params, cfg, prompts, dev, ladder=False),
           "ladder": degraded_run(params, cfg, prompts, dev, ladder=True)}
    zero, ladder = res["zero"], res["ladder"]
    diverged = [r for r in sorted(sim_wta["outs"]) if zero["outs"].get(r) != sim_wta["outs"][r]]
    for r in diverged:
        i = next((i for i, (a, b) in enumerate(zip(zero["outs"][r], sim_wta["outs"][r]))
                  if a != b), 0)
        log(f"  request {r}: zero-knob sim_faulty and sim streams differ at token {i}: "
            f"{zero['outs'][r][max(i - 2, 0):i + 3]} vs {sim_wta['outs'][r][max(i - 2, 0):i + 3]}")
    if diverged or sorted(zero["outs"]) != sorted(sim_wta["outs"]):
        raise AssertionError(f"zero-knob sim_faulty stream differs from sim's in {len(diverged)} "
                             f"requests")
    a = zero["analog"]
    want = (CM.AnalogOpCounts.from_dict(a["per_token_counts"]).scaled(a["tokens_computed"]["total"])
            + CM.AnalogOpCounts.from_dict(a["per_sample_counts"]).scaled(a["sample_events"])
            + CM.AnalogOpCounts.from_dict(a["per_kv_token_counts"]).scaled(a["kv_written_tokens"])
            + CM.AnalogOpCounts.from_dict(a["per_redundant_counts"]).scaled(
                a["redundant_read_events"]))
    sim_a = sim_wta["metrics"]["analog"]
    log(f"  (a) zero knobs: stream = sim's ({sum(map(len, zero['outs'].values()))} tokens); "
        f"counts = tokens x per-event counts {want.as_dict() == a['counts']}, = sim's "
        f"{a['counts'] == sim_a['counts']}; tokens computed {a['tokens_computed']}")
    if want.as_dict() != a["counts"] or a["counts"] != sim_a["counts"] \
            or a["tokens_computed"] != sim_a["tokens_computed"]:
        raise AssertionError("zero-knob sim_faulty accounting differs from its shape counts or sim's")
    if zero["rebuilds"] != 0:
        raise AssertionError(f"zero knobs rebuilt {zero['rebuilds']} times")
    before = [e for tick in ladder["per_tick"][:DEGRADE_TICK] for e in tick]
    if before != [e for tick in zero["per_tick"][:DEGRADE_TICK] for e in tick]:
        raise AssertionError(f"the ladder run published other tokens than (a) before tick "
                             f"{DEGRADE_TICK}")
    log(f"  (b) the {len(before)} tokens published in ticks 0-{DEGRADE_TICK - 1} equal (a)'s")
    for name, r in res.items():
        for scheme, label in (("raca", "RACA"), ("adc1b", "1-bit ADC")):
            e = r["analog"][scheme]
            log(f"  ({name}) Table I model, not measured: {label} "
                f"{e['energy_pj_per_token']:.6e} pJ per published token "
                f"({e['energy_pj_gross']:.6e} pJ gross), {e['tops_per_w_effective']:.4f} TOPS/W")
    return res


def degraded_run(params, cfg, prompts, dev, *, ladder: bool) -> dict:
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ops as KOPS
    from repro_torch.serving import DegradationPolicy, FaultInjector, ServeConfig, ServingEngine

    extra = {}
    if ladder:
        inj = (FaultInjector()
               .at(DEGRADE_TICK, "degrade_device", comparator_offset=DEGRADE_OFFSET)
               .at(RECOVER_TICK, "recover_device"))
        extra = dict(canary_interval=1, fault_injector=inj,
                     degradation=DegradationPolicy(trip_after=2, recover_after=2))
    scfg = ServeConfig(
        max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128, max_new_tokens=32,
        prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0, device_backend="sim_faulty",
        **extra,
    )
    tag = "(b) ladder" if ladder else "(a) zero knobs"
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev)
    for p in prompts:
        eng.submit(p)
    per_tick, rebuild_mem = [], []
    CB.launches = CB.prepass_launches = 0
    before = KOPS.launch_counts()
    t0 = time.perf_counter()
    while eng.sched.has_work() or (ladder and eng._degrade_level and len(per_tick) < 200):
        n = eng._rebuilds
        if n == 0:
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
        per_tick.append(eng.tick())
        if eng._rebuilds != n:
            torch.cuda.synchronize()
            rebuild_mem.append((eng._ticks, (torch.cuda.memory_allocated() - mem_before) / 2**20))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = KOPS.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    m = eng.metrics()
    outs = {r.rid: r.output for r in eng.sched.all_requests()}
    reasons = {r.rid: r.done_reason for r in eng.sched.all_requests()}
    log(f"  {tag}: {m.completed} requests, {m.total_tokens} tokens, {len(per_tick)} ticks in "
        f"{wall:.2f} s; decode steps {m.decode_steps}; evictions {m.evictions}; launches {launches}")
    log(f"  {tag}: canary {m.canary_failures}/{m.canary_probes} failed, redundant reads "
        f"{m.redundant_read_events}, degraded_mode {m.degraded_mode}, compile_counts "
        f"{eng.compile_counts()}")
    for t in m.degraded_transitions:
        log(f"  {tag}: transition at tick {t['tick']}: level {t['from']} -> {t['to']} ({t['why']})")
    captures = eng.capture_log()
    log(f"  {tag}: graph rebuilds {eng._rebuilds}; captures {len(captures)}: " + ", ".join(
        f"[gen {g}] (W={w}, R={r}) {ms:.1f} ms" for g, (w, r), ms in captures))
    log(f"  {tag}: device memory after each rebuild tick, over the tick before the first: "
        + (", ".join(f"tick {t}: {mib:+.1f} MiB" for t, mib in rebuild_mem) or "no rebuild"))
    assert sorted(outs) == list(range(len(prompts))), "requests lost"
    assert all(reasons[r] in ("length", "eos") for r in outs), reasons   # typed, no eviction
    assert all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o) for o in outs.values())
    assert all(mib < 32 for _, mib in rebuild_mem), rebuild_mem
    if ladder:
        levels = [t["to"] for t in m.degraded_transitions]
        whys = {t["why"] for t in m.degraded_transitions}
        assert levels and max(levels) >= 2 and levels[-1] == 0 and m.degraded_mode == 0, levels
        assert whys == {"fault_pressure", "canary_recovered"}, whys
        assert any(r == 3 for _, (_, r), _ in captures), "the R = 3 step was never captured"
        assert eng._rebuilds == 2 and any(g >= 1 for g, _, _ in captures), captures
        # the canary is the serving path's only crossbar read: one launch a probe
        assert CB.launches == m.canary_probes > 0 and CB.prepass_launches == 0, \
            (CB.launches, m.canary_probes)
        assert 0 < m.canary_failures < m.canary_probes
        assert m.redundant_read_events > 0
    else:
        assert m.canary_probes == 0 and CB.launches == 0 and not m.degraded_transitions
    crossbar, rebuilds = CB.launches, eng._rebuilds
    del eng
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - mem0) / 2**20
    log(f"  {tag}: {left:.1f} MiB left once the engine is dropped")
    assert left < 32, left
    return {"outs": outs, "per_tick": per_tick, "analog": m.analog, "rebuilds": rebuilds,
            "crossbar_launches": crossbar}


# ---------------------------------------------------------------------------
# Phase 4c: preemption with KV spill to host, deadlines and chaos.
# ---------------------------------------------------------------------------

# Runs (a)-(c): requests 0-7 at priority 1, then 8-11 at priority 0 once
# PREEMPT_ARRIVE ticks have run, and two forced preempts at tick
# PREEMPT_FORCE_TICK.  Run (d): a prefill killed at tick 1, a NaN page at
# tick 5, a deadline storm at tick 20; the killed job's sharers get
# CHAOS_SHARER_TOKENS tokens, so that they finish before the storm.
PREEMPT_ARRIVE, PREEMPT_FORCE_TICK = 7, 16
CHAOS_KILL_TICK, CHAOS_NAN_TICK, CHAOS_STORM_TICK, CHAOS_SHARER_TOKENS = 1, 5, 20, 8


def preempt_serve_config(prompts, **kw):
    """Phase 4's ``ServeConfig`` with ``num_kv_blocks`` cut to half the
    trace's reservations (bucket + 32 tokens a request, no sharing), plus
    the trash page."""
    from repro_torch.serving import ServeConfig

    base = dict(max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128,
                max_new_tokens=32, prefill_buckets=(32, 64, 120, 128, 200, 256, 320), seed=0)
    scfg = ServeConfig(**base)
    total = sum(-(-(next(b for b in scfg.buckets() if b >= len(p)) + scfg.max_new_tokens)
                  // scfg.kv_block_size) for p in prompts)
    return ServeConfig(**dict(base, num_kv_blocks=total // 2 + 1, **kw)), total


def spill_record_bytes(cfg, scfg) -> int:
    """One fixed-width spill record: both pool leaves at ``max_kv_blocks()``
    pages (an int8 pool's codes and f32 scale planes) and ``pos``."""
    rows = cfg.n_layers * scfg.max_kv_blocks() * scfg.kv_block_size * cfg.n_kv_heads
    if cfg.kv_cache_dtype == "int8":
        return 2 * rows * (cfg.head_dim + 4) + 4
    return 2 * rows * cfg.head_dim * torch.finfo(getattr(torch, cfg.dtype)).bits // 8 + 4


class SpillTimer:
    """Wraps the engine class's spill, restore and poison for one run (and
    puts them back): each spill's bytes and ms (its gather and the
    device-to-host copies, which end in a sync), each restore's ms (synced
    on both sides: its host-to-device copies are asynchronous), and the
    captures each restore or poison added (must be none)."""

    NAMES = ("_preempt", "_store_spill", "_restore_one", "_poison_nan")

    def __init__(self):
        self.spills, self.restores, self.captures = [], [], []

    def __enter__(self):
        from repro_torch.serving import ServingEngine

        self.cls = ServingEngine
        self.orig = {n: getattr(ServingEngine, n) for n in self.NAMES}
        timer = self

        def timed(name, sync):
            def run(eng, *a):
                n_cap = len(eng.capture_log())
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = timer.orig[name](eng, *a)
                if sync:
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                timer.captures.append((name, len(eng.capture_log()) - n_cap))
                if name == "_preempt":
                    timer.spills[-1]["ms"] = ms
                elif name == "_restore_one":
                    timer.restores.append({"rid": a[0].rid, "ms": ms})
                return out
            return run

        def store(eng, rid, rec):
            self.spills.append({"rid": rid, "bytes": eng._spill_nbytes(rec)})
            return self.orig["_store_spill"](eng, rid, rec)

        ServingEngine._preempt = timed("_preempt", sync=True)
        ServingEngine._restore_one = timed("_restore_one", sync=True)
        ServingEngine._poison_nan = timed("_poison_nan", sync=False)
        ServingEngine._store_spill = store
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.cls, n, f)


def preempt_run(params, cfg, prompts, dev, scfg, tag: str, *, arrivals, budgets=None,
                injector=None) -> dict:
    """One phase 4c serve: ``arrivals`` maps a tick to the (rid, priority)
    submitted before it (rids are prompt indices, submitted in order);
    ``budgets`` optional per-rid token budgets.  Returns streams, done
    reasons, per-tick host ms and whether the tick preempted, spills and
    restores, compile counts, launches (reset just before, read just
    after) and memory."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.serving import ServingEngine

    if injector is not None:
        scfg = dataclasses.replace(scfg, fault_injector=injector)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev)
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    ticks, pending = [], dict(arrivals)
    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0
    with SpillTimer() as timer:
        t_run = time.perf_counter()
        while pending or eng.sched.has_work():
            for rid, prio in pending.pop(len(ticks), ()):
                got = eng.submit(prompts[rid], None if budgets is None else budgets.get(rid),
                                 priority=prio)
                assert got == rid, (got, rid)
            n_pre = eng._preemptions
            t0 = time.perf_counter()
            emitted = eng.tick()
            ticks.append({"ms": (time.perf_counter() - t0) * 1e3, "emitted": emitted,
                          "preempted": eng._preemptions - n_pre})
            assert len(ticks) < 2000, "phase 4c run did not drain"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
    launches = {"decode": PA.launches, "prefill": PF.launches, "write_kv_int8": SR.write_launches,
                "stoch_round": SR.launches, "wta_sample": WS.launches}
    m = eng.metrics()
    reqs = eng.sched.all_requests()
    out = {
        "outs": {r.rid: list(r.output) for r in reqs},
        "reasons": {r.rid: r.done_reason for r in reqs},
        "ticks": ticks, "spills": timer.spills, "restores": timer.restores,
        "restore_captures": sum(n for name, n in timer.captures if name != "_preempt"),
        "preemptions": m.preemptions, "restores_n": m.restores, "spill_drops": m.spill_drops,
        "evictions": m.evictions, "compile_counts": eng.compile_counts(),
        "capture_log": len(eng.capture_log()), "launches": launches, "wall_s": wall,
        "free_blocks": (eng.blocks.available, eng.blocks.capacity),
        "ptrs_kept": ptrs == {k: v.data_ptr() for k, v in eng._cache.items()},
        "spill_left": eng._spill_bytes, "applied": [] if injector is None else list(injector.applied),
    }
    del eng
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - mem0) / 2**20
    pre = [t["ms"] for t in ticks if t["preempted"]]
    rest = [t["ms"] for t in ticks if not t["preempted"]]
    log(f"  ({tag}) {len(ticks)} ticks in {wall:.2f} s; preemptions {m.preemptions}, restores "
        f"{m.restores}, spill drops {m.spill_drops}; done reasons {m.evictions}; launches "
        f"{launches}; compile_counts {out['compile_counts']}; captures {out['capture_log']}")
    for s in timer.spills:
        log(f"  ({tag}) spill of request {s['rid']}: {s['bytes']} bytes "
            f"({s['bytes'] / 2**20:.2f} MiB) in {s['ms']:.2f} ms")
    for r in timer.restores:
        log(f"  ({tag}) restore of request {r['rid']}: {r['ms']:.2f} ms")
    if pre:
        log(f"  ({tag}) host ms a tick: {len(pre)} preempting ticks median "
            f"{float(np.median(pre)):.2f} (max {max(pre):.2f}), the other {len(rest)} median "
            f"{float(np.median(rest)):.2f}")
    log(f"  ({tag}) pool addresses kept {out['ptrs_kept']}; captures by restores or poison "
        f"{out['restore_captures']}; blocks {out['free_blocks'][0]}/{out['free_blocks'][1]} "
        f"free at the end; {out['left_mib']:.1f} MiB left once the engine is dropped")
    return out


def preempt_check(tag: str, run: dict, want: dict, gate: bool,
                  against: str = "phase 4's") -> int:
    """Stream agreement with ``want`` (phase 4's streams, or ``against``),
    token for token, each run's tokens a prefix of that stream; a
    divergence is printed with its rid, position and both tokens.  Raises
    when ``gate``.  Returns the tokens that agree."""
    agree = total = 0
    bad = []
    for r, got in sorted(run["outs"].items()):
        ref = want[r]
        n = sum(a == b for a, b in zip(got, ref))
        agree, total = agree + n, total + len(got)
        if n != len(got):
            i = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
            bad.append(r)
            log(f"  ({tag}) request {r} diverges at token {i}: {got[i]} against {against} "
                f"{ref[i]} ({against} {ref[max(i - 2, 0):i + 3]}, here "
                f"{got[max(i - 2, 0):i + 3]})")
    log(f"  ({tag}) {agree}/{total} tokens equal {against} streams"
        + ("" if gate else " (not gated)"))
    if gate and bad:
        raise AssertionError(f"({tag}) streams differ from phase 4's in requests {bad}")
    return agree


def preempt_invariants(tag: str, run: dict, reasons=("length",)) -> None:
    """What every phase 4c run holds: typed done reasons, the allocator
    back to capacity, the spill store empty, one signature for each
    preemption entry point, the pool's addresses kept, no capture from a
    restore or a poison, and the engine freed."""
    cc = run["compile_counts"]
    assert all(r in reasons for r in run["reasons"].values()), (tag, run["reasons"])
    assert run["free_blocks"][0] == run["free_blocks"][1], (tag, run["free_blocks"])
    assert run["spill_left"] == 0, (tag, run["spill_left"])
    assert run["ptrs_kept"] and run["restore_captures"] == 0, tag
    assert run["left_mib"] < 32, (tag, run["left_mib"])
    assert run["launches"]["decode"] > 0 and run["launches"]["prefill"] > 0, (tag, run["launches"])
    if run["preemptions"]:
        assert cc["page_spill"] == cc["page_restore"] == cc["state_gather"] == 1, (tag, cc)


def preempt_phase(params, cfg, prompts, dev, res: dict, w_invariant: bool) -> dict:
    """Phase 4c at stablelm-3b's full width and depth through the compiled
    engine: (a) priority preemption with a one-record spill budget, greedy
    bf16; (b) the same with WTA sampling; (c) on an int8 pool; (d) chaos,
    bf16 and int8.  With W-invariant decode attention (phase 3) the bf16
    streams are gated against phase 4's; otherwise (a) and (b) are gated on
    an f32 copy of the weights against its own unpreempted serve, and the
    bf16 agreement is printed beside."""
    from repro_torch.serving import FaultInjector

    scfg, total = preempt_serve_config(prompts)
    log(f"  the trace reserves {total} blocks (bucket + 32 tokens each, no sharing); phase 4c's "
        f"pool: num_kv_blocks = {scfg.num_kv_blocks} ({scfg.pool_blocks() - 1} allocatable, "
        f"{scfg.pool_blocks('int8') - 1} with int8)")
    arrivals = {0: [(r, 1) for r in range(8)], PREEMPT_ARRIVE: [(r, 0) for r in range(8, 12)]}

    def force():
        return FaultInjector().at(PREEMPT_FORCE_TICK, "preempt").at(PREEMPT_FORCE_TICK, "preempt")

    out = {}
    wcfg = dataclasses.replace(cfg, wta_head=True)
    icfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    for key, c, want in (("a", cfg, "same"), ("b", wcfg, "wta"), ("c", icfg, "int8")):
        rec = spill_record_bytes(c, scfg)
        run = out[key] = preempt_run(
            params, c, prompts, dev, dataclasses.replace(scfg, spill_budget_bytes=rec),
            f"{key}) {want}", arrivals=arrivals, injector=force())
        preempt_invariants(key, run)
        assert run["preemptions"] >= 3 and run["restores_n"] >= 1 and run["spill_drops"] >= 1, \
            (key, run["preemptions"], run["restores_n"], run["spill_drops"])
        assert all(s["bytes"] == rec for s in run["spills"]), (key, rec, run["spills"])
        assert len(run["applied"]) == 2, run["applied"]
        if key == "b":
            assert run["launches"]["wta_sample"] > 0, run["launches"]
        if key == "c":
            assert run["launches"]["write_kv_int8"] > 0, run["launches"]
        run["agree"] = preempt_check(key, run, res[want]["outs"],
                                     gate=key != "c" and w_invariant)
    log("  (c) int8, not gated: decode writes draw their rounding from the engine-wide "
        "quant_step, so a restored request's later rows round otherwise than in phase 4")
    if not w_invariant:
        out["f32"] = preempt_f32(params, cfg, prompts, dev, scfg, arrivals, force)
    for kv, c in (("same", cfg), ("int8", icfg)):
        out[f"d_{kv}"] = chaos_run(params, c, prompts, dev, scfg, res[kv]["outs"],
                                   gate=kv == "same" and w_invariant)
    return out


def preempt_f32(params, cfg, prompts, dev, scfg, arrivals, force) -> dict:
    """(a) and (b) on an f32 copy of the weights: the unpreempted trace,
    then the preempted one, gated token for token."""
    p32 = tree_float(params)
    out = {}
    for key, c in (("a", cfg), ("b", dataclasses.replace(cfg, wta_head=True))):
        c = dataclasses.replace(c, dtype="float32")
        base = preempt_run(p32, c, prompts, dev, dataclasses.replace(scfg, num_kv_blocks=0),
                           f"{key} f32) unpreempted", arrivals={0: [(r, 1) for r in range(12)]})
        run = preempt_run(p32, c, prompts, dev,
                          dataclasses.replace(scfg, spill_budget_bytes=spill_record_bytes(c, scfg)),
                          f"{key} f32) preempted", arrivals=arrivals, injector=force())
        preempt_invariants(f"{key} f32", run)
        preempt_check(f"{key} f32", run, base["outs"], gate=True, against="the unpreempted f32")
        out[key] = {"preemptions": run["preemptions"], "restores": run["restores_n"],
                    "spill_drops": run["spill_drops"], "spills": run["spills"],
                    "restore_ms": run["restores"]}
    del p32
    torch.cuda.empty_cache()
    return out


def tree_float(tree):
    return {k: tree_float(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def chaos_run(params, cfg, prompts, dev, scfg, want: dict, gate: bool) -> dict:
    """Run (d): every request at once; ``kill_prefill`` at tick 1 (the job
    FIFO's head, mid-prefill), ``nan_logits`` at tick 5 (the first active
    request with a private page), ``deadline_storm`` at tick 20.  The
    killed job ends ``preempted``, the queued jobs that shared its pages
    (budget CHAOS_SHARER_TOKENS) end ``length``, the poisoned request
    ``nan`` (its sanity code ``SANE_NAN`` through the decode kernel), the
    rest ``deadline``; every published token is phase 4's at its index
    (gated on bf16)."""
    from repro_torch.serving import FaultInjector

    kv = cfg.kv_cache_dtype
    # the FIFO head at tick 1 is request 2 (a: the shared prefix and its
    # own suffix, mid-prefill after one chunk); 3, 8 and 9 map its pages
    sharers = {r for r in range(12) if r != 2 and prompts[r][:128] == prompts[2][:128]}
    inj = (FaultInjector().at(CHAOS_KILL_TICK, "kill_prefill").at(CHAOS_NAN_TICK, "nan_logits")
           .at(CHAOS_STORM_TICK, "deadline_storm"))
    run = preempt_run(params, cfg, prompts, dev, scfg, f"d) chaos {kv}",
                      arrivals={0: [(r, 1) for r in range(12)]},
                      budgets={r: CHAOS_SHARER_TOKENS for r in sharers}, injector=inj)
    applied = {k: rid for _, k, rid in run["applied"] if k != "deadline_storm"}
    log(f"  (d {kv}) applied {applied} and deadline_storm at tick {CHAOS_STORM_TICK}; done "
        f"reasons {run['reasons']}")
    killed, victim = applied.get("kill_prefill"), applied.get("nan_logits")
    assert killed is not None and victim is not None, run["applied"]
    assert run["reasons"][killed] == "preempted" and run["outs"][killed] == [], killed
    assert run["reasons"][victim] == "nan", (victim, run["reasons"][victim])
    assert sharers - {killed} and all(run["reasons"][r] == "length" for r in sharers - {killed}), \
        (sharers, run["reasons"])
    rest = set(range(12)) - sharers - {killed, victim}
    assert all(run["reasons"][r] == "deadline" for r in rest), run["reasons"]
    preempt_invariants(f"d {kv}", run, reasons=("length", "preempted", "nan", "deadline"))
    assert run["capture_log"] <= 3, run["capture_log"]   # one graph per window width
    if kv == "int8":
        assert run["launches"]["write_kv_int8"] > 0, run["launches"]
    run["agree"] = preempt_check(f"d {kv}", run, want, gate=gate)
    return run


# ---------------------------------------------------------------------------
# Phase 4d: self-speculative decoding.
# ---------------------------------------------------------------------------

# 4d serves phase 4's trace and ServeConfig with SPEC_NEW_TOKENS tokens a
# request (streams compare with phase 4's first SPEC_NEW_TOKENS); the
# forced preempts of run (e) fire at these ticks
SPEC_NEW_TOKENS = 16
SPEC_PREEMPT_TICKS = (1, 3)


def spec_serve_config(**kw):
    from repro_torch.serving import ServeConfig

    return ServeConfig(**dict(dict(
        max_batch=8, max_len=512, kv_block_size=16, prefill_chunk=128,
        max_new_tokens=SPEC_NEW_TOKENS, prefill_buckets=(32, 64, 120, 128, 200, 256, 320),
        seed=0), **kw))


def spec_probe(params, cfg, prompts, dev, k: int = 4) -> dict:
    """One speculative round's draft and verify logits, kept: eight slots
    decoding (the trace's first eight prompts, prefilled), one round of
    ``specs.make_paged_spec_round`` run eagerly with ``sample_tokens``
    recording the logits it is handed (k draft calls of B rows, then the
    verify's k·B).  Per verify row against the draft row that computed the
    same (slot, position): max|Δlogit|, rows not bit-equal, and rows whose
    greedy argmax or WTA decision (the slot's key, step + j) differs."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.launch import specs as SP
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, spec_serve_config(max_new_tokens=64), device=dev,
                        graphs=False)
    for p in prompts[:8]:
        eng.submit(p)
    while eng._job_fifo or eng.sched.queued():
        eng.tick()
    active = eng.sched.active()
    assert len(active) == 8, len(active)
    b = eng.cfg.max_batch
    eng._cow_pass(active, k)   # as the engine does before every round
    w = eng._window_blocks(active, k)
    pos = eng._host_pos.copy()
    seen = []
    real = SP.sample_tokens

    def keep(c, logits, *a, **kw):
        seen.append(logits)
        return real(c, logits, *a, **kw)

    attn = []   # (q, out) of every decode attention call, in call order
    real_attn = KOPS.paged_attention

    def keep_attn(q, *a, **kw):
        out = real_attn(q, *a, **kw)
        attn.append((q.clone(), out.clone()))
        return out

    keys = torch.as_tensor(eng._req_keys, device=dev)
    steps = torch.as_tensor(eng._steps, device=dev)
    SP.sample_tokens = keep
    KOPS.paged_attention = keep_attn
    try:
        SP.make_paged_spec_round(cfg, k)(
            eng.params, eng._cache,
            torch.as_tensor(np.ascontiguousarray(eng._table[:, :w]), device=dev),
            torch.as_tensor(eng._tokens, device=dev), keys, steps)
    finally:
        SP.sample_tokens = real
        KOPS.paged_attention = real_attn
    wcfg = dataclasses.replace(cfg, wta_head=True)
    draft, verify = torch.stack(seen[:k]), seen[k].reshape(k, b, -1)
    diff = (verify.float() - draft.float()).abs()
    out = {"w": w, "max_abs_diff": float(diff.max()),
           "rows_not_bit_equal": int((diff.amax(dim=-1) > 0).sum()), "rows": k * b,
           "argmax_differ": int((verify.argmax(-1) != draft.argmax(-1)).sum()),
           "wta_differ": sum(int((SP.sample_tokens(wcfg, verify[j], keys, steps + j)
                                  != SP.sample_tokens(wcfg, draft[j], keys, steps + j)).sum())
                             for j in range(k))}
    out["bit_equal"] = out["rows_not_bit_equal"] == 0
    out["differing_rows"] = [(int(s), int(j), int(pos[s]) + int(j)) for j, s in
                             (diff.amax(dim=-1) > 0).nonzero().tolist()]
    # where a differing row first parts from its draft: the first layer
    # whose attention query, then whose attention output, differs
    n = cfg.n_layers
    out["first_layer"] = {}
    for s_, j, _ in out["differing_rows"][:4]:
        pairs = [(attn[j * n + lay], attn[k * n + lay]) for lay in range(n)]
        q_at = next((lay for lay, (d, v) in enumerate(pairs)
                     if not torch.equal(d[0][s_], v[0][j * b + s_])), None)
        o_at = next((lay for lay, (d, v) in enumerate(pairs)
                     if not torch.equal(d[1][s_], v[1][j * b + s_])), None)
        out["first_layer"][(s_, j)] = {"q": q_at, "attention": o_at}
    log(f"  probe {cfg.dtype} weights, {'int8' if cfg.kv_cache_dtype == 'int8' else cfg.dtype} "
        f"pool, k = {k}, W = {w}: verify vs draft rows max|Δlogit| {out['max_abs_diff']:.3e}, "
        f"{out['rows_not_bit_equal']}/{out['rows']} rows not bit-equal, argmax differs in "
        f"{out['argmax_differ']}, WTA decision in {out['wta_differ']}"
        + (f"; (slot, j, position) of rows that differ {out['differing_rows'][:8]}; the "
           f"first layer whose attention query / output differs, by (slot, j) "
           f"{out['first_layer']}" if out["differing_rows"] else ""))
    del eng, seen, draft, verify, diff, attn
    torch.cuda.empty_cache()
    return out


def spec_run(params, cfg, prompts, dev, k: int, tag: str, *, tamper: bool = False,
             injector=None) -> dict:
    """One phase 4d serve through the compiled engine at ``speculate_k = k``
    (every request at once): streams, speculation metrics, launches (reset
    just before, read just after), ``compile_counts()``, round captures and
    their ms, captures made inside rollbacks (must be none), memory.  With
    ``tamper`` every other round reports its drafts at step 1 wrong, after
    the round, as the reference's forced-rejection test does."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.serving import ServingEngine

    scfg = spec_serve_config(speculate_k=k, fault_injector=injector)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(params, cfg, scfg, device=dev)
    ptrs = {n: v.data_ptr() for n, v in eng._cache.items()}
    rb_captures, calls = spec_instrument(eng, tamper)
    for p in prompts:
        eng.submit(p)
    PA.launches = PF.launches = SR.launches = SR.write_launches = WS.launches = 0
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode": PA.launches, "prefill": PF.launches, "stoch_round": SR.launches,
                "write_kv_int8": SR.write_launches, "wta_sample": WS.launches}
    m = eng.metrics()
    counts = eng.compile_counts()
    caps = [(key, ms) for _, key, ms in eng.capture_log()]
    spec_caps = [(key[1:], ms) for key, ms in caps if key[0] == "spec"]
    plain = m.decode_steps - m.spec_rounds
    n = cfg.n_layers
    reqs = eng.sched.all_requests()
    out = {"outs": outs, "reasons": {r.rid: r.done_reason for r in reqs},
           "metrics": {f: getattr(m, f) for f in (
               "spec_rounds", "spec_drafted", "spec_accepted", "spec_acceptance",
               "spec_tokens_per_round", "tokens_per_s", "decode_step_ms", "ttft_mean",
               "ttft_p99", "decode_steps", "total_tokens", "preemptions", "restores")},
           "launches": launches, "compile_counts": counts, "captures": caps, "wall_s": wall,
           "tampered_rounds": calls["n"] // 2, "rollbacks": len(rb_captures),
           "ptrs_kept": ptrs == {n_: v.data_ptr() for n_, v in eng._cache.items()},
           "free_blocks": (eng.blocks.available, eng.blocks.capacity), "plain_ticks": plain}
    del eng
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - mem0) / 2**20
    log(f"  ({tag}) {m.completed} requests, {m.total_tokens} tokens in {wall:.2f} s: "
        f"{m.tokens_per_s:.1f} tok/s, decode step {m.decode_step_ms:.2f} ms over "
        f"{m.decode_steps} steps ({m.spec_rounds} rounds, {plain} plain ticks), TTFT mean "
        f"{m.ttft_mean * 1e3:.1f} ms p99 {m.ttft_p99 * 1e3:.1f} ms; spec drafted "
        f"{m.spec_drafted}, accepted {m.spec_accepted} ({m.spec_acceptance:.4f}), "
        f"{m.spec_tokens_per_round:.2f} tokens a round over all slots; rollbacks "
        f"{len(rb_captures)}"
        + (f", tampered rounds {calls['n'] // 2}" if tamper else "")
        + (f"; preemptions {m.preemptions}, restores {m.restores}"
           if injector is not None else ""))
    log(f"  ({tag}) launches {launches} (decode attention per round "
        f"{(launches['decode'] - n * plain) / max(m.spec_rounds, 1):.1f}); compile_counts "
        f"{counts}; captures " + ", ".join(f"{key} {ms:.1f} ms" for key, ms in caps)
        + f"; {out['left_mib']:.1f} MiB left once the engine is dropped")
    assert sorted(outs) == list(range(len(prompts))), (tag, "requests lost")
    assert all(r == "length" for r in out["reasons"].values()), (tag, out["reasons"])
    assert all(len(o) == SPEC_NEW_TOKENS for o in outs.values()), tag
    assert m.spec_rounds > 0 and m.spec_drafted > 0, tag
    # one captured round per (W, k), never one per tick, none by a rollback
    assert counts["spec_round"] == len(spec_caps) == len({w for (w, _), _ in spec_caps}), tag
    assert all(kk == k for (_, kk), _ in spec_caps), (tag, spec_caps)
    assert m.spec_rounds > counts["spec_round"], (tag, counts)
    assert sum(rb_captures) == 0, (tag, rb_captures)
    assert counts["spec_rollback"] == (1 if rb_captures else 0), (tag, counts)
    # decode attention: one launch a layer for each of the k draft steps
    # and the verify, one a layer for a plain tick
    assert launches["decode"] == n * ((k + 1) * m.spec_rounds + plain), (tag, launches)
    assert launches["prefill"] > 0 and launches["stoch_round"] == 0, (tag, launches)
    if cfg.kv_cache_dtype == "int8":
        # one fused write beside every writing attention launch (the
        # verify writes nothing)
        assert launches["write_kv_int8"] == (launches["decode"] - n * m.spec_rounds
                                             + launches["prefill"]) > 0, (tag, launches)
    else:
        assert launches["write_kv_int8"] == 0, (tag, launches)
    # WTA: one launch a draft step, one a verify, one a plain tick, one a
    # request's first token
    want = (k + 1) * m.spec_rounds + plain + len(prompts) if cfg.wta_head else 0
    assert launches["wta_sample"] == want, (tag, launches, want)
    assert out["ptrs_kept"] and out["free_blocks"][0] == out["free_blocks"][1], tag
    assert out["left_mib"] < 32, (tag, out["left_mib"])
    return out


def spec_instrument(eng, tamper: bool) -> tuple[list, dict]:
    """Count the captures each rollback makes (must be none) and, with
    ``tamper``, report every other round's drafts at step 1 wrong.  The
    wrappers live on the engine alone, so dropping it frees its graphs."""
    rb_captures, calls = [], {"n": 0}
    rollback = eng._spec_rollback.fn
    graphs = [eng._spec_graphs, *eng._serve_steps.values()]   # no rebuild in 4d

    def counted_rollback(*a):
        n = sum(len(g.captures()) for g in graphs)
        out = rollback(*a)
        rb_captures.append(sum(len(g.captures()) for g in graphs) - n)
        return out

    eng._spec_rollback.fn = counted_rollback
    if tamper:
        orig = eng._spec_round

        def tampered(*a):
            d, dok, v, vok, vs = orig(*a)
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                d = d.clone()
                d[:, 1] ^= 1
            return d, dok, v, vok, vs

        eng._spec_round = tampered
    return rb_captures, calls


def batch_width_probe(params, cfg, dev) -> dict:
    """Which of the decode step's operations give a row other bits at 32
    rows (a k = 4 verify of B = 8) than at 8 (its draft), bf16 and f32, at
    full width: the projections (cuBLAS picks its GEMM by M) and the RMS
    norm (PyTorch's reduction picks its launch by the rows)."""
    from repro_torch.models import layers as TL
    from repro_torch.models.transformer import unit_params

    gen = torch.Generator(device=dev).manual_seed(5)
    up = unit_params(params["units"], 0)["l0"]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        x = torch.randn((32, 1, cfg.d_model), generator=gen, device=dev).to(dt)
        h = torch.randn((32, 1, cfg.d_ff), generator=gen, device=dev).to(dt)
        ops = {name: (x, lambda a, w=up["attn"][name]: a @ w.to(dt))
               for name in ("wq", "wk", "wv", "wo")}
        ops.update({name: (x, lambda a, w=up["ffn"][name]: a @ w.to(dt))
                    for name in ("w_up", "w_gate")})
        ops.update({"w_down": (h, lambda a: a @ up["ffn"]["w_down"].to(dt)),
               "logits": (x, lambda a: TL.logits_out(
                   {"embedding": params["embed"]["embedding"].to(dt)}, None, a, cfg)),
                    "rmsnorm": (x, lambda a: TL.rmsnorm(up["ln1"], a, cfg.norm_eps))})
        for name, (a, fn) in ops.items():
            full, part = fn(a)[:8], fn(a[:8])
            out[f"{tag} {name}"] = {"bit_equal": bool(torch.equal(full, part)),
                                    "max_abs_diff": float((full.float() - part.float()).abs().max())}
    log("  batch width 8 against 32 rows, per operation (bit-equal, max|diff|): "
        + ", ".join(f"{k} {v['bit_equal']} {v['max_abs_diff']:.3e}" for k, v in out.items()))
    torch.cuda.empty_cache()
    return out


def spec_turns(params, cfg, dev, n_ticks: int = 3, rounds: int = 6) -> dict:
    """Host ms of a replayed speculative round against a replayed plain
    tick, in turns in one process (no profiler): greedy plain, greedy at
    k = 4, WTA plain and WTA at k = 3, 8 slots at positions ≈ 128 on, each
    tick ending in the engine's own sync; tokens a tick beside."""
    from repro_torch.serving import ServingEngine

    rng = np.random.default_rng(2)
    wcfg = dataclasses.replace(cfg, wta_head=True)
    engines = {}
    for name, c, k in (("greedy", cfg, 0), ("greedy k=4", cfg, 4), ("wta", wcfg, 0),
                       ("wta k=3", wcfg, 3)):
        # default buckets: the 100-token prompts start at 128, and a budget
        # of 120 keeps every round and tick inside W = 16, with all 8 slots
        # decoding to the end of the turns (the first slot drafts during
        # the others' 7 prefill ticks)
        eng = ServingEngine(params, c, spec_serve_config(
            max_new_tokens=120, speculate_k=k, prefill_buckets=()), device=dev)
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab, 100).tolist())
        while eng._job_fifo or eng.sched.queued():
            eng.tick()
        eng.tick()
        engines[name] = eng
    torch.cuda.synchronize()
    names = list(engines)
    ms = {k: [] for k in names}
    toks = {k: 0 for k in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            eng = engines[name]
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                toks[name] += len(eng.tick())
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_ticks)
    out = {"runs": ms, "median": {k: float(np.median(v)) for k, v in ms.items()},
           "tokens_per_tick": {k: toks[k] / (rounds * n_ticks) for k in names}}
    out["gap_ms"] = {k: out["median"][k] * 8 / max(out["tokens_per_tick"][k], 1e-9)
                     for k in names}
    assert all(len(e.sched.active()) == 8 for e in engines.values()), "a slot finished"
    for name in names:
        eng = engines[name]
        log(f"  host ms a replayed {'round' if 'k=' in name else 'tick'} in turns "
            f"({rounds} x {n_ticks}), {name}: {[round(x, 2) for x in ms[name]]} (median "
            f"{out['median'][name]:.2f}), {out['tokens_per_tick'][name]:.2f} tokens a tick over "
            f"8 slots: a slot's token gap {out['gap_ms'][name]:.3f} ms"
            + (f", acceptance {eng.metrics().spec_acceptance:.4f}" if eng.spec_k else "")
            + f"; compile_counts {eng.compile_counts()}")
    for name in ("greedy k=4", "wta k=3"):
        assert engines[name].compile_counts()["spec_round"] == 1, engines[name].compile_counts()
    del engines
    torch.cuda.empty_cache()
    return out


def spec_phase(params, cfg, prompts, dev, res: dict) -> dict:
    """Phase 4d at stablelm-3b's full width and depth through the compiled
    engine: the verify-vs-draft probe (bf16 and f32 weights, bf16/f32 and
    int8 pools), then (a) greedy k = 4, (b) WTA k = 3, (c) int8 greedy
    k = 4, (d) forced rejections, (e) forced preempts under k = 3; the
    host ms of a replayed round in turns.  Where the probe finds the bf16
    verify rows bit-equal to their drafts, (a), (b), (d), (e) are gated on
    phase 4's streams; otherwise on an f32 copy of the weights against its
    own plain serve, the bf16 agreement printed beside.  int8 is never
    gated on streams (its decode depends on W, ROADMAP C)."""
    from repro_torch.serving import FaultInjector

    p32 = tree_float(params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    icfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    probe = {"bf16": spec_probe(params, cfg, prompts, dev),
             "bf16_int8": spec_probe(params, icfg, prompts, dev),
             "f32": spec_probe(p32, c32, prompts, dev),
             "f32_int8": spec_probe(p32, dataclasses.replace(c32, kv_cache_dtype="int8"),
                                    prompts, dev)}
    probe["ops"] = batch_width_probe(params, cfg, dev)
    # the bf16 model's rows must match in both pools: a row that differs in
    # one says the step is not batch-invariant, only mostly rounded alike
    gate_bf16 = probe["bf16"]["bit_equal"] and probe["bf16_int8"]["bit_equal"]
    log(f"  the bf16 verify rows are {'' if gate_bf16 else 'not all '}bit-equal to their drafts: "
        f"streams gated on {'phase 4' if gate_bf16 else 'an f32 copy against its own plain serve'}")

    def force():
        inj = FaultInjector()
        for t in SPEC_PREEMPT_TICKS:
            inj.at(t, "preempt")
        return inj

    wcfg = dataclasses.replace(cfg, wta_head=True)
    runs = {"a": spec_run(params, cfg, prompts, dev, 4, "a) bf16 greedy k=4"),
            "b": spec_run(params, wcfg, prompts, dev, 3, "b) bf16 WTA k=3"),
            "c": spec_run(params, icfg, prompts, dev, 4, "c) int8 greedy k=4"),
            "d": spec_run(params, cfg, prompts, dev, 4, "d) bf16 greedy k=4, forced rejections",
                          tamper=True),
            "e": spec_run(params, cfg, prompts, dev, 3, "e) bf16 greedy k=3, forced preempts",
                          injector=force())}
    assert runs["d"]["tampered_rounds"] >= 1 and runs["d"]["compile_counts"]["spec_rollback"] == 1
    assert runs["d"]["metrics"]["spec_accepted"] < runs["d"]["metrics"]["spec_drafted"]
    pre = runs["e"]["metrics"]
    assert pre["preemptions"] >= 1 and pre["restores"] == pre["preemptions"], pre
    want = {"a": res["same"]["outs"], "b": res["wta"]["outs"], "c": res["int8"]["outs"],
            "d": res["same"]["outs"], "e": res["same"]["outs"]}
    for key, run in runs.items():
        run["agree"] = preempt_check(f"4d {key}", run, want[key],
                                     gate=gate_bf16 and key != "c", against="phase 4's")
    # (d) and (e) against (a): the same rounds' verify tokens, realigned
    for key in ("d", "e"):
        runs[key]["agree_a"] = preempt_check(f"4d {key} vs a", runs[key], runs["a"]["outs"],
                                             gate=gate_bf16, against="run (a)'s")
    out = {"probe": probe, "gate_bf16": gate_bf16, "runs": runs}
    if not gate_bf16:
        out["f32"] = spec_f32(p32, c32, prompts, dev, force)
    del p32
    torch.cuda.empty_cache()
    out["turns"] = spec_turns(params, cfg, dev)
    return out


def spec_f32(p32, c32, prompts, dev, force) -> dict:
    """(a), (b), (d) and (e) on an f32 copy of the weights, each gated
    token for token against the f32 plain serve (``speculate_k = 0``)."""
    from repro_torch.serving import ServingEngine

    w32 = dataclasses.replace(c32, wta_head=True)
    base = {}
    for name, c in (("greedy", c32), ("wta", w32)):
        eng = ServingEngine(p32, c, spec_serve_config(), device=dev)
        for p in prompts:
            eng.submit(p)
        base[name] = eng.run()
        del eng
    runs = {"a": spec_run(p32, c32, prompts, dev, 4, "a f32) greedy k=4"),
            "b": spec_run(p32, w32, prompts, dev, 3, "b f32) WTA k=3"),
            "d": spec_run(p32, c32, prompts, dev, 4, "d f32) forced rejections", tamper=True),
            "e": spec_run(p32, c32, prompts, dev, 3, "e f32) forced preempts",
                          injector=force())}
    for key, run in runs.items():
        run["agree"] = preempt_check(f"4d {key} f32", run, base["wta" if key == "b" else "greedy"],
                                     gate=True, against="the f32 plain serve's")
    assert runs["d"]["compile_counts"]["spec_rollback"] == 1
    assert runs["e"]["metrics"]["restores"] == runs["e"]["metrics"]["preemptions"] >= 1
    torch.cuda.empty_cache()
    return runs


# CUgraphNodeType values (cuda.h) of the nodes a decode step captures
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(eng) -> dict:
    """Nodes of the engine's compiled step by type, for the widest window
    it captured: the step captured once more into a graph that keeps its
    ``cudaGraph_t`` (a capture runs nothing, so the engine's state does
    not move; the launch counters the capture moved are put back),
    counted with ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` of
    ``libcuda``."""
    import ctypes

    from repro_torch.kernels import ops as KOPS
    from repro_torch.launch import specs as SP

    (w, r), entry = max(eng._decode.entries.items())
    before = KOPS.launch_counts()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=SP.capture_stream(eng._decode.device.index)):
        eng._decode._run(entry.inputs)
    after = KOPS.launch_counts()
    KOPS.add_launches({k: before[k] - after[k] for k in after})
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds: dict[str, int] = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        kind = NODE_TYPES.get(t.value, f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    del g
    log(f"  graph of (W={w}, R={r}): {n.value} nodes {kinds}")
    return {"window": w, "reads": r, "nodes": n.value, "by_type": kinds}


def profile_decode(eng, vocab: int, mode: str, n_ticks: int = 5) -> dict:
    """Steady-state breakdown of full-batch decode ticks: host time per
    tick, device busy share, the kernels that take the device time, and
    the WTA sampler's share where it runs.  With the compiled step every
    profiled tick is a replay: its first tick at the profile's window
    width comes before the profiler starts."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    for _ in range(eng.cfg.max_batch):
        eng.submit(rng.integers(0, vocab, 100).tolist(), max_new_tokens=n_ticks + 16)
    while eng._job_fifo or eng.sched.queued():
        eng.tick()
    eng.tick()  # warm: every slot decoding
    torch.cuda.synchronize()
    captured = len(eng._decode.captures())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert len(eng._decode.captures()) == captured, "a profiled tick captured a graph"
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    attn = [e for e in gpu if "paged_decode_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    wta = [e for e in gpu if "wta_sample_kernel" in e.key]
    wta_ms = sum(e.self_device_time_total for e in wta) / 1e3
    out = {"host_ms": wall_ms / n_ticks, "device_ms": busy_ms / n_ticks,
           "busy": busy_ms / wall_ms,
           "kernels": sum(e.count for e in gpu) / n_ticks, "attention_ms": attn_ms / n_ticks,
           "wta_sample_ms": wta_ms / n_ticks, "wta_sample_launches": sum(e.count for e in wta) / n_ticks}
    log(f"  [{mode}] profile: {n_ticks} full-batch decode ticks, {wall_ms / n_ticks:.2f} ms/tick "
        f"host, device busy {busy_ms / n_ticks:.2f} ms/tick ({100 * busy_ms / wall_ms:.1f}% of "
        f"wall), {sum(e.count for e in gpu) // n_ticks} kernels/tick; decode attention "
        f"{attn_ms / n_ticks:.3f} ms/tick ({100 * attn_ms / max(busy_ms, 1e-9):.1f}% of device "
        f"time, {sum(e.count for e in attn) / n_ticks:.1f} launches/tick); WTA sampler "
        f"{out['wta_sample_ms']:.4f} ms/tick ({100 * wta_ms / max(busy_ms, 1e-9):.1f}% of device "
        f"time, {out['wta_sample_launches']:.1f} launches/tick)")
    for e in sorted(gpu, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / n_ticks:8.3f} ms/tick  "
            f"{e.count // n_ticks:5d}x  {e.key[:90]}")
    eng.run()
    return out


# ---------------------------------------------------------------------------
# Phase 5: the stochastic-rounding and WTA vote-count entry points.
# ---------------------------------------------------------------------------


def stoch_round_phase(dev) -> dict:
    """``ops.stoch_round_serving`` on bench_kernels.py's quantizer row: a
    (2048, 2048) array onto the 2/31 conductance grid in [-1, 1]."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stoch_round as SR

    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((2048, 2048), generator=gen, device=dev)
    SR.launches = 0
    q = ops.stoch_round_serving(x, 20241216, step=2.0 / 31, lo=-1.0, hi=1.0)
    torch.cuda.synchronize()
    launches = SR.launches
    levels = (q + 1.0) * (31 / 2.0)
    on_grid = bool(((levels - levels.round()).abs() < 1e-4).all())
    mean_err = float((q - x.clamp(-1.0, 1.0)).mean())
    log(f"  stoch_round_serving (2048, 2048) step 2/31: launches {launches}, on the grid "
        f"{on_grid}, mean rounding error {mean_err:.2e} (unbiased: ~0)")
    assert launches > 0, "stoch_round_serving did not launch its kernel"
    assert on_grid and abs(mean_err) < 1e-3, (on_grid, mean_err)
    return {"launches": launches}


def wta_phase(dev) -> dict:
    """``ops.wta_counts`` at the serving head's operating point: 8 rows of
    50304 classes, 32 trials, vth0 = 1.702², σ = 1.702."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import wta_counts as WTA

    gen = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA
    WTA.launches = 0
    counts = ops.wta_counts(z, 20241216, n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    torch.cuda.synchronize()
    launches = WTA.launches
    votes = counts.sum(-1)
    top = counts.argmax(-1)
    rank = (z > z.gather(1, top[:, None])).sum(-1)   # the most-voted class's rank in z
    log(f"  wta_counts (8, 50304) T=32: launches {launches}, votes per row "
        f"{votes.tolist()}, most-voted class's rank in z {rank.tolist()}")
    assert launches > 0, "wta_counts entry point did not launch its kernel"
    assert counts.shape == z.shape and torch.isfinite(counts).all()
    assert torch.equal(counts, counts.round()) and bool((counts >= 0).all())
    # ~11% of 50304 classes fire per trial, so every trial casts one vote
    # (exact ties aside)
    assert bool((votes == 32).all()), votes
    return {"launches": launches}


FAULT_CLOCK = 100          # the fault clock of the faulty entry points
# Faulty weights, card against CPU: PyTorch's CUDA division by a Python
# scalar multiplies by its reciprocal (the CPU divides), so the drift's
# (G - G_ref) / G0 may differ by an ulp of G (≈ 1.2e-7 after / G0 in
# normalized units, tests/test_torch_backend.py); bound: 4 such ulps x max|w|
FAULTY_WEIGHT_ULPS = 4 * 1.2e-7
FAULTY_CROSSBAR = dict(stuck_rate=1e-3, drift_nu=0.1, seed=0)
FAULTY_WTA = dict(comparator_offset=0.5, read_sigma_inflation=0.2)


def faulty_transform(w, bk):
    """The reference's ``_faulty_weights`` written out in plain torch ops
    on ``w``'s device: drift in conductance space, then stuck cells at
    w_min / w_max, under the max|w| scale."""
    from repro_torch.core.physics import DeviceParams

    dp = DeviceParams()
    s = w.abs().amax().clamp_min(1e-6)
    g = dp.g0 * (w / s) + dp.g_ref
    wn = (bk.fault_state()["drift_mult"] * g - dp.g_ref) / dp.g0
    sa0, sa1 = (torch.from_numpy(a).to(w.device) for a in bk._stuck_masks(tuple(w.shape)))
    return wn.masked_fill(sa0, dp.w_min).masked_fill(sa1, dp.w_max) * s


def faulty_phase(dev) -> dict:
    """The entry points through ``use_backend(FaultySimBackend(...))``.

    ``ops.crossbar_mac`` at the (1024, 2560) x (2560, 2560) training read
    (linear, calibrated, quantized), 0.1% stuck cells and drift at clock
    100: the faulty weights the backend hands the kernel must equal the
    plain-torch transform of the same weights on the card bit for bit
    (:func:`faulty_transform`), and the CPU's within
    ``FAULTY_WEIGHT_ULPS``, and
    the read is held against its plain version on those weights at the
    linear gate, scaled by the read's range scale s (its output is the
    normalized read times s, one more rounding on each side: + 2**-23·|out|).
    ``ops.wta_counts`` at the serving head (8 x 50304, T = 32) with a
    comparator offset of 0.5 and 20% read-noise inflation: held against
    the plain version at the shifted (vth0 + 0.5, σ·1.2) by its agreement
    bound.  Launch counts reset just before each call, read just after."""
    from repro_torch import random as R
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.kernels import backend as BK
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wta_counts as WTA

    gen = torch.Generator(device=dev).manual_seed(20)
    m, k, n = 1024, 2560, 2560
    x = torch.randn((m, k), generator=gen, device=dev)
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16).float()
    cfg = AnalogConfig(mode="analog_linear", device=calibrate_v_read(DeviceParams(), k))
    key = R.PRNGKey(11)

    def faulty(spec):
        bk = BK.FaultySimBackend(fault=BK.FaultConfig(**spec))
        bk.advance_clock(FAULT_CLOCK)
        return bk

    bk = faulty(FAULTY_CROSSBAR)
    handed = {}
    real = ops.crossbar_mac_sim

    def recording(x, w, key, cfg, binarize=True):
        handed["w"] = w
        return real(x, w, key, cfg, binarize)

    ops.crossbar_mac_sim = recording
    try:
        CB.launches = CB.prepass_launches = 0
        with BK.use_backend(bk):
            got = ops.crossbar_mac(x, w, key, cfg, binarize=False)
        torch.cuda.synchronize()
        launches = (CB.launches, CB.prepass_launches)
    finally:
        ops.crossbar_mac_sim = real
    wf = handed["w"]
    plain_wf = faulty_transform(w, bk)
    exact = torch.equal(wf, plain_wf)
    cpu_err = float((wf.cpu() - faulty(FAULTY_CROSSBAR)._faulty_weights(w.cpu())).abs().max())
    cpu_tol = FAULTY_WEIGHT_ULPS * float(w.abs().max())
    state = bk.fault_state()
    log(f"  faulty crossbar_mac (1024, 2560) x (2560, 2560) linear: {state['stuck_cells']} stuck "
        f"cells, drift x{state['drift_mult']} at clock {FAULT_CLOCK}; faulty weights = the "
        f"plain-torch transform on the card bit for bit: {exact}; against the CPU's max|Δ| "
        f"{cpu_err:.3e} (bound {cpu_tol:.3e}); launches {launches[0]} read + {launches[1]} prepass")
    if not exact or cpu_err > cpu_tol:
        raise AssertionError("faulty weights on the card differ from the plain-torch transform")
    if launches != (1, 1):
        raise AssertionError(f"faulty crossbar_mac launched {launches}, not one read + one prepass")
    want = ops.crossbar_mac_reference(x, wf, key, cfg, binarize=False)
    s = ops.range_scale(wf)
    dp = cfg.device
    wq = ref.crossbar_quantize(wf / s, ops._qstep(dp), dp.w_min, dp.w_max)
    tol = s * 2 * k**0.5 * 2.0**-24 * (x.abs() @ wq.abs()) + 2.0**-23 * want.abs()
    err = (got - want).abs()
    worst = float((err / tol.clamp_min(1e-30)).max())
    healthy = ops.crossbar_mac(x, w, key, cfg, binarize=False)
    moved = float((healthy - got).abs().max())
    log(f"  faulty crossbar_mac vs its plain version on the faulty weights: max|err| "
        f"{float(err.max()):.3e}, worst err/tol {worst:.3f}; the faults moved the read by up to "
        f"{moved:.3e}")
    if worst > 1.0 or not torch.isfinite(got).all() or moved == 0.0:
        raise AssertionError("faulty crossbar_mac disagrees with its plain version")
    cb_err = float(err.max())

    bk = faulty(FAULTY_WTA)
    z = torch.randn((8, 50304), generator=gen, device=dev) * WTA_SIGMA
    seed = 20241216
    kw = dict(n_trials=32, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
    WTA.launches = 0
    with BK.use_backend(bk):
        counts = ops.wta_counts(z, seed, **kw)
    torch.cuda.synchronize()
    wta_launches = WTA.launches
    vth0, sigma = bk.wta_readout_params(WTA_VTH0, WTA_SIGMA)
    plain = ref.wta_counts_ref(z, ops._seed_tensor(seed, z.device), n_trials=32, vth0=vth0,
                               sigma_z=sigma)
    healthy = ops.wta_counts(z, seed, **kw)
    delta = float((counts - plain).abs().sum())
    sums_equal = torch.equal(counts.sum(-1), plain.sum(-1))
    log(f"  faulty wta_counts (8, 50304) T=32 at (vth0 {vth0!r}, σ {sigma!r}): launches "
        f"{wta_launches}, row sums equal {sums_equal}, sum|Δcounts| {delta:.0f} (bound "
        f"{2 * WTA_FLIP_FRACTION * 8 * 32:.1f}); differs from the healthy point's counts "
        f"{not torch.equal(counts, healthy)}")
    if wta_launches != 1 or not sums_equal or delta > 2 * WTA_FLIP_FRACTION * 8 * 32:
        raise AssertionError("faulty wta_counts disagrees with its plain version")
    if torch.equal(counts, healthy):
        raise AssertionError("the fault backend did not move wta_counts' operating point")
    return {"crossbar_launches": launches[0], "crossbar_err": cb_err,
            "wta_launches": wta_launches, "wta_err": float((counts - plain).abs().max())}


# ---------------------------------------------------------------------------
# Phase 6: RACA analog training of stablelm-3b at full width.
# ---------------------------------------------------------------------------


def analog_cfg(cfg):
    """``--analog``: analog-stochastic execution with V_r calibrated to the
    model width, as ``launch/train.py`` configures it."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read

    return dataclasses.replace(cfg, analog=AnalogConfig(
        mode="analog_stochastic", device=calibrate_v_read(DeviceParams(), cfg.d_model)))


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def train_phase(dev) -> dict:
    """``make_train_step`` on stablelm-3b at full width and depth in analog
    mode, the launcher's defaults (batch 8 x 128, lr 3e-4, warmup 100,
    bf16 moments with stochastic rounding), TRAIN_STEPS steps, then one
    profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = analog_cfg(get_config("stablelm-3b"))
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4), total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    log(f"  init stablelm-3b ({cfg.n_layers}L d{cfg.d_model} ff{cfg.d_ff} V{cfg.vocab} "
        f"{cfg.dtype}, {cfg.analog.mode}) and its AdamW state in {time.perf_counter() - t0:.1f} s")
    probe = state.params["units"]["l0"]["ffn"]["w_up"]
    before = probe[:, :64, :64].detach().clone()
    batches = [lm_batch(cfg, batch=8, seq=128, step=i, device=dev) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CB.launches = CB.prepass_launches = 0
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"  step {i}: loss {loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, "
            f"lr {metrics['lr']:.3e}, {times[-1]:.3f} s")
    launches, prepasses = CB.launches, CB.prepass_launches
    peak = torch.cuda.max_memory_allocated()
    changed = not torch.equal(before, probe[:, :64, :64])
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    log(f"  {TRAIN_STEPS} steps: crossbar_mac launches {launches} "
        f"({launches / TRAIN_STEPS:.0f} per step = {CB_PER_LAYER} x {cfg.n_layers} layers), "
        f"prepass launches {prepasses}, "
        f"step {step_s:.3f} s (steps after the first), {8 * 128 / step_s:.1f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB, parameters changed {changed}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not changed:
        raise AssertionError("the training steps did not change the parameters")
    if launches != CB_PER_LAYER * cfg.n_layers * TRAIN_STEPS or prepasses != launches:
        raise AssertionError(f"crossbar_mac launched {launches} reads and {prepasses} "
                             f"prepasses, expected {CB_PER_LAYER * cfg.n_layers * TRAIN_STEPS} each")
    profile = profile_train_step(step_fn, state, batches[TRAIN_STEPS])
    return {"launches": launches, "prepass_launches": prepasses, "losses": losses,
            "step_s": step_s, "peak": peak, "profile": profile}


def profile_train_step(step_fn, state, batch) -> dict:
    """Device time of one training step, split into the crossbar kernel,
    cuBLAS products (the STE backward's, and the digital logits and
    attention einsums), the AdamW update with its rounding draws (the
    kernels that start inside the device side of its ``train/adamw``
    range) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == cuda]
    ranges = [e.time_range for e in events if e.name == "train/adamw"]
    kernels = [e for e in events if not e.name.startswith("train/")]

    def ms(sel):
        return sum(e.time_range.elapsed_us() for e in sel) / 1e3

    def in_adamw(e):
        return any(r.start <= e.time_range.start < r.end for r in ranges)

    crossbar = [e for e in kernels if "crossbar" in e.name]
    prepass = [e for e in crossbar if "prepass" in e.name]
    gemm = [e for e in kernels if "crossbar" not in e.name
            and any(g in e.name.lower() for g in GEMM_NAMES) and not in_adamw(e)]
    adamw = [e for e in kernels if in_adamw(e)]
    total = ms(kernels)
    split = {"wall_ms": wall_ms, "device_ms": total, "crossbar_mac_ms": ms(crossbar),
             "crossbar_prepass_ms": ms(prepass), "gemm_ms": ms(gemm), "adamw_ms": ms(adamw),
             "kernels": len(kernels)}
    split["rest_ms"] = total - split["crossbar_mac_ms"] - split["gemm_ms"] - split["adamw_ms"]
    log(f"  profiled step: {wall_ms:.1f} ms host, device busy {total:.1f} ms "
        f"({100 * total / wall_ms:.1f}%), {len(kernels)} kernels; crossbar_mac {split['crossbar_mac_ms']:.1f} ms "
        f"({len(crossbar)} launches, of which the prepass {split['crossbar_prepass_ms']:.1f} ms in "
        f"{len(prepass)}), cuBLAS {split['gemm_ms']:.1f} ms ({len(gemm)}), AdamW + rounding "
        f"{split['adamw_ms']:.1f} ms ({len(adamw)}), rest {split['rest_ms']:.1f} ms")
    rows = [e for e in prof.key_averages() if e.device_type == cuda and not e.key.startswith("train/")]
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return split

# ---------------------------------------------------------------------------
# Phase 6b: the paper's FCNN at full width, training and RACA inference.
# ---------------------------------------------------------------------------


def fcnn_cfgs():
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    return get_config("fcnn-mnist"), TrainConfig(
        opt=AdamWConfig(lr=FCNN_LR, state_dtype="float32", stochastic_rounding=False),
        total_steps=FCNN_STEPS)


def fcnn_phase(dev) -> dict:
    """Train fcnn-mnist [784, 500, 300, 10] at full width (FCNN_STEPS steps
    through ``make_train_step``), then the Fig. 6 protocol on 1024 test
    images: the digital baseline and RACA inference at 1, 4, 16 and 64
    votes.  The launches of the two kernels of the inference path, reset
    just before the four predictions and read just after, must be 2 and 1
    a vote (170 and 85).  Gates: tests/test_system.py's relations."""
    from repro_torch import random as R
    from repro_torch.data import mnist_batch, mnist_dataset
    from repro_torch.kernels import sigmoid_sample as SS
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.models.fcnn import fcnn_predict_digital, fcnn_predict_raca
    from repro_torch.train import init_train_state, make_train_step

    cfg, tcfg = fcnn_cfgs()
    state = init_train_state(tcfg.seed, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    t0 = time.perf_counter()
    batches = [mnist_batch(batch=FCNN_BATCH, step=i, device=dev) for i in range(FCNN_STEPS)]
    torch.cuda.synchronize()
    log(f"  {FCNN_STEPS} batches of {FCNN_BATCH} made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    SS.launches = 0
    losses, times = [], []
    for i in range(FCNN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i % 50 == 0 or i == FCNN_STEPS - 1:
            log(f"  step {i}: loss {losses[-1]:.4f}, {times[-1] * 1e3:.2f} ms")
    step_ms = sum(times[1:]) / len(times[1:]) * 1e3
    ref = FCNN_REFERENCE_CPU
    at = {k: losses[k] for k in ref["loss"] if k < len(losses)}
    log(f"  {FCNN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, at steps "
        f"{ {k: round(v, 4) for k, v in at.items()} } (reference on a CPU {ref['loss']}), step "
        f"{step_ms:.3f} ms (host clock, steps after the first, each ending in a sync); "
        f"sigmoid_sample launches in training {SS.launches} (the training forward takes the "
        f"expectation)")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"FCNN training did not bring the loss down: {losses[0]} -> {losses[-1]}")
    test = mnist_dataset(FCNN_TEST, device=dev)
    y = test["label"].long()
    digital = float((fcnn_predict_digital(state.params, test["image"], cfg) == y).float().mean())
    torch.cuda.synchronize()
    raca, walls = {}, {}
    SS.launches = WS.launches = 0
    for votes in FCNN_VOTES:
        t0 = time.perf_counter()
        pred = fcnn_predict_raca(state.params, test["image"], cfg, R.PRNGKey(7), votes)
        raca[votes] = float((pred == y).float().mean())
        walls[votes] = time.perf_counter() - t0
    launches = {"sigmoid_sample": SS.launches, "wta_sample": WS.launches}
    n_votes = sum(FCNN_VOTES)
    log(f"  digital accuracy {digital:.4f} (reference on a CPU {ref['digital']})")
    for votes in FCNN_VOTES:
        log(f"  RACA {votes:2d} votes: accuracy {raca[votes]:.4f} (reference on a CPU "
            f"{ref['raca'][votes]}), {walls[votes] * 1e3:.1f} ms wall")
    log(f"  launches over the {n_votes} votes: sigmoid_sample {launches['sigmoid_sample']} "
        f"(expected {2 * n_votes}), wta_sample {launches['wta_sample']} (expected {n_votes})")
    if launches != {"sigmoid_sample": 2 * n_votes, "wta_sample": n_votes}:
        raise AssertionError(f"FCNN inference launches {launches}, expected {2 * n_votes} and "
                             f"{n_votes}")
    if not (digital > 0.85 and raca[64] >= raca[1] and raca[64] >= digital - 0.05):
        raise AssertionError(f"Fig. 6 relations fail: digital {digital}, RACA {raca}")
    profile = profile_fcnn(step_fn, state, batches[0], test["image"], cfg)
    return {"launches": launches, "losses": (losses[0], losses[-1]), "step_ms": step_ms,
            "digital": digital, "raca": raca, "walls": walls, "profile": profile}


def profile_fcnn(step_fn, state, batch, x, cfg) -> dict:
    """Device time of one FCNN training step and of one 64-vote RACA
    prediction, by kernel: ``sigmoid_sample``, ``wta_sample``, cuBLAS
    products and the rest, beside the host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as R
    from repro_torch.models.fcnn import fcnn_predict_raca

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for label, fn in (("train step", lambda: step_fn(state, batch)),
                      ("64-vote prediction",
                       lambda: fcnn_predict_raca(state.params, x, cfg, R.PRNGKey(7), 64))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the step's record_function ranges show on the device timeline too
        kernels = [e for e in prof.events()
                   if e.device_type == cuda and not e.name.startswith("train/")]

        def ms(sel):
            return sum(e.time_range.elapsed_us() for e in sel) / 1e3

        sig = [e for e in kernels if "sigmoid_sample" in e.name]
        wta = [e for e in kernels if "wta_sample" in e.name]
        gemm = [e for e in kernels if any(g in e.name.lower() for g in GEMM_NAMES)]
        total = ms(kernels)
        rec = {"wall_ms": wall_ms, "device_ms": total, "kernels": len(kernels),
               "sigmoid_sample_ms": ms(sig), "wta_sample_ms": ms(wta), "gemm_ms": ms(gemm)}
        rec["rest_ms"] = total - rec["sigmoid_sample_ms"] - rec["wta_sample_ms"] - rec["gemm_ms"]
        log(f"  profiled {label}: {wall_ms:.2f} ms host, device busy {total:.3f} ms "
            f"({100 * total / wall_ms:.1f}%), {len(kernels)} kernels; sigmoid_sample "
            f"{rec['sigmoid_sample_ms']:.3f} ms ({len(sig)}), wta_sample {rec['wta_sample_ms']:.3f} "
            f"ms ({len(wta)}), cuBLAS {rec['gemm_ms']:.3f} ms ({len(gemm)}), rest "
            f"{rec['rest_ms']:.3f} ms")
        rows = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("train/")]
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
        out[label] = rec
    return out


def reference_fcnn(dev) -> None:
    """The smoke FCNN (64, 32, 16, 10; the first 64 pixels) trained 5 steps
    from one state on the card (kernels, cuBLAS) and on the CPU (plain
    versions) on the same batches: losses within REF_FCNN_LOSS_ATOL; its
    digital predictions equal and its 8-vote RACA predictions at least
    REF_FCNN_AGREEMENT equal on 256 test images."""
    import dataclasses as dc

    from repro_torch import random as R
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import mnist_batch, mnist_dataset
    from repro_torch.models.fcnn import fcnn_predict_digital, fcnn_predict_raca
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_smoke_config("fcnn-mnist")
    _, tcfg = fcnn_cfgs()
    tcfg = dc.replace(tcfg, warmup_steps=1, total_steps=10)
    width = cfg.fcnn_layers[0]

    def cut(b):
        return {"image": b["image"][:, :width].contiguous(), "label": b["label"]}

    batches = [cut(mnist_batch(batch=64, step=i, device="cpu")) for i in range(5)]
    test = cut(mnist_dataset(256, device="cpu"))
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(0, cfg, tcfg, device=d)
        step = make_train_step(cfg, tcfg)
        losses = []
        for b in batches:
            state, m = step(state, {k: v.to(d) for k, v in b.items()})
            losses.append(float(m["loss"]))
        x = test["image"].to(d)
        out[str(d)] = (losses, fcnn_predict_digital(state.params, x, cfg).cpu(),
                       fcnn_predict_raca(state.params, x, cfg, R.PRNGKey(7), 8).cpu())
    (lc, dc_, rc), (lg, dg, rg) = out["cpu"], out[str(dev)]
    err = max(abs(a - b) for a, b in zip(lc, lg))
    agree = float((rc == rg).float().mean())
    log(f"  smoke FCNN, 5 steps, card vs CPU: losses {lg} vs {lc} (max|Δ| {err:.3e}, atol "
        f"{REF_FCNN_LOSS_ATOL}); digital predictions equal {torch.equal(dc_, dg)}; 8-vote RACA "
        f"predictions {agree:.4f} equal (gate {REF_FCNN_AGREEMENT})")
    if err > REF_FCNN_LOSS_ATOL or not torch.equal(dc_, dg) or agree < REF_FCNN_AGREEMENT:
        raise AssertionError("the smoke FCNN disagrees card vs CPU")


# ---------------------------------------------------------------------------
# Phase 7: small input against the plain path on the CPU.
# ---------------------------------------------------------------------------


def reference_phase(dev) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TF

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 40)).astype(np.int32))
    row = torch.tensor([3, 7, 1, 9], dtype=torch.int32)
    table = torch.tensor([[3, 7, 1, 9], [0, 0, 0, 0]], dtype=torch.int32)
    block_seeds = torch.tensor([11, 2**32 - 1, 2**31, 5], dtype=torch.int64)
    for kv in ("same", "int8"):
        cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32",
                                  kv_cache_dtype=kv)
        host = TF.init_lm(cfg, seed=1, device="cpu")
        logits, pools = {}, {}
        for d in ("cpu", dev):
            params = _tree_to(host, d)
            cache = TF.init_paged_decode_cache(cfg, 2, 12, 16, device=d)
            state = TF.init_prefill_state(cfg, d)
            out = []
            for lo, hi in ((0, 32), (32, 40)):
                seeds = block_seeds[lo // 16 : -(-hi // 16)].to(d) if kv == "int8" else None
                _, state, lg = TF.lm_prefill_chunk(
                    params, toks[:, lo:hi].to(d), cfg, cache, state, row.to(d), lo, seeds
                )
                out.append(lg)
            cache["pos"] = torch.tensor([40, 5], dtype=torch.int32, device=d)
            tok = torch.tensor([5, 9], dtype=torch.int32, device=d)
            for _ in range(3):
                cache, lg = TF.lm_decode_step(params, cache, tok, cfg, table.to(d))
                out.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
            logits[str(d)] = [x.float().cpu() for x in out]
            pools[str(d)] = {k: v.cpu() for k, v in cache.items() if k.endswith("pages")}
        err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[str(dev)]))
        atol = REF_INT8_ATOL if kv == "int8" else REF_ATOL
        log(f"  smoke f32 {kv} pool logits card vs CPU: max|err| {err:.3e} (atol {atol})")
        if err > atol:
            raise AssertionError(f"card logits disagree with the CPU plain path ({kv} pool)")
        if kv == "int8":
            for name in ("k_pages", "v_pages"):
                a, b = pools["cpu"][name].int(), pools[str(dev)][name].int()
                eq = float((a == b).float().mean())
                log(f"  smoke int8 {name} card vs CPU: {eq:.6f} of codes equal, "
                    f"max |Δ| {int((a - b).abs().max())} (gate {REF_INT8_CODES}, 1)")
                if eq < REF_INT8_CODES or int((a - b).abs().max()) > 1:
                    raise AssertionError(f"int8 {name} codes disagree card vs CPU")


def reference_wta(dev) -> None:
    """A smoke-size f32 WTA serve (shared prefixes, a full hit, R = 1 and
    R = 3) on the card (kernels) and on the CPU (plain versions) from the
    same weights: token streams equal; where they are not, the first
    divergence is printed with both sides' vote counts at it, and the
    check fails."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TF
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", wta_head=True)
    host = TF.init_lm(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab, 24).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab, 8).tolist(), prefix + [7] * 8,
               rng.integers(0, cfg.vocab, 12).tolist(), prefix + [7] * 8,
               rng.integers(0, cfg.vocab, 5).tolist()]
    real = ops.wta_trial_counts
    for reads in (1, 3):
        outs, calls = {}, {}
        for d in ("cpu", dev):
            params = _tree_to(host, d)
            # eager on the card too: the recording below reads every
            # sampler call, which a graph replay does not make
            eng = ServingEngine(params, cfg, ServeConfig(
                max_batch=3, max_new_tokens=10, max_len=64, kv_block_size=8, prefill_chunk=16,
                seed=9, n_redundant_reads=reads), device=d, graphs=False)
            rec = calls[str(d)] = []

            def recording(*args, **kw):
                res = real(*args, **kw)
                rec.append(res[0].cpu())
                return res

            ops.wta_trial_counts = recording
            try:
                for p in prompts:
                    eng.submit(p)
                outs[str(d)] = eng.run()
            finally:
                ops.wta_trial_counts = real
        a, b = outs["cpu"], outs[str(dev)]
        n_tok = sum(len(o) for o in a.values())
        if a == b:
            log(f"  smoke WTA serve R={reads}, card vs CPU: {len(a)} streams, {n_tok} tokens, "
                f"equal ({len(calls['cpu'])} sampler calls)")
            continue
        k = next(i for i, (x, y) in enumerate(zip(calls["cpu"], calls[str(dev)]))
                 if x.shape != y.shape or not torch.equal(x.argmax(-1), y.argmax(-1)))
        x, y = calls["cpu"][k], calls[str(dev)][k]
        row = int((x.argmax(-1) != y.argmax(-1)).nonzero()[0])
        top_x, top_y = torch.topk(x[row], 2), torch.topk(y[row], 2)
        log(f"  smoke WTA serve R={reads}, card vs CPU: streams differ; first at sampler call "
            f"{k}, row {row}: CPU votes {top_x.values.tolist()} at {top_x.indices.tolist()}, "
            f"card votes {top_y.values.tolist()} at {top_y.indices.tolist()}")
        raise AssertionError(f"card and CPU WTA streams differ at R={reads}")


def _tree_to(tree, d):
    return {k: _tree_to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}


def reference_train(dev) -> None:
    """Two smoke-size analog training steps (f32, bf16 moments with
    stochastic rounding) from one state, on the card (the crossbar kernel,
    cuBLAS) and on the CPU (plain versions): losses within
    REF_TRAIN_LOSS_ATOL, comparator decisions at least REF_TRAIN_AGREEMENT
    equal.  The decisions are recorded by wrapping ``ops.crossbar_mac``
    for the two runs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    def tree_to(tree, d, grad=False):
        return {k: tree_to(v, d, grad) if isinstance(v, dict)
                else v.detach().to(d).requires_grad_(grad) for k, v in tree.items()}

    def state_to(state, d):
        opt = state.opt._replace(m=tree_to(state.opt.m, d), v=tree_to(state.opt.v, d))
        return state._replace(params=tree_to(state.params, d, grad=True), opt=opt)

    cfg = analog_cfg(dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32"))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    batches = [lm_batch(cfg, batch=4, seq=32, step=i, device="cpu") for i in range(2)]
    seen = {}
    inner = ops.crossbar_mac

    def recording(x, w, key, c, binarize=True):
        y = inner(x, w, key, c, binarize)
        if binarize:
            seen.setdefault(y.device.type, []).append(y.detach().cpu())
        return y

    ops.crossbar_mac = recording
    try:
        losses = {}
        for d in ("cpu", dev):
            state = state_to(init_train_state(1, cfg, tcfg, device="cpu"), d)
            step = make_train_step(cfg, tcfg)
            out = []
            for b in batches:
                state, m = step(state, {k: v.to(d) for k, v in b.items()})
                out.append(float(m["loss"]))
            losses[str(d)] = out
    finally:
        ops.crossbar_mac = inner
    a, b = (torch.cat([t.reshape(-1) for t in seen[d]]) for d in ("cpu", "cuda"))
    agree = float((a == b).float().mean())
    err = max(abs(x - y) for x, y in zip(losses["cpu"], losses[str(dev)]))
    log(f"  smoke analog training, 2 steps, card vs CPU: losses {losses[str(dev)]} vs {losses['cpu']} "
        f"(max|Δ| {err:.3e}, atol {REF_TRAIN_LOSS_ATOL}); {agree:.6f} of {a.numel()} comparator "
        f"decisions equal (gate {REF_TRAIN_AGREEMENT})")
    if err > REF_TRAIN_LOSS_ATOL or agree < REF_TRAIN_AGREEMENT:
        raise AssertionError("smoke analog training disagrees card vs CPU")


def short_kernel_name(mangled: str) -> str:
    """``_ZN4raca21paged_decode_kernel_8I13__nv_bfloat16S1_EEv...`` ->
    ``paged_decode_kernel_8<bf16,bf16>`` (the types the kernels take)."""
    import re

    m = re.match(r"_ZN4raca(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
    args, rest = [], rest[1:] if rest.startswith("I") else ""
    codes = (("13__nv_bfloat16", "bf16"), ("S1_", "bf16"), ("f", "f32"), ("a", "int8"))
    while rest and not rest.startswith("E"):
        lit = re.match(r"Li(\d+)E", rest)   # an int template argument
        code = next((c for c in codes if rest.startswith(c[0])), None)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif code is not None:
            args.append(code[1])
            rest = rest[len(code[0]):]
        else:
            break
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_entries(text: str):
    """(kernel, "N registers, S bytes smem, spills S/L bytes") per entry
    function of an ``-Xptxas -v`` log, with the template arguments
    shortened."""
    import re

    entry, spill = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = short_kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            yield entry, (f"{m.group(1)} registers, {smem.group(1) if smem else 0} bytes smem, "
                          f"{spill or 'no spill line'}")
            entry, spill = None, ""


# kernel -> its ptxas line, filled by the build phase (empty when cached)
PTXAS: dict[str, str] = {}


def log_ptxas(*kernels: str) -> None:
    for k in kernels:
        log(f"  ptxas {k}: {PTXAS.get(k, 'not rebuilt in this run')}")


def sass_instructions(sass: str, kernel: str) -> list[tuple[int, bool, str, str]]:
    """(address, predicated, opcode, operands) of ``kernel``'s instructions
    in ``cuobjdump -sass`` output."""
    import re

    body = next(b for b in sass.split("Function : ")[1:] if b.startswith(kernel + "\n"))
    return [(int(a, 16), bool(p), op, args) for a, p, op, args in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]


def _branch_target(ins, i) -> int:
    import re

    return int(re.search(r"0x([0-9a-f]+)", ins[i][3]).group(1), 16)


def sass_walk(ins, start: int = 0, *, loop: tuple[int, int] | None = None,
              first_exit: bool = False) -> list[str]:
    """Opcodes on the common path from ``ins[start]``, falling through every
    predicated branch except a forward one that jumps over a loop or a
    call (cosf's Payne-Hanek reduction, sqrtf's special-case call, a loop
    the path does not enter), up to the first unpredicated EXIT (any EXIT
    with ``first_exit``).  With ``loop = (head, back edge)`` the walk
    stays inside that loop (a branch out of it falls through) and ends at
    its back edge: one iteration."""
    at = {a: i for i, (a, *_rest) in enumerate(ins)}

    def slow(i):   # a loop's back edge or a call
        op = ins[i][2].split(".")[0]
        return op == "CALL" or (op == "BRA" and _branch_target(ins, i) <= ins[i][0])

    path, i, seen = [], start, set()
    while True:
        if i in seen:
            raise AssertionError(f"the common path loops at {ins[i][0]:#x}")
        seen.add(i)
        _addr, pred, op, _ = ins[i]
        path.append(op)
        base = op.split(".")[0]
        if loop is not None and i == loop[1]:
            return path
        if base == "EXIT" and (first_exit or not pred):
            return path
        if base == "BRA":
            j = at[_branch_target(ins, i)]
            inside = loop is None or loop[0] <= j <= loop[1]
            if inside and (not pred or (j > i and any(slow(k) for k in range(i + 1, j)))):
                i = j
                continue
        i += 1


def sass_common_path(sass: str, kernel: str) -> list[str]:
    """Opcodes on ``kernel``'s common path from its entry to its first
    unpredicated EXIT (:func:`sass_walk`)."""
    return sass_walk(sass_instructions(sass, kernel))


def sass_loops(ins) -> list[tuple[int, int]]:
    """(head, back edge) index pairs of the loops: every branch to an
    earlier address (not the ``BRA`` to itself that ends the code)."""
    at = {a: i for i, (a, *_rest) in enumerate(ins)}
    return [(at[_branch_target(ins, i)], i) for i, (a, _p, op, _) in enumerate(ins)
            if op.split(".")[0] == "BRA" and _branch_target(ins, i) < a]


def pipe_clocks(ops) -> dict:
    """Clocks of one scheduler for warp instructions ``ops`` (opcode ->
    count, the count may be fractional): the issue slot (every
    instruction), the ALU (integer logic, shifts, adds, compares, selects,
    moves), the FMA pipes (f32 arithmetic on both halves, IMAD on the
    heavy half only) and the XU (MUFU, conversions)."""
    alu = {"LOP3", "SHF", "IADD3", "VIADD", "ISETP", "FSETP", "FSEL", "SEL", "LEA", "MOV",
           "I2FP", "PRMT", "FMNMX", "IMNMX", "PLOP3", "POPC", "FLO"}
    fp = {"FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2"}
    xu = {"MUFU", "F2I", "I2F", "F2F", "FRND"}
    count = {}
    for op, k in ops.items():
        count[op.split(".")[0]] = count.get(op.split(".")[0], 0) + k
    n_imad = count.get("IMAD", 0)
    return {
        "issue": sum(count.values()),
        "ALU": 2 * sum(k for b, k in count.items() if b in alu),
        "FMA": max(sum(k for b, k in count.items() if b in fp) + n_imad, 2 * n_imad),
        "XU": 8 * sum(k for b, k in count.items() if b in xu),
    }


def issue_estimate(path: list[str]) -> dict:
    """Clocks of one scheduler per warp of elements on ``path``
    (:func:`pipe_clocks`); the pipe with the most clocks bounds it."""
    from collections import Counter

    clocks = pipe_clocks(Counter(path))
    return {"instructions": len(path), "clocks": clocks, "pipe": max(clocks, key=clocks.get)}


def ab_phase(dev, parent: Path) -> None:
    """``--ab DIR``: the wta_counts and stoch_round kernels of the checkout
    at DIR (its package loaded as ``repro_torch_ab``, built into DIR's own
    build directory) against this checkout's, on the same inputs in one
    process: outputs compared (both are exact, so they must be equal) and
    device times, then per-call times (host included, 200 back-to-back
    calls), taken in turns, DIR, this, this, DIR."""
    import importlib
    import importlib.util

    from repro_torch.kernels import stoch_round as SR
    from repro_torch.kernels import wta_counts as WTA

    pkg = parent / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_ab", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules["repro_torch_ab"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["repro_torch_ab"])
    old_wta = importlib.import_module("repro_torch_ab.kernels.wta_counts")
    old_sr = importlib.import_module("repro_torch_ab.kernels.stoch_round")
    gen = torch.Generator(device=dev).manual_seed(16)

    def seeds(k):
        return torch.randint(0, 2**32, (k,), generator=gen, device=dev, dtype=torch.int64)

    cases = []
    for b, c, t in ((8, 50304, 32), (256, 128, 64), (64, 10, 100)):
        kw = dict(n_trials=t, vth0=WTA_VTH0, sigma_z=WTA_SIGMA)
        sets = [(torch.randn((b, c), generator=gen, device=dev) * WTA_SIGMA, seeds(1), kw)
                for _ in range(ROTATE)]
        cases.append((f"wta_counts ({b}, {c}) T={t}", old_wta.wta_counts_cuda,
                      WTA.wta_counts_cuda, sets))
    for (m, n), g, step, lo, hi in (((2048, 2048), 1, 2.0 / 31, -1.0, 1.0),
                                    ((256, 80), 1, 1.0, -127.0, 127.0),
                                    ((4096, 80), 8, 1.0, -127.0, 127.0)):
        kw = dict(step=step, lo=lo, hi=hi)
        sets = [(torch.randn((m, n), generator=gen, device=dev) * 0.8 * hi, seeds(g), kw)
                for _ in range(ROTATE)]
        cases.append((f"stoch_round ({m}, {n}), {g} seeds", old_sr.stoch_round_cuda,
                       SR.stoch_round_cuda, sets))
    for label, old, new, sets in cases:
        *args, kw = sets[0]
        if not torch.equal(old(*args, **kw), new(*args, **kw)):
            raise AssertionError(f"{label}: this checkout's kernel differs from {parent}'s")
        fns = [[(lambda f=f, a=a: f(*a[:-1], **a[-1])) for a in sets] for f in (old, new)]
        for what, timer in (("device", device_ms), ("per call", lambda f: cuda_ms(f, 200))):
            t = [timer(fns[i]) for i in (0, 1, 1, 0)]
            log(f"  A/B {label}: equal outputs; {what} ms {parent.name} {t[0]:.4f}, this "
                f"{t[1]:.4f}, this {t[2]:.4f}, {parent.name} {t[3]:.4f}; ratio "
                f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log("== device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    log("== build")
    t0 = time.perf_counter()
    logs = build.build_all(build.sources())
    log(f"  built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for entry, info in ptxas_entries(text):
            PTXAS[entry] = info
            log(f"  {name}: {entry}: {info}")

    if "--ab" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--ab") + 1]).resolve()
        log(f"== A/B against {parent}")
        ab_phase(dev, parent)
        return 0

    log("== kernels vs plain versions")
    kres = kernel_phase(dev)
    log("== serve stablelm-3b (bf16 pool, int8 pool, then WTA sampling on the bf16 pool at "
        "R = 1 and 3)")
    sres = serve_phase(dev, kres["w_invariance"]["bf16"]["identical"])
    log("== stoch_round and wta_counts entry points")
    srres = stoch_round_phase(dev)
    wres = wta_phase(dev)
    log("== crossbar_mac and wta_counts through the fault backend")
    fres_faulty = faulty_phase(dev)
    log("== analog training of stablelm-3b")
    tres = train_phase(dev)
    log("== the paper's FCNN: fcnn-mnist [784, 500, 300, 10] training and RACA inference")
    fres = fcnn_phase(dev)
    log("== small-input reference")
    reference_phase(dev)
    reference_wta(dev)
    reference_train(dev)
    reference_fcnn(dev)

    launches = dict(sres["same"]["launches"])
    launches["write_kv_int8"] = sres["int8"]["launches"]["write_kv_int8"]
    launches["stoch_round"] = srres["launches"]
    launches["wta_counts"] = wres["launches"]
    launches["crossbar_mac"] = tres["launches"]
    launches["crossbar_prepass"] = tres["prepass_launches"]
    launches["wta_sample"] = sres["wta"]["launches"]["wta_sample"]
    launches["sigmoid_sample"] = fres["launches"]["sigmoid_sample"]
    kernels = []
    for key, tkey, name, src, replaces in (
        ("decode", ("decode", "bf16"), "paged_attention",
         "src/repro_torch/kernels/csrc/paged_attention.cu", "src/repro/kernels/paged_attention.py:204"),
        ("prefill", ("prefill", "bf16"), "paged_prefill_attention",
         "src/repro_torch/kernels/csrc/prefill_attention.cu",
         "src/repro/kernels/prefill_attention.py:210"),
        ("stoch_round", "stoch_round", "stoch_round",
         "src/repro_torch/kernels/csrc/stoch_round.cu", "src/repro/kernels/stoch_round.py:82"),
        ("write_kv_int8", "write_kv_int8", "write_kv_int8",
         "src/repro_torch/kernels/csrc/stoch_round.cu", "src/repro/kernels/stoch_round.py:82"),
        ("wta_counts", "wta_counts", "wta_counts",
         "src/repro_torch/kernels/csrc/wta_counts.cu", "src/repro/kernels/wta_kernel.py:100"),
        ("crossbar_mac", "crossbar_mac", "crossbar_mac",
         "src/repro_torch/kernels/csrc/crossbar_mac.cu", "src/repro/kernels/crossbar_mac.py:154"),
        ("crossbar_prepass", "crossbar_prepass", "crossbar_prepass",
         "src/repro_torch/kernels/csrc/crossbar_mac.cu", "src/repro/kernels/crossbar_mac.py:154"),
        # no Pallas kernel: the reference's wta_trials in jnp
        ("wta_sample", "wta_sample", "wta_sample",
         "src/repro_torch/kernels/csrc/wta_sample.cu", "src/repro/core/wta.py:50"),
        # no Pallas kernel: the reference's stochastic Sigmoid neurons in jnp
        ("sigmoid_sample", "sigmoid_sample", "sigmoid_sample",
         "src/repro_torch/kernels/csrc/sigmoid_sample.cu", "src/repro/core/neurons.py:77"),
    ):
        t = kres["timing"][tkey]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": max(kres["errs"][key]),
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
        for extra in ("f32_bound_ms", "gemm_device_ms", "tile_n", "tile_device_ms", "one_pass",
                      "issue_ms", "issue_instructions", "issue_pipe", "cluster", "cta_warps",
                      "geometry_device_ms", "byte_bound_ms", "fcnn_head"):
            if extra in t:
                kernels[-1][extra] = t[extra]
        if "cases" in t:
            kernels[-1]["cases"] = t["cases"] + (
                kres["timing"][(key, "int8")].get("cases", []) if isinstance(tkey, tuple) else [])
    # the R = 3 serve of the same trace and the FCNN's head: their own
    # paths, counted apart
    wta_rec = next(k for k in kernels if k["name"] == "wta_sample")
    wta_rec["launches_r3"] = sres["wta_r3"]["launches"]["wta_sample"]
    wta_rec["launches_fcnn_head"] = fres["launches"]["wta_sample"]
    # the backend seam's paths: the degraded serve's canary reads, the
    # entry points through the fault backend
    deg = sres["degraded"]["ladder"]
    cb_rec = next(k for k in kernels if k["name"] == "crossbar_mac")
    cb_rec["launches_canary"] = deg["crossbar_launches"]
    cb_rec["launches_faulty"] = fres_faulty["crossbar_launches"]
    cb_rec["max_abs_err_faulty"] = fres_faulty["crossbar_err"]
    wc_rec = next(k for k in kernels if k["name"] == "wta_counts")
    wc_rec["launches_faulty"] = fres_faulty["wta_launches"]
    wc_rec["max_abs_err_faulty"] = fres_faulty["wta_err"]
    # phase 4c: each run's launches, reset just before it and read just after
    pre = sres["preempt"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_preempt"] = {run: pre[run]["launches"][key]
                                   for run in ("a", "b", "c", "d_same", "d_int8")}
    # phase 4d: each speculative run's launches, reset just before it and
    # read just after
    spec = sres["spec"]["runs"]
    for name, key in (("paged_attention", "decode"), ("paged_prefill_attention", "prefill"),
                      ("write_kv_int8", "write_kv_int8"), ("wta_sample", "wta_sample")):
        rec = next(k for k in kernels if k["name"] == name)
        rec["launches_spec"] = {run: spec[run]["launches"][key] for run in spec}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
