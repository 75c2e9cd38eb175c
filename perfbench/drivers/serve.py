"""The serving driver (traffic ``"kind": "serve"``): a ``repro_torch``
paged engine on one card, fed an open loop of arrivals (or a closed
backlog) from the traffic file, timed by the host's clock from each
request's due time.  The configuration's family module
(``families/<family>.py``) gives the model config, the weights and the
plain reference.

Set-up (``setup_s``): imports, the kernels' build or load, the weights on
the device, the engine, one decode step captured per window width the
traffic can reach, one warm request per prompt bucket it can reach, and
the lead-in: the traffic's first ``lead_s`` seconds of arrivals (a backlog
instead runs until every slot decodes).  The window then runs ``--seconds``
of ``submit`` / ``tick``; a token is stamped when the tick that emits it
returns.  The traced run profiles ``trace_ticks`` ticks from ``trace_at``
of the way into the window, and reads the engine's counters over the rest
of it; an open loop's stretch goes near the window's end, since the
profiler slows the ticks it records and its stop stalls the host for
seconds, and the queue that builds meanwhile would otherwise weigh on the
rest.  Every run logs the KV pool's pages and
the most of them that admitted requests held at once (the engine reserves
a request's whole budget at admission).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from .. import check as CK
from .. import common
from .. import roofline as RF
from .. import trace as TR
from .. import traffic as TG


@dataclasses.dataclass
class Rec:
    req: TG.Request
    due: float                       # absolute host time
    bucket: int
    rid: Optional[int] = None
    first: Optional[float] = None
    last: Optional[float] = None
    served: list = dataclasses.field(default_factory=list)
    done: bool = False


def ttft_ms(recs: list, t0: float, t_end: float, loop: str) -> tuple[list, int]:
    """(TTFT ms of each request the window attempted, their count).  Open
    loop: every request due in [t0, t_end), timed from its due time to its
    first token, or to t_end if it has none by then (a stall cannot hide).
    Backlog: every request that emitted a token in the window (no TTFT)."""
    out, n = [], 0
    for r in recs:
        if loop == "open":
            if not t0 <= r.due < t_end:
                continue
            first = r.first if r.first is not None and r.first <= t_end else t_end
            out.append((first - r.due) * 1e3)
        elif not (r.served and r.last >= t0):
            continue
        n += 1
    return (out if loop == "open" else []), n


def _warm(engine, mcfg, scfg, traffic: dict, recs: list, seed: int, log) -> None:
    """Capture the decode step at every window width the traffic reaches
    (each capture runs one eager step first, on the all-trash table of an
    idle engine; on the CPU the step runs eagerly), and serve one warm
    request per prompt bucket it reaches."""
    bs, bpp = scfg.kv_block_size, scfg.max_kv_blocks()
    lo = min(r.bucket for r in recs) // bs + 1
    b = scfg.max_batch
    wta = (np.zeros((b, 2), np.int64), np.zeros((b,), np.int64)) if mcfg.wta_head else ()
    w = 1
    while w < lo:
        w *= 2
    while True:
        w = min(w, bpp)
        tok, _ = engine._decode(np.zeros((b, w), np.int32), np.zeros((b,), np.int32), *wta)
        tok.cpu()
        if w == bpp:
            break
        w *= 2
    rng = np.random.Generator(np.random.PCG64(seed ^ 0xC0FFEE))
    for bucket in sorted({r.bucket for r in recs}):
        engine.submit(rng.integers(0, mcfg.vocab, size=bucket).tolist(), max_new_tokens=2)
    while engine.sched.has_work():
        engine.tick()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    log(f"warm: captures {[(k, round(ms, 1)) for _, k, ms in engine.capture_log()]}")


class Driver:
    def __init__(self, engine, recs: list, trace_ticks: int):
        self.engine = engine
        self.recs = recs
        self.by_rid: dict[int, Rec] = {}
        self.next = 0
        self.t0 = None                            # the window's start, once it has started
        self.trace_ticks = trace_ticks
        self.decode_rows: list[list[int]] = []   # per tick: the decoding rows' contexts
        self.tick_times: list[float] = []
        self.gaps: list[float] = []              # token gaps ending in the window
        self.tokens = 0                           # tokens emitted in the window
        self.pool = engine.blocks
        self.pages_peak = [0, 0]                  # pages held at most: set-up, window

    def submit_due(self, now: float) -> None:
        while self.next < len(self.recs) and self.recs[self.next].due <= now:
            r = self.recs[self.next]
            r.rid = self.engine.submit(r.req.prompt, max_new_tokens=r.req.max_new)
            self.by_rid[r.rid] = r
            self.next += 1

    def tick(self) -> None:
        emitted = self.engine.tick()
        t = time.perf_counter()
        rows = []
        for rid, tok in emitted:
            r = self.by_rid.get(rid)
            if r is None:
                continue
            if r.served:
                rows.append(r.bucket + len(r.served))
            r.served.append(tok)
            if r.first is None:
                r.first = t
            if r.last is not None and self.t0 is not None and t >= self.t0:
                self.gaps.append(t - r.last)
            r.last = t
            if self.t0 is not None and t >= self.t0:
                self.tokens += 1
            r.done = len(r.served) >= r.req.max_new
        self.decode_rows.append(rows)
        self.tick_times.append(t)
        held = self.pool.capacity - self.pool.available
        k = int(self.t0 is not None)
        self.pages_peak[k] = max(self.pages_peak[k], held)

    def run_until(self, until: float, max_ticks: Optional[int] = None) -> int:
        n = 0
        while True:
            now = time.perf_counter()
            if now >= until or (max_ticks is not None and n >= max_ticks):
                return n
            self.submit_due(now)
            if self.engine.sched.has_work():
                self.tick()
                n += 1
            elif self.next < len(self.recs):
                time.sleep(max(0.0, min(self.recs[self.next].due, until) - now))
            else:
                return n


def _counters(m) -> dict:
    return {"decode_time": m.decode_time, "decode_steps": m.decode_steps,
            "occ_sum": m.occupancy_mean * m.decode_steps, "busy": m.wall_time,
            "prefill_tokens": m.prefill_tokens, "prefill_saved": m.prefill_tokens_saved,
            "prefix_hits": m.prefix_hits, "prefix_partial_hits": m.prefix_partial_hits,
            "total_tokens": m.total_tokens}


def _minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def _plus(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


class _Chunks:
    """The engine's prefill entry point as the traced run calls it: each
    call under a ``bench/prefill_chunk`` span, its (q0, tokens, bucket)
    recorded."""

    def __init__(self, fn, log: list):
        self.fn, self.log = fn, log

    def __call__(self, params, cache, state, tokens, row, q0, *rest, **kw):
        self.log.append((time.perf_counter(), int(q0), int(tokens.shape[1]), int(kw["bucket"])))
        with TR.span("bench/prefill_chunk"):
            return self.fn(params, cache, state, tokens, row, q0, *rest, **kw)

    def __getattr__(self, name):
        return getattr(self.fn, name)


def run(cell: dict, conf: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        trace: bool, t_proc: float, log, device="cuda", fault=None, check: bool = True,
        keep: bool = False) -> dict:
    """One run of a serving cell; returns the result line's parts.
    ``fault`` (tests) is called with the engine before the window;
    ``check=False`` (the rate sweep) skips the output check; ``keep`` (the
    calibration) also returns the weights and the checked requests."""
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    dev = torch.device(device)
    seed32 = seed & 0xFFFFFFFF
    fam = common.by_name("families", conf["family"])
    mcfg = fam.model_config(conf, traffic)
    params = fam.make_weights(mcfg, seed, dev)
    log(f"weights made at {time.perf_counter() - t_proc:.2f} s")
    eng = traffic["engine"]
    scfg = ServeConfig(seed=seed32, max_new_tokens=1, **eng)
    bs_list = CK.buckets(eng)
    reqs = TG.requests(traffic, mcfg.vocab, seed, seconds)
    engine = ServingEngine(params, mcfg, scfg, device=dev)
    log(f"engine built at {time.perf_counter() - t_proc:.2f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    recs = [Rec(req=q, due=0.0, bucket=CK.bucket_of(len(q.prompt), bs_list)) for q in reqs]
    _warm(engine, mcfg, scfg, traffic, recs, seed, log)
    if trace:
        TR.warm_profiler(dev.type == "cuda")
    log(f"set-up so far {time.perf_counter() - t_proc:.2f} s (weights, engine, warm-up)")
    if fault is not None:
        fault(engine)
    lead = float(traffic.get("lead_s", 0.0))
    drv = Driver(engine, recs, int(traffic.get("trace_ticks", 20)))
    chunks: list = []
    if trace:
        engine._suffix_prefill = _Chunks(engine._suffix_prefill, chunks)
    # the set-up's objects out of the collector's way: a full collection
    # over them would stall a tick in the window; collected before the
    # lead-in, so that the collection itself holds up no due request
    gc.collect()
    gc.freeze()
    t_lead = time.perf_counter()
    if traffic["loop"] == "open":
        for r in recs:
            r.due = t_lead + lead + r.req.due
        drv.run_until(t_lead + lead)
    else:
        for r in recs:
            r.due = t_lead
        drv.submit_due(t_lead)
        for _ in range(4 * scfg.max_batch):
            if sum(1 for r in recs if r.served and not r.done) >= min(scfg.max_batch, len(recs)):
                break
            drv.tick()
    captures0 = len(engine.capture_log())
    queued0 = sum(1 for r in recs[:drv.next] if r.first is None)
    m0 = _counters(engine.metrics())
    t0 = drv.t0 = time.perf_counter()
    setup_s = t0 - t_proc
    n_ticks0 = len(drv.tick_times)
    stretch = None
    if trace:
        drv.run_until(t0 + seconds * float(traffic.get("trace_at", 0.4)))
        ma = _counters(engine.metrics())
        ka, ca = len(drv.tick_times), len(chunks)
        t_a = time.perf_counter()
        with TR.Stretch(cuda=dev.type == "cuda") as st:
            with TR.span("bench/stretch"):
                drv.run_until(t0 + seconds, max_ticks=drv.trace_ticks)
        mb = _counters(engine.metrics())
        kb, cb = len(drv.tick_times), len(chunks)
    drv.run_until(t0 + seconds)
    t_end = max(time.perf_counter(), t0 + seconds)
    m1 = _counters(engine.metrics())
    window = t_end - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    captures_in_window = len(engine.capture_log()) - captures0
    ttft, attempted = ttft_ms(recs, t0, t_end, traffic["loop"])
    done_reasons = {}
    for req in engine.sched.all_requests():
        if req.rid in drv.by_rid and req.done_reason:
            done_reasons[req.done_reason] = done_reasons.get(req.done_reason, 0) + 1
    failed = sum(v for k, v in done_reasons.items() if k not in ("length", "eos"))
    itl = [g * 1e3 for g in drv.gaps]
    e2e = {
        "ttft_p95_ms": common.percentile(ttft, 95),
        "itl_p95_ms": common.percentile(itl, 95),
        "itl_p99_ms": common.percentile(itl, 99),
        "output_tok_per_s": drv.tokens / window,
    }
    queued1 = sum(1 for r in recs[:drv.next] if r.first is None)
    log(f"window {window:.3f} s: {attempted} requests due, {drv.tokens} tokens, "
        f"{len(drv.gaps)} gaps, ticks {len(drv.tick_times) - n_ticks0}, "
        f"ttft p50 {common.percentile(ttft, 50)} ms, itl p50 "
        f"{common.percentile([g * 1e3 for g in drv.gaps], 50)} ms, done {done_reasons}, "
        f"captures in window {captures_in_window}, waiting for a first token at start "
        f"{queued0} and at end {queued1}")
    log(f"engine counters over the window: {_minus(m1, m0)}")
    page_b = 2 * mcfg.n_layers * scfg.kv_block_size * mcfg.n_kv_heads * mcfg.head_dim \
        * torch.tensor([], dtype=getattr(torch, mcfg.dtype)).element_size()
    pool = drv.pool.capacity
    log(f"kv pool: {pool} pages of {page_b} B = {pool * page_b / 1e9:.3f} GB; held at most "
        f"{drv.pages_peak[1]} in the window ({drv.pages_peak[1] * page_b / 1e9:.3f} GB, "
        f"{100.0 * drv.pages_peak[1] / pool:.1f}%), {drv.pages_peak[0]} in set-up; "
        f"memory peak {peak / 1e9:.3f} GB")
    log("percentiles (p50, p90, p95, p99): ttft_ms "
        f"{[common.percentile(ttft, q) for q in (50, 90, 95, 99)]} itl_ms "
        f"{[common.percentile(itl, q) for q in (50, 90, 95, 99)]}")
    ctx = None
    if trace:
        stretch = st.reduce()
        rest = _plus(_minus(m1, mb), _minus(ma, m0))
        rows_out = drv.decode_rows[n_ticks0:ka] + drv.decode_rows[kb:]
        chunks_out = [c for c in chunks[:ca] if c[0] >= t0] + chunks[cb:]
        # the requests due before the stretch: the profiler slows the host
        # while it records, and the queue it leaves takes some seconds to drain
        ttft_pre, _ = ttft_ms([r for r in recs if r.due < t_a], t0, t_end, traffic["loop"])
        ctx = Context(mcfg=mcfg, counters=rest, decode_rows=rows_out, prefill_chunks=chunks_out,
                      stretch=stretch, stretch_rows=drv.decode_rows[ka:kb],
                      stretch_chunks=chunks[ca:cb], ttft_ms=ttft_pre)
        log(f"traced stretch: {kb - ka} ticks, {cb - ca} prefill chunks, "
            f"{stretch['window_s']:.4f} s, busy {stretch['busy_s']:.4f} s")
    records = [{"rid": r.rid, "prompt": r.req.prompt, "served": list(r.served), "done": r.done}
               for r in recs[:drv.next]]
    drv_pages = drv.pages_peak[1]
    del drv, engine
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"setup_s": setup_s, "e2e": e2e, "attempted": attempted, "failed": failed,
           "peak": peak, "ctx": ctx, "stretch": stretch, "queued": (queued0, queued1),
           "captures_in_window": captures_in_window, "pages": (pool, drv_pages)}
    if not check:
        return out
    chk = traffic["check"]
    picked = CK.sample(records, seed, chk["requests"], chk["min_tokens"])
    t_chk = time.perf_counter()
    gaps = CK.readings(params, fam.reference, conf, traffic, picked, seed32)
    name, value = CK.number(traffic["sampler"], gaps)   # None: nothing served to compare
    log(f"check: {len(picked)} requests, {sum(len(r['served']) for r in picked)} tokens "
        f"(longest {max((len(r['served']) for r in picked), default=0)}), per request widest "
        f"{[round(max(g), 4) for g in gaps]} and mean {[round(sum(g) / len(g), 5) for g in gaps]}, "
        f"{time.perf_counter() - t_chk:.1f} s")
    limit = limits.get(name)             # None until the limit is set (calibration)
    compared = {name: {"value": value, "limit": limit}}
    correct = value is not None and limit is not None and value <= limit and failed == 0
    out.update(compared=compared, correct=correct, readings=gaps)
    if keep:
        out.update(params=params, picked=picked)
    return out


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the engine's counters over the
    window less the traced stretch, the decoding rows' contexts of each
    tick and the prefill chunks there; the stretch's reduced trace and its
    rows and chunks; the TTFT of the requests due before the stretch."""
    mcfg: object
    counters: dict
    decode_rows: list
    prefill_chunks: list
    stretch: dict
    stretch_rows: list
    stretch_chunks: list
    ttft_ms: list = dataclasses.field(default_factory=list)
    roofline: object = RF
