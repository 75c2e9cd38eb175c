"""What decides ``correct`` for a served model: a sample, drawn from the
seed, of the requests the run served (the one with the most served tokens
always in it), run through the plain reference over each prompt and its
served tokens; each served token reads the gap by which it falls short of
the reference's choice, in logit units, and :func:`number` makes of them
the number compared.

Greedy: the reference's best logit minus the served token's, and the
number is their mean over the sample (``logit_gap_mean``): a sound bf16
program reads 0 on all but the few tokens where its argmax and the
reference's nearly tie, so the mean separates it from a lower precision,
which parts from the reference more often and by more, where the widest
gap of one near tie did not (``PERF.md``).  WTA: under
the request's own threefry noise, the least logit error with which the
served token could win the vote of its trials, ties to the lowest id
(``reference/wta.vote_gap``): a trial whose winner leads by more than that
error votes as the reference's does, so a sampler that tallies wrongly, or
runs fewer trials, reads the error it would need.  Either reading is at
most twice the largest error of the program's logits, and a token the
sampler would not have chosen reads the gap to the choice; the number is
the widest over the sample (``wta_gap``).

The control (``control=True``) is the reference in fp8 e4m3 in the
program's place: at each position of the same prompts and tokens, the
token the fp8 model chooses, read the same way under the f32 reference.
"""

from __future__ import annotations

import random

import torch

from .reference import threefry as TF
from .reference import wta as RW


def buckets(engine: dict) -> list[int]:
    """The prompt buckets of a serve configuration: the engine's default,
    the powers of two from 8 below ``max_len`` and ``max_len`` itself."""
    if engine.get("prefill_buckets"):
        raise NotImplementedError("prefill_buckets: the check knows the default buckets only")
    max_len = engine["max_len"]
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    return out + [max_len]


def bucket_of(n: int, bs: list[int]) -> int:
    return next(b for b in bs if b >= n)


def prefill_groups(bucket: int, engine: dict) -> list[tuple[int, int]]:
    """The token groups of a prompt's prefill calls: chunks of
    ``prefill_chunk`` on the grid from position 0 (or the whole bucket)."""
    c = engine.get("prefill_chunk") or bucket
    return [(q0, min(q0 + c, bucket)) for q0 in range(0, bucket, c)]


def sample(records: list[dict], seed: int, n_requests: int, min_tokens: int) -> list[dict]:
    """Finished requests first, then those still running; the finished
    one with the most served tokens always (the longest running one if none
    finished), the rest in an order drawn from the seed, until at least
    ``n_requests`` requests and ``min_tokens`` served tokens are in."""
    served = [r for r in records if r["served"]]
    if not served:
        return []
    longest = max(served, key=lambda r: (r["done"], len(r["served"])))
    rest = [r for r in served if r is not longest]
    rng = random.Random(seed ^ 0x5EED5EED)
    rng.shuffle(rest)
    rest.sort(key=lambda r: not r["done"])
    out, tokens = [longest], len(longest["served"])
    for r in rest:
        if len(out) >= n_requests and tokens >= min_tokens:
            break
        out.append(r)
        tokens += len(r["served"])
    return out


def _gaps(z: torch.Tensor, tokens: torch.Tensor, sampler: dict, keys) -> torch.Tensor:
    if sampler["kind"] == "greedy":
        return z.max(dim=-1).values - z.gather(1, tokens[:, None])[:, 0]
    return RW.vote_gap(RW.race(z, keys, sampler["trials"], sampler["beta"], tokens), tokens)


def _choice(z: torch.Tensor, sampler: dict, keys) -> torch.Tensor:
    if sampler["kind"] == "greedy":
        return z.argmax(dim=-1)
    return RW.vote_winner(RW.race(z, keys, sampler["trials"], sampler["beta"], z.argmax(dim=-1)))


def number(sampler: dict, gaps: list[list[float]]) -> tuple[str, float]:
    """(name, value) of the number compared, from the per-token gaps of
    each sampled request; ``None`` where nothing was served."""
    flat = [g for r in gaps for g in r]
    if sampler["kind"] == "wta":
        return "wta_gap", (max(flat) if flat else None)
    return "logit_gap_mean", (sum(flat) / len(flat) if flat else None)


@torch.no_grad()
def readings(params: dict, ref, conf: dict, traffic: dict, records: list[dict], seed32: int,
             control: bool = False) -> list[list[float]]:
    """The per-token gaps of each sampled request (``records`` as
    :func:`sample` returns them), against the plain reference module
    ``ref`` of the configuration ``conf``."""
    engine, sampler = traffic["engine"], traffic["sampler"]
    sizes = ref.Sizes.from_config(conf)
    if sizes.n_experts and engine.get("enable_prefix_sharing", True):
        raise ValueError("an MoE cell's prefill groups are known only without prefix sharing")
    bs = buckets(engine)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for r in records:
            bucket = bucket_of(len(r["prompt"]), bs)
            seq = [0] * (bucket - len(r["prompt"])) + list(r["prompt"]) + list(r["served"][:-1])
            groups = prefill_groups(bucket, engine)
            z = ref.logits(params, sizes, seq, bucket - 1, groups)
            dev = z.device
            served = torch.tensor(r["served"], dtype=torch.long, device=dev)
            keys = None
            if sampler["kind"] == "wta":
                base = TF.fold_in(TF.prng_key(seed32), r["rid"])
                keys = torch.tensor([TF.fold_in(base, j) for j in range(len(r["served"]))],
                                    dtype=torch.int64, device=dev)
            if control:
                zc = ref.logits(params, sizes, seq, bucket - 1, groups, quant="fp8")
                served = _choice(zc, sampler, keys)
                del zc
            out.append(_gaps(z, served, sampler, keys).float().cpu().tolist())
            del z
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
