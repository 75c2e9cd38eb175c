"""The one traffic generator: a traffic file's parameters and ``--seed``
give the requests of a run.

Every seed gets the same multiset of sizes and of gaps between arrivals,
in its own order (:func:`arrange`, stratified by ``strata``): lengths are
the quantiles ``(i + ½)/n`` of the mix's clipped lognormal, arrival gaps
the same quantiles of an exponential, scaled so that the ``n`` arrivals
fill the lead-in and the window at the mix's rate.  So the work a run offers does not move with the seed; which
request is long, when it comes, and its token ids (uniform over the
vocabulary) do.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Request:
    due: float          # seconds from the window's start (negative: lead-in)
    prompt: list[int]
    max_new: int


def _quantiles(n: int) -> list[float]:
    return [(i + 0.5) / n for i in range(n)]


def arrange(values: list, rng, strata: int) -> list:
    """``values`` (ascending) in an order drawn from ``rng``: in blocks of
    ``strata`` consecutive places, one value from each of ``strata`` equal
    ranges of the sorted values, in random order (``strata`` 1: a plain
    permutation).  Every stretch of the run then holds its share of short
    and long requests and gaps, so a tail depends less on where chance
    puts a cluster."""
    n = len(values)
    k = max(1, min(int(strata), n))
    groups = [rng.permutation(values[i * n // k:(i + 1) * n // k]).tolist() for i in range(k)]
    out = []
    for b in range(max(len(g) for g in groups)):
        block = [g[b] for g in groups if b < len(g)]
        out.extend(block[j] for j in rng.permutation(len(block)))
    return out


def lengths(spec: dict, n: int) -> list[int]:
    """``n`` lengths: lognormal quantiles around ``median`` with
    ``sigma``, clipped to [``min``, ``max``]."""
    nd = NormalDist()
    out = []
    for p in _quantiles(n):
        x = spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(p))
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def requests(traffic: dict, vocab: int, seed: int, seconds: float) -> list[Request]:
    """The run's requests in order of their due times.  An open loop
    (``"loop": "open"``) spreads ``round(rate · (lead + seconds))`` arrivals
    over ``[−lead, seconds)``; a backlog (``"loop": "backlog"``) is
    ``backlog`` requests all due at the lead-in's start, of which the first
    ``in_progress`` are met part-way through their outputs."""
    rng = np.random.Generator(np.random.PCG64(seed))
    lead = float(traffic.get("lead_s", 0.0))
    strata = int(traffic.get("strata", 1))
    if traffic["loop"] == "open":
        n = max(1, round(traffic["rate_rps"] * (lead + seconds)))
        gaps = np.array([-math.log(1.0 - p) for p in _quantiles(n)])
        gaps *= (lead + seconds) / gaps.sum()
        gaps = np.array(arrange(gaps.tolist(), rng, strata))
        due = (-lead + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])).tolist()
    elif traffic["loop"] == "backlog":
        n = int(traffic["backlog"])
        due = [-lead] * n
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    plen = arrange(lengths(traffic["prompt_tokens"], n), rng, strata)
    k = int(traffic.get("in_progress", 0))
    olen = arrange(lengths(traffic["output_tokens"], n - k), rng, strata)
    if k:
        # a backlog met in its steady state: the first k requests are
        # part-way through their outputs, a uniform share of each left
        full = lengths(traffic["output_tokens"], k)
        left = [max(1, round(q * o)) for q, o in zip(_quantiles(k), full[::2] + full[1::2][::-1])]
        olen = rng.permutation(left).tolist() + olen
    return [Request(due=d, prompt=rng.integers(0, vocab, size=p).tolist(), max_new=o)
            for d, p, o in zip(due, plen, olen)]

