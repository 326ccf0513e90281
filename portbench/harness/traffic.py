"""The one traffic generator: requests and arrivals from a mix's
parameters and the seed.

Every seed gets the same multiset of sizes and gaps, in another order:
a length distribution is cut into ``n`` equal-probability strata and
each request takes one stratum's midpoint, and the seed only orders
them (a permutation drawn from the seed) and draws the prompts' token
ids. So two seeds do the same work, and the spread between runs is the
system's, not the draw's.

A length distribution is ``{"dist": "uniform" | "loguniform", "lo": a,
"hi": b}`` (inclusive bounds, in tokens).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: list[int]
    max_new: int
    #: seconds after the window opens at which an open loop sends it
    due: float = 0.0
    #: the closed-loop client that sends it
    client: int = 0


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of the seed's ``stream``-th sequence."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def stratified(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths, the midpoints of ``n`` equal-probability strata of
    ``dist``, in increasing order."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _order(values: np.ndarray, seed: int, stream: int) -> np.ndarray:
    """``values`` in the seed's order."""
    return rng(seed, stream).permutation(values)


def requests(mix: dict, n: int, seed: int, vocab: int) -> list[Request]:
    """``n`` requests of the mix: prompt and output lengths stratified
    and put in the seed's order, prompt ids uniform over ``[1, vocab)``."""
    plen = _order(stratified(mix["prompt"], n), seed, 1)
    olen = _order(stratified(mix["output"], n), seed, 2)
    ids = rng(seed, 3)
    return [Request(i, ids.integers(1, vocab, int(p)).tolist(), int(o))
            for i, (p, o) in enumerate(zip(plen, olen))]


def open_arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times of a Poisson stream at the mix's rate over ``seconds``:
    ``round(rate · seconds)`` exponential gaps at stratum midpoints, in
    the seed's order, summed."""
    rate = float(mix["rate_per_s"])
    n = max(1, round(rate * seconds))
    u = (np.arange(n) + 0.5) / n
    gaps = _order(-np.log1p(-u) / rate, seed, 4)
    return np.cumsum(gaps) - gaps[0]


def open_mix(mix: dict, seconds: float, seed: int,
             vocab: int) -> list[Request]:
    """The requests of an open loop, each with its due time."""
    due = open_arrivals(mix, seconds, seed)
    reqs = requests(mix, len(due), seed, vocab)
    for r, t in zip(reqs, due):
        r.due = float(t)
    return reqs


def closed_mix(mix: dict, seed: int, vocab: int) -> list[list[Request]]:
    """Each closed-loop client's queue of requests; client ``c`` sends
    its first at ``c · ramp_s / clients`` seconds into the window."""
    clients, per = int(mix["clients"]), int(mix["requests_per_client"])
    reqs = requests(mix, clients * per, seed, vocab)
    ramp = float(mix.get("ramp_s", 0.0))
    queues = []
    for c in range(clients):
        q = reqs[c * per:(c + 1) * per]
        for r in q:
            r.client = c
        q[0].due = c * ramp / clients
        queues.append(q)
    return queues
