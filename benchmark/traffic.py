"""The one traffic generator: turns a traffic mix (``traffic/<mix>.json``)
and a seed into the work of a run.

A mix's keys:

- ``entry``: what drives the program (``entries/<entry>.py``); ``loop``: "closed" (the
  next batch goes when the last returns) or "open" (requests go at their due
  times whatever the system does);
- ``pool``, ``pool_segments``: held-out target utterances and their length
  in generator segments (0.15 s each);
- ``epochs``: the target lengths in epochs, log-normal with ``median`` and
  ``sigma``, cut to [``min``, ``max``] (``sigma`` 0: every target ``median``
  epochs long); a target is the first that many epochs of its utterance;
- ``batch`` (closed loop): utterances a call; ``rate_per_s`` (open loop):
  the Poisson rate of requests; ``voices``: ``{"zipf_s": s}`` gives the
  requests (open loop) or each call's utterances (closed loop) voices in
  shares of ``1 / rank^s`` over the configuration's voices (without the
  key, or with one voice: always voice 0);
- ``greedy``: the decode; ``sample``: answers the reference searches
  itself, besides the longest; ``drain_s``: how long answers are waited for
  after the window.

Every seed gets the same work: lengths are the quantiles of the length
distribution and voices come in exact Zipf shares (in a closed loop, within
every call, drawn from a generator of their own, so that the picks and
lengths are those of a mix without ``voices``), in an order the seed draws,
with utterances the seed picks; the gaps between arrivals are the quantiles
of the exponential at the mix's rate, in one fixed order for every seed (so
the queue's course does not turn on the seed).  Seeds change the inputs,
not the amount or the timing of the work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Ask:
    """One utterance asked of the system: target utterance ``pool`` cut to
    ``epochs`` epochs, of voice ``voice``, due at ``due_s`` into the window
    (open loop)."""
    pool: int
    epochs: int
    voice: int
    due_s: float = 0.0


def _rng(seed: int, tag: str) -> np.random.Generator:
    s = int(seed) % 2 ** 64
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, *tag.encode()])


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` target lengths in epochs: the distribution's quantiles, permuted."""
    if spec.get("sigma", 0) == 0:
        return np.full(n, int(spec["median"]), np.int64)
    q = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    e = np.exp(math.log(spec["median"]) + spec["sigma"] * np.asarray(q))
    e = np.clip(np.rint(e), spec["min"], spec["max"]).astype(np.int64)
    return rng.permutation(e)


def voices_of(spec: dict | None, n_voices: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` voice ids in exact Zipf shares (largest remainders), permuted."""
    if not spec or n_voices == 1:
        return np.zeros(n, np.int64)
    w = 1.0 / np.arange(1, n_voices + 1) ** spec["zipf_s"]
    share = n * w / w.sum()
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(-(share - counts), kind="stable")[: n - counts.sum()]] += 1
    return rng.permutation(np.repeat(np.arange(n_voices), counts))


def batches(traffic: dict, seed: int, n_voices: int):
    """Closed loop: calls of ``batch`` utterances without end, each drawn
    without repeats from the pool, over ``n_voices`` voices."""
    rng, voice_rng = _rng(seed, "batches"), _rng(seed, "batch_voices")
    b = traffic["batch"]
    while True:
        picks = rng.permutation(traffic["pool"])[:b]
        ep = lengths(traffic["epochs"], b, rng)
        vo = voices_of(traffic.get("voices"), n_voices, b, voice_rng)
        yield [Ask(int(p), int(e), int(v)) for p, e, v in zip(picks, ep, vo)]


def arrivals(traffic: dict, seed: int, seconds: float, n_voices: int,
             rate: float | None = None) -> list:
    """Open loop: the requests due in ``[0, seconds)``, in due order."""
    rate = float(rate or traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = _rng(0, "arrivals").permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    rng = _rng(seed, "arrivals")
    ep = lengths(traffic["epochs"], n, rng)
    vo = voices_of(traffic.get("voices"), n_voices, n, rng)
    picks = rng.integers(0, traffic["pool"], n)
    return [Ask(int(p), int(e), int(v), float(d))
            for p, e, v, d in zip(picks, ep, vo, due) if d < seconds]


def sample(n_answers: int, longest: int, k: int, seed: int) -> list:
    """``k`` answer indices drawn from the seed, with the longest answer."""
    rng = _rng(seed, "sample")
    picks = set(rng.permutation(n_answers)[:k].tolist())
    picks.add(int(longest))
    return sorted(picks)
