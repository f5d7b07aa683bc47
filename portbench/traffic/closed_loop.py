"""Closed-loop traffic: an evaluation job keeps a fixed number of requests
in the engine, each finished request replaced by the job's next one.

A mix file (``traffic/<mix>.json``, ``"kind": "closed_loop"``) gives the
distributions of prompt and output lengths and ``cycle_waves`` (W, default
1).  The stream of requests is cut into groups of ``group`` (the engine's
``max_batch``: the wave an engine taking its queue in order would form) and
cycles of W groups.  Each distribution is cut into ``group`` coarse strata
of equal probability, each of them into W fine ones, and a cycle holds the
middle quantile of every fine stratum once: group ``g`` takes one length
from each coarse stratum.  In the top coarse stratum group ``g`` takes the
``g``-th fine length, so the cycle's waves grow in a fixed order; in the
others the seed deals the fine lengths to the groups.  The seed also pairs
prompts with outputs, orders each group and draws the prompt tokens.  So
every cycle of every seed holds the same lengths and the same longest
prompt and answer in each of its groups (the same padded work), while the
waves within a cycle differ from one another.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["quantile", "fine_lengths", "cycle_lengths", "requests", "WARMUP_STREAM"]

# The stream of the warm-up: no cycle of the window draws from it.
WARMUP_STREAM = 2 ** 32 - 1


def quantile(dist: Dict, u: float) -> int:
    """The length at quantile ``u`` of ``dist``, rounded to a whole token."""
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "log_uniform":
        return int(round(lo * (hi / lo) ** u))
    if dist["dist"] == "uniform":
        return int(round(lo + u * (hi - lo)))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def fine_lengths(dist: Dict, group: int, cycle: int) -> np.ndarray:
    """(group, cycle) lengths: row ``s`` the middle quantiles of the fine
    strata of coarse stratum ``s``, ascending."""
    n = group * cycle
    return np.array([quantile(dist, (i + 0.5) / n) for i in range(n)]).reshape(group, cycle)


def _deal(rng: np.random.Generator, fine: np.ndarray) -> np.ndarray:
    """(cycle, group) lengths: column ``s`` the fine lengths of coarse
    stratum ``s`` dealt to the groups, the top stratum's in order."""
    group, cycle = fine.shape
    order = [rng.permutation(cycle) for _ in range(group - 1)] + [np.arange(cycle)]
    return np.stack([fine[s, order[s]] for s in range(group)], axis=1)


def cycle_lengths(mix: Dict, group: int, rng: np.random.Generator
                  ) -> List[List[Tuple[int, int]]]:
    """One cycle's groups of (prompt length, output length)."""
    cycle = int(mix.get("cycle_waves", 1))
    prompts = _deal(rng, fine_lengths(mix["prompt_tokens"], group, cycle))
    outputs = _deal(rng, fine_lengths(mix["output_tokens"], group, cycle))
    out = []
    for p, o in zip(prompts, outputs):
        pairs = list(zip(p.tolist(), rng.permutation(o).tolist()))
        out.append([pairs[i] for i in rng.permutation(group)])
    return out


def requests(mix: Dict, group: int, seed: int, vocab: int,
             stream_start: int = 0) -> Iterator[Tuple[np.ndarray, int]]:
    """(prompt tokens, output length) requests in the job's order, cycle
    ``i`` drawn from the stream ``(seed, stream_start + i)`` alone."""
    if mix.get("kind") != "closed_loop":
        raise ValueError(f"closed_loop cannot generate a {mix.get('kind')!r} mix")
    for i in itertools.count(stream_start):
        rng = np.random.default_rng([seed % 2 ** 64, i])
        for wave in cycle_lengths(mix, group, rng):
            for n, m in wave:
                yield rng.integers(0, vocab, n, dtype=np.int32), m
