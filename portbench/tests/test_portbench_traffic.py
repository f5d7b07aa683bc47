"""The closed-loop generator is a pure function of the seed; every cycle of
every seed holds the same lengths, and the same longest prompt and answer
in each of its groups, while the groups within a cycle differ."""

import itertools
import json

import numpy as np
import pytest

from portbench.harness import BENCH
from portbench.traffic import closed_loop

MIXES = ["eval_score", "gen_long"]


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _groups(mix, group, seed, cycles=2, stream_start=0):
    """``cycles`` cycles of the stream, as lists of groups."""
    n = group * mix["cycle_waves"] * cycles
    reqs = list(itertools.islice(closed_loop.requests(mix, group, seed, 1000, stream_start),
                                 n))
    return [reqs[i:i + group] for i in range(0, n, group)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a = _groups(_mix(mix), 8, 2 ** 31 + 77)
    b = _groups(_mix(mix), 8, 2 ** 31 + 77)
    for ga, gb in zip(a, b):
        for (pa, ma), (pb, mb) in zip(ga, gb):
            assert ma == mb and np.array_equal(pa, pb)


@pytest.mark.parametrize("mix", MIXES)
def test_every_cycle_holds_the_same_work(mix):
    mix = _mix(mix)
    cycle = mix["cycle_waves"]
    prompts = closed_loop.fine_lengths(mix["prompt_tokens"], 8, cycle)
    outputs = closed_loop.fine_lengths(mix["output_tokens"], 8, cycle)
    orders = set()
    for seed in (1, 2, 3 * 2 ** 31 + 5):
        groups = _groups(mix, 8, seed)
        for c in range(2):
            groups_c = groups[c * cycle:(c + 1) * cycle]
            assert sorted(len(p) for g in groups_c for p, _ in g) == sorted(prompts.ravel())
            assert sorted(m for g in groups_c for _, m in g) == sorted(outputs.ravel())
            # group g: the g-th longest prompt and answer of the top strata
            assert [max(len(p) for p, _ in g) for g in groups_c] == list(prompts[-1])
            assert [max(m for _, m in g) for g in groups_c] == list(outputs[-1])
            for g in groups_c:
                assert sorted(np.searchsorted(prompts[:, 0], [len(p) for p, _ in g],
                                              side="right") - 1) == list(range(8))
                assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 1000
                           for p, _ in g)
            orders.add(tuple(len(p) for g in groups_c for p, _ in g))
    assert len(orders) > 1            # the seed deals and orders them


def test_strata_and_bounds():
    mix = _mix("eval_score")
    fine = closed_loop.fine_lengths(mix["prompt_tokens"], 8, 4)
    assert fine.shape == (8, 4) and list(fine.ravel()) == sorted(fine.ravel())
    assert 256 <= fine.min() and fine.max() <= 4000
    assert list(fine[-1]) == [2961, 3227, 3516, 3832]
    dist = {"dist": "uniform", "lo": 64, "hi": 256}
    assert closed_loop.quantile(dist, 0.0) == 64 and closed_loop.quantile(dist, 1.0) == 256
    with pytest.raises(ValueError):
        closed_loop.quantile({"dist": "zipf", "lo": 1, "hi": 2}, 0.5)


def test_warm_up_stream_is_not_a_window_cycle():
    mix = _mix("gen_long")
    warm = _groups(mix, 4, 9, 1, closed_loop.WARMUP_STREAM)[0]
    first = _groups(mix, 4, 9, 1)[0]
    assert any(not np.array_equal(a, b) for (a, _), (b, _) in zip(warm, first))
