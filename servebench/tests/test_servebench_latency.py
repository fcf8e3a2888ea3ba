"""Latency arithmetic of a window: censoring, stalls, unserved requests."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from servebench.latency import (RequestTimes, gap_quantile,  # noqa: E402
                                gaps, ttft_quantile, ttlt_mean,
                                window_tokens)

START, END = 100.0, 130.0


def _fake_run(stall_every=0, stall_s=0.0, seed=0, step=0.01, slots=64):
    """A fake engine: requests due every 0.15 s from 5 s before the window,
    20 to 60 tokens each, at most ``slots`` served at once, one token each
    a step of ``step`` seconds; every ``stall_every``-th step the host
    stalls ``stall_s`` more."""
    rng = np.random.default_rng(seed)
    recs = [RequestTimes(due=START - 5.0 + 0.15 * i)
            for i in range(int(40.0 / 0.15))]
    want = [int(rng.integers(20, 60)) for _ in recs]
    t, k, live, nxt = START - 5.0, 0, [], 0
    while t < END + 5.0:
        while nxt < len(recs) and recs[nxt].due <= t and len(live) < slots:
            live.append(nxt)
            nxt += 1
        k += 1
        t += step + (stall_s if stall_every and k % stall_every == 0
                     else 0.0)
        for i in list(live):
            recs[i].token_stamps.append(t)
            if len(recs[i].token_stamps) == want[i]:
                recs[i].finish = t
                live.remove(i)
    return recs


def test_hand_case():
    recs = [RequestTimes(due=101.0, token_stamps=[101.5, 102.0, 103.0],
                         finish=103.0),
            RequestTimes(due=120.0, token_stamps=[125.0], finish=None),
            RequestTimes(due=129.0),
            RequestTimes(due=90.0, token_stamps=[99.0, 101.0],
                         finish=101.0)]
    # (103 - 101) + (130 - 120) + (130 - 129) over the three due in window
    assert ttlt_mean(recs, START, END) == pytest.approx(13.0 / 3)
    assert ttft_quantile(recs, START, END, 1.0) == pytest.approx(5.0)
    assert sorted(gaps(recs, START, END).tolist()) == pytest.approx(
        [0.5, 1.0, 2.0, 5.0])
    assert window_tokens(recs, START, END) == 5


@pytest.mark.parametrize("seed", [0, 1])
def test_a_stall_raises_every_latency(seed):
    calm = _fake_run(seed=seed)
    stalled = _fake_run(stall_every=20, stall_s=0.05, seed=seed)
    assert ttlt_mean(stalled, START, END) > ttlt_mean(calm, START, END)
    assert ttft_quantile(stalled, START, END, 0.95) \
        > ttft_quantile(calm, START, END, 0.95)
    assert gap_quantile(stalled, START, END, 0.99) \
        > gap_quantile(calm, START, END, 0.99)


@pytest.mark.parametrize("victim", [0, 40, 120, 199])
def test_leaving_a_request_unserved_never_lowers_the_mean(victim):
    recs = _fake_run()
    base = ttlt_mean(recs, START, END)
    starved = list(recs)
    r = recs[victim]
    starved[victim] = RequestTimes(due=r.due)
    assert ttlt_mean(starved, START, END) >= base
    cut = list(recs)
    cut[victim] = RequestTimes(due=r.due, token_stamps=r.token_stamps[:3])
    assert ttlt_mean(cut, START, END) >= base
    assert ttft_quantile(starved, START, END, 0.95) \
        >= ttft_quantile(recs, START, END, 0.95)


def test_an_unfinished_request_counts_its_open_gap():
    recs = [RequestTimes(due=110.0, token_stamps=[111.0, 111.1])]
    assert gaps(recs, START, END).tolist() == pytest.approx([0.1, 19.0 - 0.1])
