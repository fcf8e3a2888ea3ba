"""The traffic generator: seeded, the same work for every seed, and the
port's profiles frozen."""

import json
import sys
from collections import Counter
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from servebench import traffic as tr  # noqa: E402

MIXES = sorted(p.stem for p in (ROOT / "servebench" / "traffic").glob("*.json"))


def _mix(name):
    return tr.load_mix(ROOT / "servebench" / "traffic" / f"{name}.json")


def _rows(sched):
    return [(q.rid, q.due, q.prompt, q.input_len, q.output_len, q.block) for q in sched.requests]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = _mix(mix)
    a = tr.build_schedule(m, 2**31 + 77, 12.0, n_slots=64, max_total=12287)
    b = tr.build_schedule(m, 2**31 + 77, 12.0, n_slots=64, max_total=12287)
    assert _rows(a) == _rows(b)
    q = a.requests[0]
    assert (tr.prompt_tokens(q, 2**31 + 77, 1000).tolist()
            == tr.prompt_tokens(q, 2**31 + 77, 1000).tolist())


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_send_the_same_work_in_another_order(mix):
    m = _mix(mix)
    a = tr.build_schedule(m, 11, 12.0, n_slots=64, max_total=12287)
    b = tr.build_schedule(m, 2**31 + 5, 12.0, n_slots=64, max_total=12287)
    for block in ("prelude", "window", "refill"):
        sa = [q for q in a.requests if q.block == block]
        sb = [q for q in b.requests if q.block == block]
        assert [q.due for q in sa] == [q.due for q in sb]
        key = lambda q: (q.input_len, q.output_len, q.cluster)  # noqa: E731
        assert Counter(map(key, sa)) == Counter(map(key, sb))
    assert [q.input_len for q in a.requests] \
        != [q.input_len for q in b.requests]
    assert tr.history_records(m) == tr.history_records(m)


def test_poisson_schedule_rate_and_prelude():
    m = _mix("mix-poisson")
    s = tr.build_schedule(m, 3, 60.0, n_slots=128, max_total=12287)
    win = [q for q in s.requests if q.block == "window"]
    pre = [q for q in s.requests if q.block == "prelude"]
    assert all(0 <= q.due < 60.0 for q in win)
    assert all(-m["prelude_s"] <= q.due < 0 for q in pre)
    rate = len(win) / 60.0
    assert abs(rate - m["rate_rps"]) < 0.25 * m["rate_rps"]
    assert all(q.input_len + q.output_len <= 12287 for q in s.requests)


def test_backlog_schedule_depth():
    m = _mix("mix-backlog")
    s = tr.build_schedule(m, 3, 30.0, n_slots=64, max_total=12287)
    first = [q for q in s.requests if q.block == "prelude"]
    assert len(first) == 64 + s.backlog == 64 * (1 + m["backlog_per_slot"])
    assert sum(q.block == "refill" for q in s.requests) == m["refill_pool"]


def test_profiles_frozen_from_the_port():
    from repro_torch.simulator.workload import make_profile
    for name in tr.PROFILE_NAMES:
        ours = tr.make_profile(name, 12)
        theirs = make_profile(name, 12).clusters
        for a, b in zip(ours, theirs, strict=True):
            assert (a.template, list(a.vocab), a.input_mu, a.input_sigma,
                    a.output_mu, a.output_sigma, a.short_prob) == (
                b.template, list(b.vocab), b.input_mu, b.input_sigma,
                b.output_mu, b.output_sigma, b.short_prob)


def test_mix_files_name_their_keys():
    for mix in MIXES:
        m = json.loads((ROOT / "servebench" / "traffic" / f"{mix}.json")
                       .read_text())
        assert m["kind"] in ("poisson", "backlog")
        assert m["temperature"] > 0          # every request sampled
