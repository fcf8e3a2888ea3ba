"""Scheduler core of the port (repro_torch.core) against the reference
(repro.core).

The core is host numpy in both packages, so the bar is bit identity: the
same seeded workload through both Schedulers gives the same ``order()``,
the same eviction order, the same priorities and the same ``stats``.  The
port's ``"cuda"`` backend (on the CPU: the plain torch version of the
Gittins kernel) is held to the numpy float64 oracle at rtol 1e-4, and the
plain Gittins version to the Pallas kernel in interpret mode at 1e-5.
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.kernels.gittins.ops import gittins_attained_op as jax_gittins_op
from repro_torch.kernels.gittins.ops import (PAD_SUPPORT,
                                             gittins_attained_op)

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

TOPICS = ["summarize the quarterly report", "write a short story about",
          "explain this python code", "translate the phrase into french",
          "list the steps to bake bread"]


def _drive(core, policy_name: str, backend, seed: int = 5):
    """A seeded admit / progress / complete / order workload; returns every
    observable of the scheduler along the way."""
    rng = np.random.default_rng(seed)
    sched = core.Scheduler(policy=core.make_policy(policy_name),
                           bucket_size=40, priority_backend=backend)
    seen, live, rid = [], {}, 0
    for step in range(12):
        sched.set_now(float(step))
        burst = int(rng.integers(1, 5))
        ids, prompts, lens = [], [], []
        for _ in range(burst):
            ids.append(f"r{rid}")
            prompts.append(f"{TOPICS[rid % len(TOPICS)]} {rid % 7}")
            lens.append(int(rng.integers(4, 900)))
            live[f"r{rid}"] = 0
            rid += 1
        sched.admit_batch(ids, prompts, lens,
                          arrivals=[float(step)] * burst)
        prog = [r for r in live if rng.random() < 0.7]
        for r in prog:
            live[r] += int(rng.integers(1, 60))
        sched.on_progress_many(prog, [live[r] for r in prog])
        done = [r for r in live if live[r] > 150 and rng.random() < 0.5]
        for r in done:
            sched.on_complete(r, live.pop(r))
        running = set(list(live)[:3])
        seen.append(("order", sched.order(list(live), running=running,
                                          hysteresis=0.5)))
        if len(live) > 1:
            held = {r: float(16 * (1 + i)) for i, r in enumerate(live)}
            seen.append(("evict", sched.eviction_order(
                list(live), held_tokens=held, swap_cost=lambda t: t * 1e-4,
                memory_weight=0.5)))
    seen.append(("priority", [float(sched.get(r).priority) for r in live]))
    seen.append(("stats", dict(sched.stats)))
    return seen


@pytest.mark.parametrize("policy_name", list(ref_core.POLICY_NAMES))
def test_scheduler_bit_identical_to_reference(policy_name):
    want = _drive(ref_core, policy_name, "numpy")
    got = _drive(port_core, policy_name, "numpy")
    assert got == want


def test_object_backend_bit_identical_to_reference():
    assert _drive(port_core, "sagesched", "object") == \
        _drive(ref_core, "sagesched", "object")


def test_policy_and_backend_names():
    assert port_core.POLICY_NAMES == ref_core.POLICY_NAMES
    assert port_core.BACKEND_NAMES == ("object", "numpy", "cuda")
    b = port_core.make_priority_backend("cuda", device="cpu")
    assert isinstance(b, port_core.CudaPriorityBackend) and b.name == "cuda"
    with pytest.raises(KeyError):
        port_core.make_priority_backend("pallas")


@pytest.mark.parametrize("k_real,k", [(6, 16), (12, 12), (40, 64)])
def test_gittins_math_bit_identical(k_real, k):
    """core.gittins batch and scalar indices, numpy in both packages."""
    rng = np.random.default_rng(k_real + k)
    n = 50
    sup = np.sort(rng.uniform(1, 1e5, (n, k_real)), axis=1)
    probs = rng.dirichlet(np.ones(k_real), n)
    sup = np.pad(sup, ((0, 0), (0, k - k_real)), mode="edge")
    probs = np.pad(probs, ((0, 0), (0, k - k_real)))
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)
    for fn in ("gittins_index_batch", "mean_index_batch"):
        assert np.array_equal(getattr(port_core, fn)(sup, probs, att),
                              getattr(ref_core, fn)(sup, probs, att))


def _rows(seed, n, k_real, k, pad):
    rng = np.random.default_rng(seed)
    sup = np.sort(rng.uniform(1, 1e5, (n, k_real)), axis=1)
    probs = rng.dirichlet(np.ones(k_real), n)
    sup = np.pad(sup, ((0, 0), (0, k - k_real)), constant_values=pad)
    probs = np.pad(probs, ((0, 0), (0, k - k_real)))
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)  # some exhausted
    return sup, probs, att


@pytest.mark.parametrize("n,k_real,k", [(33, 6, 16), (100, 12, 12),
                                        (7, 30, 64)])
@pytest.mark.parametrize("pad", [PAD_SUPPORT, np.inf])
def test_plain_gittins_vs_pallas(n, k_real, k, pad):
    """Ragged rows (dead columns with +inf or the finite pad) and
    exhausted rows: plain torch version vs the Pallas kernel, both f32."""
    sup, probs, att = _rows(n + k, n, k_real, k, pad)
    want = np.asarray(jax_gittins_op(sup, probs, att, force_pallas=True))
    got = gittins_attained_op(sup, probs, att, device="cpu").numpy()
    assert got.shape == (n,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_backend_on_cpu_close_to_numpy(seed):
    sup, probs, att = _rows(seed, 200, 10, 16, PAD_SUPPORT)
    got = port_core.CudaPriorityBackend(device="cpu").gittins(sup, probs,
                                                              att)
    want = port_core.NumpyPriorityBackend().gittins(sup, probs, att)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_scheduler_with_cuda_backend_on_cpu_close_to_oracle():
    """The "cuda" backend slots into the Scheduler's refresh protocol and
    lands within f32 tolerance of the float64 oracle."""
    want = port_core.Scheduler(policy="sagesched", bucket_size=40,
                               priority_backend="object")
    got = port_core.Scheduler(
        policy="sagesched", bucket_size=40,
        priority_backend=port_core.CudaPriorityBackend(device="cpu"))
    rng = np.random.default_rng(6)
    for i in range(40):
        il = int(rng.integers(1, 1500))
        for s in (want, got):
            s.admit(f"r{i}", f"{TOPICS[i % 5]} {i % 9}", il,
                    arrival=float(i))
    for i in range(40):
        g = int(rng.integers(0, 400))
        for s in (want, got):
            s.on_progress(f"r{i}", g)
    assert got.refresh() > 0
    p_want = np.array([want.get(f"r{i}").priority for i in range(40)])
    p_got = np.array([got.get(f"r{i}").priority for i in range(40)])
    np.testing.assert_allclose(p_got, p_want, rtol=1e-4)
