"""The engine's decode and prefill steps on their step runners
(repro_torch.serving.step_graphs), and the compile bounds, on the CPU.

On the card each shape key of the fused, orchestrated, chunk and whole
prefill steps is a CUDA graph (tests/test_torch_gpu.py holds graphed
against eager there); on the CPU the same runner runs the step eagerly on
the same static buffers.  Held here:

  * the compile bound, mirroring tests/test_decode_hot_loop.py's churn
    test: the fused keys stay within ``max_fused_compiles()``, a second
    identical wave adds none, and the count equals the reference jit's
    cache size on the same workload (the reference's f32-upcast weights on
    both sides);
  * the runner against the path it replaced (fresh device tensors for
    every input, a ``.cpu()`` of the result): token-identical for
    ``graphs=False`` and ``graphs=True``, greedy and sampled, fused and
    orchestrated, ``decode_steps`` 1 and 4, swap and recompute;
  * buffer reuse: garbage written into every runner buffer between calls
    changes no stream;
  * a plan whose shards sit on more than one card refuses graphs before
    anything is allocated;
  * the launch counts a capture makes are withheld and handed back;
  * the prefill keys: one per pow2 bucket of a recurrent context (the
    mirror of tests/test_decode_hot_loop.py's bucket test), and chunk and
    whole-prefill key counts equal to the reference jit's ``_chunk_fn``
    and ``_prefill_fn`` cache sizes on the same workloads.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serving as ref_serving
import repro_torch.core as port_core
import repro_torch.serving as port_serving
import repro_torch.serving.engine as port_engine
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.kernels.build import launches_withheld
from repro_torch.kernels.decode_attention.ops import (PAGED_DECODE_KERNEL,
                                                      PAGED_LSE_KERNEL)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.step_graphs import StepGraphs, StepRunner

torch.set_num_threads(1)

ARCH = "llama3.2-1b"


def _weights(arch):
    cfg = ref_get_config(arch, reduced=True)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(jax.numpy.asarray, tree), \
        params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


# ------------------------------------------------------- compile bound

# (n_slots, capacity tokens, prompt lengths, new tokens, eos, sampled every
# k-th request or 0): "mirror" is tests/test_decode_hot_loop.py's churn
# workload (one key: every context fits 4 pages); "wide" walks both lane
# buckets of 12 slots, two table buckets and both sampling
# specializations, with every third request sampled (eos off, so that
# lengths, and with them the shapes, follow the schedule alone)
CHURN = {"mirror": (8, 192, (4, 20), (3, 7), 1, 0),
         "wide": (12, 480, (4, 60), (3, 30), -1, 3)}


def _churn(core, serving, get_cfg, build, params, workload):
    """Two identical waves of 12 requests.  Returns the engine, its fused
    compile count after each wave and each wave's greedy streams."""
    n_slots, cap, (plo, phi), (nlo, nn), eos, every = CHURN[workload]
    cfg = get_cfg(ARCH, reduced=True)
    o = core.OraclePredictor()
    kw = {"device": "cpu"} if serving is port_serving else {}
    eng = serving.ServingEngine(
        model=build(cfg),
        scheduler=core.Scheduler(policy=core.make_policy("sagesched"),
                                 predictor=o),
        n_slots=n_slots, max_seq_len=96, capacity_tokens=cap, block_size=8,
        seed=0, step_mode="fused", params=params, **kw)
    counts, streams = [], []
    for tag in ("a", "b"):
        # the same rng each wave: wave b replays wave a's shapes
        rng = np.random.default_rng(11)
        reqs = []
        for i in range(12):
            new = nlo + (i * 5 % nn)
            o.register(f"{tag}{i}", core.LengthDistribution(
                np.array([new]), np.array([1.0])))
            toks = [int(t) for t in rng.integers(3, cfg.vocab_size,
                                                 int(rng.integers(plo, phi)))]
            reqs.append(serving.ServeRequest(
                f"{tag}{i}", f"{tag}{i}", toks, max_new_tokens=new,
                temperature=0.8 if every and i % every == 0 else 0.0,
                eos_token=eos, arrival=float(i) * 1e-3))
        eng.submit_batch(reqs)
        eng.run_until_done(max_steps=8000)
        assert all(r.state == serving.RequestState.FINISHED for r in reqs)
        counts.append(eng.fused_compile_count)
        streams.append([r.output_tokens for r in reqs
                        if r.temperature == 0.0])
    return eng, counts, streams


@pytest.fixture(scope="module", params=sorted(CHURN))
def churn(request, weights):
    ref_params, params = weights
    ref = _churn(ref_core, ref_serving, ref_get_config, ref_build_model,
                 ref_params, request.param)
    port = _churn(port_core, port_serving, get_config, build_model, params,
                  request.param)
    return ref, port


def test_compile_count_bounded_under_churn(churn):
    """The mirror of tests/test_decode_hot_loop.py's churn test: the
    fused keys stay within the ladder product and a second wave of the
    same shapes adds none (on the card: captures no graph)."""
    _, (eng, (first, second), _) = churn
    assert 0 < first <= eng.max_fused_compiles()
    assert second == first
    assert eng.graphs_captured == 0          # the CPU: no graphs


def test_compile_count_equals_reference_jit_cache(churn):
    """The port's key count equals the reference jit's cache size after
    each wave of the same workload (same weights, same streams)."""
    (ref_eng, ref_counts, ref_streams), (eng, counts, streams) = churn
    if ref_counts[0] < 0:
        pytest.skip("this jax exposes no jit cache-size counter")
    assert streams == ref_streams
    assert counts == ref_counts
    assert eng.max_fused_compiles() == ref_eng.max_fused_compiles()


@pytest.mark.parametrize("arch,n_slots,max_seq_len,block_size,want", [
    (ARCH, 8, 96, 8, 1 * 3 * 2),             # lanes {8}; pages 4, 8, 12
    (ARCH, 12, 96, 8, 2 * 3 * 2),            # lanes {8, 12}
    (ARCH, 8, 2048, 16, 1 * 6 * 2),          # chip_smoke's drives: 4..128
    ("mamba2-2.7b", 12, 96, 8, 1 * 3 * 2),   # slot-positional lanes
])
def test_max_fused_compiles_is_the_ladder_product(arch, n_slots, max_seq_len,
                                                  block_size, want):
    eng = port_serving.ServingEngine(
        model=build_model(get_config(arch, reduced=True)),
        scheduler=port_core.Scheduler(policy="fcfs"), n_slots=n_slots,
        max_seq_len=max_seq_len, block_size=block_size, device="cpu")
    assert eng.max_fused_compiles() == want
    assert eng.max_fused_compiles(n_steps_variants=3) == 3 * want
    assert eng.fused_compile_count == 0


# ----------------------------------------- the runner vs the replaced path

class FreshTensors:
    """The path the runners replaced: every call copies its inputs to
    fresh device tensors and brings the step's result back with
    ``.cpu()`` (the prefill steps have none)."""

    def __init__(self, graphs, inputs):
        self.dtypes = {name: dtype for name, (_, dtype) in inputs.items()}
        self.device = graphs.device

    def __call__(self, step, **arrays):
        x = {name: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, self.dtypes[name]) for name, a in arrays.items()}
        out = step(x)
        return None if out is None else out.cpu().numpy()


def _requests(vocab, n, temperature):
    rng = np.random.default_rng(7)
    return [port_serving.ServeRequest(
        f"r{i}", f"p{i}", [int(t) for t in rng.integers(
            3, vocab, int(rng.integers(6, 19)))],
        max_new_tokens=6 + 3 * i, temperature=temperature, eos_token=1,
        arrival=float(i) * 1e-3) for i in range(n)]


def _drive(params, *, arch=ARCH, step_mode="fused", preemption_mode="swap",
           decode_steps=1, temperature=0.0, graphs=True, between=None,
           n=4, n_slots=2, cap=48):
    """Reduced ``arch`` under a KV budget that forces preemption (chunked
    prefill for the dense family).  ``between(engine)`` runs after every
    engine step."""
    cfg = get_config(arch, reduced=True)
    o = port_core.OraclePredictor()
    for i in range(n):
        o.register(f"p{i}", port_core.LengthDistribution(
            np.array([6 + 3 * i]), np.array([1.0])))
    dense = cfg.family == "dense"
    eng = port_serving.ServingEngine(
        model=build_model(cfg),
        scheduler=port_core.Scheduler(policy=port_core.make_policy(
            "sagesched"), predictor=o),
        n_slots=n_slots, max_seq_len=96, capacity_tokens=cap, block_size=8,
        preemption_mode=preemption_mode, prefill_chunk=8 if dense else None,
        max_tokens_per_step=12 if dense else None, seed=0,
        step_mode=step_mode, decode_steps=decode_steps, params=params,
        device="cpu", graphs=graphs)
    reqs = _requests(cfg.vocab_size, n, temperature)
    eng.submit_batch(reqs)
    for _ in range(4000):
        if not eng.has_work:
            break
        eng.step()
        if between is not None:
            between(eng)
    assert all(r.state == port_serving.RequestState.FINISHED for r in reqs)
    return eng, [r.output_tokens for r in reqs]


CASES = [("fused", steps, temp, pm) for steps in (1, 4) for temp in (0.0, 0.8)
         for pm in ("swap", "recompute")] \
    + [("orchestrated", 1, temp, pm) for temp in (0.0, 0.8)
       for pm in ("swap", "recompute")]


@pytest.mark.parametrize("step_mode,decode_steps,temperature,preemption_mode",
                         CASES)
def test_runner_token_identical_to_replaced_path(
        weights, monkeypatch, step_mode, decode_steps, temperature,
        preemption_mode):
    """graphs=False and graphs=True (eager on the CPU) on the static
    buffers give the replaced path's streams, token for token."""
    _, params = weights
    kw = dict(step_mode=step_mode, decode_steps=decode_steps,
              temperature=temperature, preemption_mode=preemption_mode)
    with monkeypatch.context() as m:
        m.setattr(port_engine, "StepRunner", FreshTensors)
        e0, want = _drive(params, **kw)
    e1, eager = _drive(params, graphs=False, **kw)
    e2, got = _drive(params, graphs=True, **kw)
    assert eager == want and got == want
    assert e0.metrics.preemptions > 0
    for e in (e1, e2):
        assert e.metrics.decode_tokens == e0.metrics.decode_tokens
        assert e.metrics.preemptions == e0.metrics.preemptions
        assert e.graphs_captured == 0
    fused = step_mode == "fused"
    assert (e2.fused_compile_count > 0) == fused
    assert (e2._orchestrated_runner is not None) == (not fused)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_recurrent_runner_token_identical_to_replaced_path(monkeypatch,
                                                           arch):
    """The slot-positional lanes of the recurrent families, whose frozen
    rows rest on ``active`` alone, on the static buffers."""
    params = _weights(arch)[1]
    kw = dict(arch=arch, decode_steps=4, temperature=0.8)
    with monkeypatch.context() as m:
        m.setattr(port_engine, "StepRunner", FreshTensors)
        _, want = _drive(params, **kw)
    _, got = _drive(params, **kw)
    assert got == want


def _garble(eng, rng):
    """Random bytes into every buffer of every runner of ``eng``."""
    runners = list(eng._fused_runners.values()) \
        + list(eng._prefill_runners.values())
    if eng._orchestrated_runner is not None:
        runners.append(eng._orchestrated_runner)
    for r in runners:
        for buf in (r._host, r._dev, r._out, r._host_out):
            if buf is not None:
                raw = buf.view(-1).view(torch.uint8)
                raw.copy_(torch.from_numpy(rng.integers(
                    0, 256, raw.numel(), dtype=np.uint8)))


@pytest.mark.parametrize("arch,step_mode,n_slots", [
    (ARCH, "fused", 3), (ARCH, "orchestrated", 2),
    ("mamba2-2.7b", "fused", 3)])
def test_garbage_in_runner_buffers_between_calls_changes_nothing(
        weights, arch, step_mode, n_slots):
    """Every call rewrites every staged byte and the whole output: random
    bytes written into a key's buffers between its calls (lanes, tables,
    temperatures, budgets, the result) leave every stream as it was.
    Three slots make the lane bucket's pad lanes and a reused key whose
    live lanes and table widths change from call to call."""
    params = weights[1] if arch == ARCH else _weights(arch)[1]
    kw = dict(arch=arch, step_mode=step_mode, decode_steps=4,
              temperature=0.8, n=6, n_slots=n_slots, cap=72)
    eng0, want = _drive(params, **kw)
    rng = np.random.default_rng(3)
    eng, got = _drive(params, between=lambda e: _garble(e, rng), **kw)
    assert got == want
    runners = list(eng._fused_runners.values()) or \
        [eng._orchestrated_runner]
    assert max(r.calls for r in runners) > 1      # a key reused


def test_runner_refuses_a_partial_staging():
    """Every input is staged at every call: a missing or unknown name
    raises instead of leaving last call's bytes in place."""
    runner = StepRunner(StepGraphs(torch.device("cpu"), True),
                        {"a": ((2, 3), torch.int64),
                         "b": ((3,), torch.float32)})
    step = lambda x: x["a"].float().sum(0) + x["b"]  # noqa: E731
    out = runner(step, a=np.arange(6).reshape(2, 3), b=np.ones(3))
    np.testing.assert_array_equal(out, [4.0, 6.0, 8.0])
    for bad in ({"a": np.zeros((2, 3))},
                {"a": np.zeros((2, 3)), "b": np.ones(3), "c": np.ones(1)}):
        with pytest.raises(ValueError, match="inputs"):
            runner(step, **bad)
    assert runner.calls == 1 and not runner.captured


# ------------------------------------------------- multi-card refusal

@pytest.mark.parametrize("devices,graphs,error", [
    (["cuda:0", "cuda:1"], True, NotImplementedError),
    (["cuda:0", "cuda:1"], False, ValueError),
    (["cuda:0"] * 4, True, ValueError),
])
def test_multi_card_plan_refuses_graphs(devices, graphs, error):
    """Shards on two cards with graphs=True raise naming Queue A 15, from
    the plan's device list, before anything is allocated (no card is
    needed to see it); graphs=False, or one card listed four times, pass
    that check and stop at the memory preflight's ValueError."""
    with pytest.raises(error, match="Queue A 15" if error is
                       NotImplementedError else "does not fit"):
        port_serving.ServingEngine(
            model=build_model(get_config(ARCH, reduced=True)),
            scheduler=port_core.Scheduler(policy="fcfs"),
            mesh=make_local_mesh(tp=len(devices),
                                 devices=[torch.device(d) for d in devices]),
            device="cuda", graphs=graphs, device_memory_gb=1e-9)


@pytest.mark.parametrize("tp,error", [(2, ValueError), (1, ValueError)])
def test_launcher_turns_graphs_off_over_several_cards(monkeypatch, capsys,
                                                      tp, error):
    """``--tp N`` on the card passes graphs=False and says so: with two
    cards seen, the engine then gets past the graph check to the memory
    preflight (with graphs on it would raise NotImplementedError)."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(error, match="does not fit"):
        main(["--tp", str(tp), "--device", "cuda", "--device-memory-gb",
              "1e-9"])
    said = "graphs=False" in capsys.readouterr().out
    assert said == (tp > 1)


# ------------------------------------------------------ launch counts

def test_launches_withheld_hands_back_what_a_capture_counted():
    k1, k2 = PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL
    n1, n2 = k1.launches, k2.launches
    with launches_withheld() as counted:
        k1.launches += 3
        k2.launches += 1
        k2.launches += 1
    assert (k1.launches, k2.launches) == (n1, n2)
    assert counted[k1] == 3 and counted[k2] == 2
    with pytest.raises(RuntimeError):
        with launches_withheld() as counted:
            k1.launches += 5
            raise RuntimeError("capture failed")
    assert k1.launches == n1 and counted[k1] == 5


# ------------------------------------------ the prefill steps' compile keys

def _prefill_workload(pkg, arch: str, lengths, **kw):
    """Greedy requests of ``lengths`` prompt tokens (3 new each) through
    ``pkg``'s engine on the shared f32 weights; returns the engine."""
    from torch_parity import engine
    core, serving, _, get_cfg, _ = pkg
    cfg = get_cfg(arch, reduced=True)
    rng = np.random.default_rng(5)
    eng = engine(pkg, arch, scheduler=core.Scheduler(
        policy=core.make_policy("fcfs")), max_seq_len=128, seed=0, **kw)
    reqs = [serving.ServeRequest(
        f"q{i}", f"q{i}", [int(t) for t in rng.integers(3, cfg.vocab_size,
                                                         n)],
        max_new_tokens=3, temperature=0.0, eos_token=-1,
        arrival=float(i) * 1e-3) for i, n in enumerate(lengths)]
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=4000)
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    return eng, [r.output_tokens for r in reqs]


@pytest.mark.parametrize("graphs", [False, True])
def test_recurrent_prefill_compiles_per_bucket_not_per_length(graphs):
    """The mirror of tests/test_decode_hot_loop.py's bucket test: four
    recurrent prompts in one 32-bucket make one prefill key."""
    from torch_parity import PORT
    eng, _ = _prefill_workload(PORT, "mamba2-2.7b", (7, 9, 12, 14),
                               n_slots=2, graphs=graphs)
    assert eng.prefill_compile_count == 1
    assert sorted(eng._prefill_runners) == [("atomic", 32)]
    assert eng.graphs_captured == 0          # the CPU: no graphs


@pytest.mark.parametrize("arch,lengths,kw", [
    ("llama3.2-1b", (20, 37, 58, 90, 75, 33),
     dict(n_slots=3, prefill_chunk=16, max_tokens_per_step=24)),
    ("llama3.2-1b", (5, 70, 120), dict(n_slots=2, prefill_chunk=64)),
    ("mamba2-2.7b", (7, 30, 33, 60, 90, 14), dict(n_slots=2)),
    ("zamba2-1.2b", (7, 40, 70), dict(n_slots=2)),
])
def test_prefill_keys_equal_reference_jit_caches(arch, lengths, kw):
    """The port's chunk keys (chunk bucket, prefix bucket) and whole
    prefill keys (pow2 bucket of the context) equal the reference jit's
    cache sizes of ``_chunk_fn`` and ``_prefill_fn`` on the same workload,
    with the same streams."""
    from torch_parity import PORT, REF
    ref, ref_streams = _prefill_workload(REF, arch, lengths, **kw)
    eng, streams = _prefill_workload(PORT, arch, lengths, **kw)
    size = getattr(ref._chunk_fn, "_cache_size", None)
    if size is None:
        pytest.skip("this jax exposes no jit cache-size counter")
    assert streams == ref_streams
    keys = sorted(eng._prefill_runners)
    chunk = [k for k in keys if k[0] == "chunk"]
    atomic = [k for k in keys if k[0] == "atomic"]
    assert len(chunk) == ref._chunk_fn._cache_size()
    assert len(atomic) == ref._prefill_fn._cache_size()
    assert eng.prefill_compile_count == len(keys) > 0
    if chunk:
        assert len({k[2] for k in chunk}) > 1     # several prefix buckets
    report = eng.prefill_report()
    assert report["keys"] == keys and report["graphs"] == 0
    assert report["calls"] == eng.metrics.prefill_chunks
