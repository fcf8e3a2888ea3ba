"""Tensor-parallel serving of the port (repro_torch.sharding,
repro_torch.serving.sharded, repro_torch.launch.mesh) against the
reference (repro.sharding, repro.serving.sharded).

The rule tables, the per-tensor byte rows and the memory estimate must
equal the reference's.  The engine matrix of tests/test_sharded_serving.py
runs for the dense family: every shard sits on the CPU through an
explicit ``devices=["cpu"] * tp`` (the reference's own tp > 1 cells need
XLA host devices, which this suite does not set up), so the port's
sharded engines are held to the reference's single-device engine on the
same weights (upcast to f32 on both sides): exact mode token-identical,
efficient mode within ``assert_tokens_close`` (bit-identical at tp = 1).
The reference's matrix samples at temperature 0.7; the port's Gumbel
draws are not the reference's threefry draws (ROADMAP, Port conventions),
so the port is held to the reference on greedy streams and to its own
no-mesh engine on sampled ones.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serving as ref_serving
import repro_torch.core as port_core
import repro_torch.serving as port_serving
import repro_torch.serving.sharded as sharded
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serving.sharded import estimate_device_bytes as ref_estimate
from repro.sharding.partitioning import decode_rule_table as ref_rule_table
from repro.sharding.partitioning import shard_bytes_table as ref_bytes_table
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.engine import gumbel_noise
from repro_torch.serving.sharded import ShardingPlan, estimate_device_bytes
from repro_torch.sharding import context
from repro_torch.sharding.partitioning import (decode_rule_table,
                                               decode_rules,
                                               shard_bytes_table)
from repro_torch.testing import assert_tokens_close

# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

ARCH = "qwen2-1.5b"
# heads overridden so that every width of the matrix divides them, as in
# the reference's matrix; the non-dividing cases get their own tests
OV = (("n_heads", 8), ("n_kv_heads", 8))
OV6 = (("n_heads", 6), ("n_kv_heads", 6))
WIDTHS = [1, 2, 4]
PORTED = [a for a in ARCH_IDS
          if get_config(a).family in ("dense", "ssm", "hybrid", "encdec")]


def _cpu_mesh(tp):
    return make_local_mesh(tp=tp, devices=["cpu"] * tp)


@functools.lru_cache(maxsize=None)
def _weights(ov):
    cfg = ref_get_config(ARCH, reduced=True).with_overrides(**dict(ov))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, tree), tree


def _run(pkg, *, tp=None, parallel="exact", step_mode="fused",
         pmode="swap", temperature=0.0, chunk=8, ov=OV):
    """The reference matrix's forcing workload (2 slots, a 32-token budget
    that preempts mid-decode, 3 requests) with chunked prefill, on the
    reference's f32-upcast weights; ``tp=None`` is the engine without a
    mesh, ``tp=1`` a 1x1 mesh (the plan path itself)."""
    ref = pkg == "ref"
    core, serving = (ref_core, ref_serving) if ref \
        else (port_core, port_serving)
    cfg = (ref_get_config if ref else get_config)(
        ARCH, reduced=True).with_overrides(**dict(ov))
    jax_params, tree = _weights(ov)
    o = core.OraclePredictor()
    for i in range(3):
        o.register(f"p{i}", core.LengthDistribution(np.array([6 + 2 * i]),
                                                    np.array([1.0])))
    kw = {} if ref else dict(device="cpu", parallel=parallel,
                             mesh=None if tp is None else _cpu_mesh(tp))
    eng = serving.ServingEngine(
        model=(ref_build_model if ref else build_model)(cfg),
        scheduler=core.Scheduler(policy=core.make_policy("sagesched"),
                                 predictor=o),
        n_slots=2, max_seq_len=96, capacity_tokens=32, block_size=8,
        preemption_mode=pmode, prefill_chunk=chunk, seed=0,
        step_mode=step_mode,
        params=jax_params if ref else params_from_numpy(tree, "cpu"), **kw)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(3):
        toks = [int(t) for t in rng.integers(3, cfg.vocab_size,
                                             int(rng.integers(6, 11)))]
        reqs.append(serving.ServeRequest(
            f"r{i}", f"p{i}", toks, max_new_tokens=6 + 2 * i,
            temperature=temperature, eos_token=1, arrival=float(i) * 1e-3))
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=8000)
    assert all(r.state == serving.RequestState.FINISHED for r in reqs)
    eng.kv.assert_conserved()
    return eng, [tuple(r.output_tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference(step_mode="fused", pmode="swap", chunk=8, ov=OV):
    """The reference's single-device greedy streams, once per cell."""
    eng, streams = _run("ref", step_mode=step_mode, pmode=pmode,
                        chunk=chunk, ov=ov)
    assert eng.metrics.preemptions > 0
    return streams


# ----------------------------------------------------------- rule tables

@pytest.mark.parametrize("parallel", ["exact", "efficient"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_rule_table_matches_reference(arch, tp, parallel):
    got = decode_rule_table(get_config(arch), tp, parallel=parallel)
    want = ref_rule_table(ref_get_config(arch), tp, parallel=parallel)
    assert got == want


@pytest.mark.parametrize("parallel", ["exact", "efficient"])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", PORTED)
def test_shard_bytes_and_estimate_match_reference(arch, tp, parallel):
    """The per-tensor rows of every ported family's full template, and the
    memory preflight's estimate of the decoder families."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    rules, report = decode_rule_table(cfg, tp, parallel=parallel)
    got = shard_bytes_table(build_model(cfg).template(), rules, tp,
                            fallbacks=report["fallbacks"])
    want = ref_bytes_table(ref_build_model(rcfg).template(), rules, tp,
                           fallbacks=report["fallbacks"])
    assert got == want
    if cfg.family != "encdec":
        kw = dict(tp=tp, parallel=parallel, n_pages=129, page_size=16,
                  n_slots=8)
        assert estimate_device_bytes(build_model(cfg), **kw) \
            == ref_estimate(ref_build_model(rcfg), **kw)


def test_decode_rules_reject_data_parallel_mesh():
    mesh = make_local_mesh(tp=1, data=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="non-'model' mesh axis"):
        decode_rules(get_config(ARCH), mesh)


# ------------------------------------------------------------------ mesh

def test_make_local_mesh_validates():
    mesh = _cpu_mesh(2)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 2} and mesh.size == 2
    assert list(mesh.devices[0]) == [torch.device("cpu")] * 2
    # without devices it takes real cards only, and never falls back
    with pytest.raises(ValueError, match="pass devices"):
        make_local_mesh(tp=torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="bad axis sizes"):
        make_local_mesh(tp=0)
    with pytest.raises(ValueError, match="bad axis sizes"):
        make_local_mesh(data=-1)
    with pytest.raises(ValueError, match="needs 2 devices, got 3"):
        make_local_mesh(tp=2, devices=["cpu"] * 3)
    assert make_local_mesh(devices=["cuda"]).devices[0, 0] \
        == torch.device("cuda", 0)


def test_context_hooks_are_identity_outside_a_plan():
    x = torch.ones(2, 1, 4, 8)
    assert context.serving_plan() is None
    assert context.attn_split_count() == 1
    assert context.gather_model(x, 2) is x
    assert context.constrain_q_heads(x)[0] is x
    assert context.constrain_kv_heads(x)[0] is x
    assert context.constrain_attn_split([(x, x)]) is None


def test_plan_cuts_the_megatron_axes():
    """Efficient tp = 2: column-parallel weights cut on their output dim,
    row-parallel on their input dim, the embedding on the vocab;
    replicated leaves are one tensor shared by the shards of a device."""
    cfg = get_config(ARCH, reduced=True).with_overrides(**dict(OV))
    model = build_model(cfg)
    plan = ShardingPlan.build(model, _cpu_mesh(2), parallel="efficient")
    params = model.init(torch.Generator().manual_seed(0))
    shards = plan.place_params(params)
    a, full = shards[1]["layers"]["attn"], params["layers"]["attn"]
    n = full["wq"].shape[-1] // 2
    assert torch.equal(a["wq"], full["wq"][..., n:])
    assert torch.equal(a["bq"], full["bq"][..., n:])
    assert torch.equal(a["wo"], full["wo"][:, n:])
    w = params["layers"]["mlp"]["w_out"]
    f = w.shape[1] // 2
    assert torch.equal(shards[1]["layers"]["mlp"]["w_out"], w[:, f:])
    v = params["embed"].shape[0] // 2
    assert torch.equal(shards[1]["embed"], params["embed"][v:])
    assert shards[0]["final_norm"]["scale"] is \
        shards[1]["final_norm"]["scale"]
    cache = plan.place_cache(model.init_paged_cache(9, 8, 2, device="cpu"))
    assert cache[0]["k"].shape[3] == cfg.n_kv_heads // 2


def test_gumbel_noise_of_a_vocab_shard_is_its_column_slice():
    seeds = torch.tensor([5, 77], dtype=torch.int64)
    pos = torch.tensor([3, 9], dtype=torch.int64)
    whole = gumbel_noise(0, seeds, pos, 40)
    assert torch.equal(gumbel_noise(0, seeds, pos, 15, offset=25),
                       whole[:, 25:])


@pytest.mark.parametrize("all_greedy", [True, False])
def test_partitioned_sampling_equals_the_unsharded_pick(all_greedy):
    """The engine's partitioned argmax / Gumbel-max over vocab shards picks
    what one pick over the whole row does, ties to the lowest id."""
    eng = port_serving.ServingEngine(
        model=build_model(get_config(ARCH, reduced=True)),
        scheduler=port_core.Scheduler(policy="fcfs"), n_slots=2,
        max_seq_len=96, device="cpu", tp=2, parallel="efficient")
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 1, (4, 512))).bfloat16()
    logits[0, 10] = logits[0, 300] = 9.0      # a tie across the shards
    logits[1, 20] = logits[1, 30] = 9.0       # a tie inside a shard
    temps = torch.tensor([0.0, 0.0, 0.7, 1.3])
    greedy = temps <= 0
    safe_t = torch.where(greedy, torch.ones_like(temps), temps)
    seeds = torch.tensor([1, 2, 3, 4])
    pos = torch.tensor([0, 5, 6, 7])
    got = eng._sample_sharded([logits[:, :256], logits[:, 256:]], greedy,
                              safe_t, seeds, pos, all_greedy)
    want = torch.argmax(logits, dim=-1)
    if not all_greedy:
        noise = gumbel_noise(eng.seed, seeds, pos, 512)
        st = torch.argmax(logits.float() / safe_t[:, None] + noise, dim=-1)
        want = torch.where(greedy, want, st)
    assert torch.equal(got, want)
    assert int(got[0]) == 10 and int(got[1]) == 20


# ------------------------------------------------------- engine matrix

@pytest.mark.parametrize("tp", WIDTHS)
@pytest.mark.parametrize("pmode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_exact_mesh_matches_reference(step_mode, pmode, tp):
    """parallel="exact": the pool sharded over kv heads, attention per
    shard, every GEMM unsharded: token-identical to the reference's
    single-device engine, preemption mid-decode and all."""
    want = _reference(step_mode, pmode)
    eng, got = _run("port", tp=tp, step_mode=step_mode, pmode=pmode)
    assert got == want, f"{step_mode}/{pmode}/tp={tp} diverged"
    assert eng.metrics.preemptions > 0
    assert eng.plan is not None and eng.tp == tp
    report = eng.sharding_report()
    assert report["devices"] == tp and report["tp"] == tp
    assert report["attention"] == "sharded"
    assert len(eng._cache) == tp
    assert eng._cache[0]["k"].shape[3] == 8 // tp
    if step_mode == "fused":
        assert eng.metrics.fused_steps > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_exact_mesh_sampled_streams_match_no_mesh(tp):
    """Sampled streams (temperature 0.7): exact mode is bit-identical to
    the port's engine without a mesh."""
    _, want = _run("port", temperature=0.7)
    _, got = _run("port", tp=tp, temperature=0.7)
    assert got == want


@pytest.mark.parametrize("tp", WIDTHS)
@pytest.mark.parametrize("pmode", ["swap", "recompute"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_efficient_mesh_within_tolerance(step_mode, pmode, tp):
    """parallel="efficient": column/row-parallel projections, vocab-sharded
    embedding and logits with partitioned sampling; the reference's
    greedy streams under the tolerance contract, bit-identical at tp=1."""
    want = _reference(step_mode, pmode)
    eng, got = _run("port", tp=tp, step_mode=step_mode, pmode=pmode,
                    parallel="efficient")
    assert_tokens_close(got, want, bit_identical=(tp == 1),
                        label=f"{step_mode}/{pmode}/tp={tp}")
    assert eng.metrics.preemptions > 0
    report = eng.sharding_report()
    assert report["parallel"] == "efficient"
    assert report["attention"] == "sharded"
    assert report["vocab"] == "sharded" and report["mlp"] == "sharded"
    if tp > 1:
        assert report["param_bytes_per_device"] < report["param_bytes"]
        assert report["replicated_bytes"] < 0.05 * report["param_bytes"]


def test_efficient_lse_split_non_dividing_heads():
    """Heads that do not divide the mesh: a replicated pool, attention
    split over the logical page axis into one LSE stripe per shard, the
    MLP and vocab still sharded; within tolerance of the reference."""
    want = _reference(ov=OV6)
    eng, got = _run("port", tp=4, parallel="efficient", ov=OV6)
    assert_tokens_close(got, want, label="lse-split/tp=4")
    report = eng.sharding_report()
    assert report["attention"] == "lse-split"
    assert report["attn_splits"] == 4 and eng.plan.attn_splits == 4
    assert set(report["fallbacks"]) == {"heads", "heads_out", "kv"}
    assert report["vocab"] == "sharded" and report["mlp"] == "sharded"
    # one replicated pool shared by the four shards of the one device
    assert all(c["k"] is eng._cache[0]["k"] for c in eng._cache)
    assert eng._cache[0]["k"].shape[3] == 6


def test_exact_fallback_replicates_non_dividing_heads():
    want = _reference(ov=OV6)
    eng, got = _run("port", tp=4, ov=OV6)
    assert got == want
    assert eng.sharding_report()["attention"] == "replicated"
    assert all(c["k"] is eng._cache[0]["k"] for c in eng._cache)


@pytest.mark.parametrize("parallel", ["exact", "efficient"])
def test_mesh_chunked_prefill(parallel):
    """4-token chunks scatter into the sharded pool through the per-shard
    slices decode uses."""
    want = _reference(chunk=4)
    _, got = _run("port", tp=2, chunk=4, parallel=parallel)
    assert_tokens_close(got, want, bit_identical=parallel == "exact")


@pytest.mark.parametrize("parallel", ["exact", "efficient"])
def test_mesh_swap_equals_recompute(parallel):
    """The swap payload is a gather of the shards' slices and a scatter
    back: preemption history stays invisible to the streams."""
    es, a = _run("port", tp=2, pmode="swap", parallel=parallel)
    er, b = _run("port", tp=2, pmode="recompute", parallel=parallel)
    assert a == b
    assert es.metrics.swap_outs > 0 and er.metrics.preemptions > 0


# ------------------------------------------------------ engine options

def _engine(**kw):
    cfg = get_config(ARCH, reduced=True).with_overrides(
        **dict(kw.pop("ov", OV)))
    return port_serving.ServingEngine(
        model=build_model(cfg),
        scheduler=port_core.Scheduler(policy=port_core.make_policy("fcfs")),
        n_slots=2, max_seq_len=96, block_size=8, device="cpu", **kw)


def test_engine_rejects_tp_mesh_contradiction_and_bad_parallel():
    with pytest.raises(ValueError, match="contradicts"):
        _engine(tp=2, mesh=_cpu_mesh(1))
    with pytest.raises(ValueError, match="bad parallel"):
        _engine(parallel="megatron")
    with pytest.raises(ValueError, match="tp must be"):
        _engine(tp=0)


def test_memory_preflight_refuses_and_diagnoses():
    """An over-budget engine fails before allocating anything, with the
    per-component breakdown; a fitting budget keeps the estimate."""
    with pytest.raises(ValueError) as ei:
        _engine(device_memory_gb=1e-6)
    msg = str(ei.value)
    assert "does not fit" in msg and "weights" in msg \
        and "KV pool" in msg and "workspace" in msg
    eng = _engine(device_memory_gb=8.0, tp=2, parallel="efficient")
    pf = eng.preflight
    assert pf is not None and pf["total_bytes"] <= 8 * 2**30
    assert pf["total_bytes"] == (pf["weights_bytes"] + pf["kv_pool_bytes"]
                                 + pf["workspace_bytes"])
    assert pf["tp"] == 2 and pf["report"]["vocab"] == "sharded"


def test_sharding_report_tensor_rows():
    """describe() itemizes every weight, and a weight above
    REPLICATION_WARN_BYTES that fell back to replication warns."""
    report = _engine(tp=2, parallel="efficient").sharding_report()
    rows = report["tensors"]
    assert rows and all({"name", "shape", "spec", "bytes",
                         "bytes_per_device", "sharded", "fallback"}
                        <= set(r) for r in rows)
    wq = next(r for r in rows if "wq" in r["name"])
    assert wq["sharded"] and wq["bytes_per_device"] == wq["bytes"] // 2
    assert wq["spec"] == "PartitionSpec(None, None, 'model')"
    assert report["replicated_bytes"] == sum(
        r["bytes"] for r in rows if not r["sharded"])
    assert report["warnings"] == []
    assert _engine().sharding_report() is None
    old = sharded.REPLICATION_WARN_BYTES
    sharded.REPLICATION_WARN_BYTES = 0
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = _engine(tp=2, parallel="efficient",
                          ov=(("n_heads", 3), ("n_kv_heads", 3)))
        assert any("replicat" in str(w.message) for w in caught)
        assert eng.sharding_report()["warnings"]
    finally:
        sharded.REPLICATION_WARN_BYTES = old


def test_launcher_serves_tensor_parallel_on_cpu():
    from repro_torch.launch.serve import main
    engine, reqs = main(["--device", "cpu", "--arch", ARCH, "--tp", "2",
                         "--parallel", "efficient", "--n-requests", "3",
                         "--device-memory-gb", "1"])
    assert engine.metrics.completed == 3 and engine.tp == 2
    assert engine.sharding_report()["vocab"] == "sharded"
    assert engine.preflight is not None


def test_launcher_tp_needs_that_many_cards():
    from repro_torch.launch.serve import main
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has the cards")
    with pytest.raises(ValueError, match="CUDA cards"):
        main(["--tp", "2"])
