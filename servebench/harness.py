"""Drive the port's serving engine through one cell's traffic.

The window drives ``ServingEngine.submit_batch`` and ``ServingEngine.step``
of ``repro_torch.serving.engine`` directly, one process on one card: the
fused step, CUDA graphs on, the ``sagesched`` scheduler with the
semantic-history predictor, the resource-bound cost model and the CUDA
Gittins backend.  What the harness records is read from outside the
engine: the host clock after each step, and each request's public fields
(its output tokens, its prefill position, its state).

Set-up, in order: the weights (from the seed, on the device), the engine,
the predictor's seed history, every fused and prefill shape key of the
cell's ladders warmed and captured, then the prelude (open loop: the first
``prelude_s`` seconds of the schedule; backlog: until the batch is full).
Set-up ends when the window opens.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import traffic as tr
from .latency import RequestTimes

__all__ = ["Window", "arch_of", "port_config", "build_engine", "run_cell",
           "Run"]

# seconds of the window the --trace 1 run profiles, in its middle
TRACE_SECONDS = 3.0


def arch_of(mc) -> dict:
    """The benchmark's architecture record of a port ModelConfig (the
    fields the reference and the counts read)."""
    a = {"n_layers": mc.n_layers, "d_model": mc.d_model,
         "n_heads": mc.n_heads, "n_kv_heads": mc.n_kv_heads,
         "head_dim": mc.head_dim, "d_ff": mc.d_ff,
         "vocab_size": mc.vocab_size, "padded_vocab": mc.padded_vocab,
         "tie_embeddings": mc.tie_embeddings, "qkv_bias": mc.qkv_bias,
         "rope_theta": mc.rope_theta, "norm_eps": mc.norm_eps,
         "activation": mc.activation}
    if mc.n_experts:
        a.update(n_experts=mc.n_experts, experts_per_token=mc.experts_per_token,
                 moe_d_ff=mc.moe_d_ff, capacity_factor=mc.capacity_factor,
                 n_shared_experts=mc.n_shared_experts,
                 first_k_dense=mc.first_k_dense)
    return a


def port_config(cfg_file: dict, reduced: bool = False):
    """The port's ModelConfig of the configuration file's ``arch_id``, with
    the file's ``port_overrides`` (published values the port's registry
    states otherwise, set through ``ModelConfig.with_overrides``)."""
    from repro_torch.configs.registry import get_config
    mc = get_config(cfg_file["arch_id"], reduced=reduced)
    return mc.with_overrides(**cfg_file.get("port_overrides", {}))


def check_arch(stated: dict, actual: dict) -> None:
    """The configuration file states the architecture as run; the port's
    ModelConfig as built (its registry and the file's overrides) must
    agree on every field it states."""
    bad = {k: (v, actual.get(k)) for k, v in stated.items()
           if actual.get(k) != v}
    if bad:
        raise SystemExit(f"servebench: the port's configuration differs from "
                         f"the benchmark's (stated, port): {bad}")


# ------------------------------------------------------------------ weights

def make_weights(model, seed: int, device) -> dict:
    """The port's parameter tree from the seed, on the device, in the
    dtypes it is served in: one normal draw for every bf16 leaf and one for
    every f32 leaf, each leaf a view scaled to its init (matrices
    N(0, min(0.02, fan_in^-1/2)), as the port initialises them; norm
    scales 1 + N(0, 0.1) and biases N(0, 0.1), so that both are
    exercised)."""
    from repro_torch.models.layers import iter_specs
    specs = list(iter_specs(model.template()))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = {}
    for dtype in (torch.bfloat16, torch.float32):
        n = sum(math.prod(s.shape) for _, s in specs if s.dtype == dtype)
        flat[dtype] = torch.randn(n, generator=gen, dtype=dtype,
                                  device=device) if n else None
    used = {torch.bfloat16: 0, torch.float32: 0}
    out: dict = {}
    for path, spec in specs:
        n = math.prod(spec.shape)
        off = used[spec.dtype]
        t = flat[spec.dtype][off:off + n].view(spec.shape)
        used[spec.dtype] = off + n
        if spec.init == "ones":
            t.mul_(0.1).add_(1.0)
        elif spec.init == "zeros":
            t.mul_(0.1)
        elif spec.init == "normal":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            t.mul_(min(0.02, math.sqrt(1.0 / max(1, fan_in))))
        else:
            raise SystemExit(f"servebench: no weights for init {spec.init!r}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def reference_weights(params: dict, arch: dict) -> dict:
    """The same tensors in the reference's layout (per-layer views)."""
    layers = []
    st = params["layers"]
    for i in range(arch["n_layers"]):
        lw = {"ln1": st["ln1"]["scale"][i], "ln2": st["ln2"]["scale"][i]}
        for k, v in st["attn"].items():
            lw[k] = v[i]
        ffn = st["moe"] if "moe" in st else st["mlp"]
        for k, v in ffn.items():
            lw[k] = v[i]
        layers.append(lw)
    return {"embed": params["embed"],
            "final_norm": params["final_norm"]["scale"],
            "lm_head": params.get("lm_head"), "layers": layers}


# ------------------------------------------------------------------- engine

def build_engine(cfg_file: dict, mc, params, seed: int, device):
    from repro_torch.core import (CudaPriorityBackend, ResourceBoundCost,
                                  Scheduler, SemanticHistoryPredictor)
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    e, s = cfg_file["engine"], cfg_file["scheduler"]
    if s["policy"] != "sagesched" or s["cost_model"] != "resource_bound" \
            or s["predictor"] != "semantic_history" \
            or s["priority_backend"] != "cuda":
        raise SystemExit(f"servebench: scheduler settings {s} are not the "
                         "ones this harness builds")
    sched = Scheduler(predictor=SemanticHistoryPredictor(),
                      cost_model=ResourceBoundCost(), policy="sagesched",
                      priority_backend=CudaPriorityBackend(device),
                      bucket_size=int(s["bucket_size"]))
    graphs = bool(e["graphs"]) and torch.device(device).type == "cuda"
    engine = ServingEngine(
        model=build_model(mc), scheduler=sched, n_slots=int(e["n_slots"]),
        max_seq_len=int(e["max_seq_len"]),
        capacity_tokens=int(e["capacity_tokens"]),
        preemption_hysteresis=float(e["preemption_hysteresis"]),
        seed=int(seed) % 2**32, params=params,
        block_size=int(e["block_size"]),
        preemption_mode=e["preemption_mode"],
        prefill_chunk=int(e["prefill_chunk"]),
        max_tokens_per_step=int(e["max_tokens_per_step"]),
        step_mode=e["step_mode"], decode_steps=int(e["decode_steps"]),
        device=device, graphs=graphs)
    return engine


def warm_shapes(engine, max_prompt: int, max_context: int) -> int:
    """Run, and on the card capture, every fused and prefill-chunk shape
    key the cell's ladders can reach, on the scratch page, so that no
    capture falls in the window: lane buckets x table buckets (every lane
    sampled, as every request is), and chunk buckets x prefix buckets.
    Reaches into the engine's step runners, which have no public warm-up,
    and stops the run where they are not there; returns the keys run."""
    from repro_torch.kernels.bucketing import pow2_bucket
    from repro_torch.serving.kv_cache import SCRATCH_BLOCK
    try:
        fused, runner, body = (engine._fused_steps, engine._prefill_runner,
                               engine._chunk_body)
    except AttributeError as exc:
        raise SystemExit(f"servebench: cannot warm the engine's shapes "
                         f"before the window: {exc}") from exc
    n_slots, page = engine.n_slots, engine.block_size
    max_pages = -(-engine.max_seq_len // page)
    p_max = min(max_pages, -(-(max_context + 2) // page))
    nbs = sorted({pow2_bucket(n, 8, n_slots) for n in range(1, n_slots + 1)})
    pbs = sorted({pow2_bucket(p, 4, max_pages) for p in range(1, p_max + 1)})
    keys = 0
    for nb in nbs:
        for pb in pbs:
            lanes = np.zeros((7, nb), np.int64)
            lanes[2] = 1                         # budget
            lanes[3] = 1                         # cap
            lanes[4] = -1                        # eos
            tables = np.full((nb, pb), SCRATCH_BLOCK, np.int32)
            temps = np.full(nb, 0.6, np.float32)
            fused(lanes, tables, temps, n_steps=engine.decode_steps,
                  all_greedy=False)
            keys += 1
    chunk = engine.prefill_chunk
    cpads = sorted({pow2_bucket(t, 64) for t in range(1, chunk + 1)})
    pasts = [0] + sorted({pow2_bucket(s, 64)
                          for s in range(1, max_prompt)})
    scratch = SCRATCH_BLOCK * page
    for cpad in cpads:
        for past in pasts:
            r = runner(("chunk", cpad, past), {
                "tokens": ((1, cpad), torch.int64),
                "past": ((past,), torch.int64),
                "out": ((cpad,), torch.int64),
                "start": ((), torch.int64)})
            r(body, tokens=np.zeros((1, cpad), np.int64),
              past=np.full(past, scratch, np.int64),
              out=np.full(cpad, scratch, np.int64), start=np.asarray(0))
            keys += 1
    # the Gittins refresh's staging buffers at the deepest batch
    sched = engine.scheduler
    n = 2 * (n_slots + 512)
    k = 64
    sup = np.tile(np.arange(1, k + 1, dtype=np.float64), (n, 1))
    sched.backend.gittins(sup, np.full((n, k), 1.0 / k), np.zeros(n))
    return keys


# ------------------------------------------------------------------- window

@dataclass
class StepLog:
    """Per engine step: host seconds in ``step()``, host seconds in the
    scheduler's admission and ordering since the step before, the decode
    lanes that emitted and the keys they attended over, the prefill chunks
    (start, tokens), the waiting queue (host time, requests), the requests
    holding a slot and the KV pool's blocks in use after it."""

    dur: list = field(default_factory=list)
    sched: list = field(default_factory=list)
    keys: list = field(default_factory=list)
    lanes: list = field(default_factory=list)
    chunks: list = field(default_factory=list)
    queue: list = field(default_factory=list)
    running: list = field(default_factory=list)
    blocks: list = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.dur)


@dataclass
class Window:
    kind: str
    arch: dict
    start: float = 0.0
    end: float = 0.0
    setup_s: float = 0.0
    recs: dict = field(default_factory=dict)      # rid -> RequestTimes
    attempted: int = 0
    failed: int = 0
    counters: dict = field(default_factory=dict)  # engine counters, window
    log: StepLog = field(default_factory=StepLog)
    captures: int = 0                             # graphs captured inside
    pool_blocks: int = 0                          # the KV pool's blocks
    n_slots: int = 0
    memory_peak: int = 0
    skipped_decodes: int = 0
    trace: object = None          # trace.TraceSummary of the traced span
    trace_log: StepLog | None = None              # its steps

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def n_steps(self) -> int:
        return len(self.log)

    def occupancy(self) -> dict:
        """What the window's traffic held of the engine: requests in a
        slot and waiting, and the KV pool's blocks in use, at their peak
        and mean over the steps (the pool's reservation is its size)."""
        lg = self.log
        if not len(lg):
            return {}
        waiting = [q[1] for q in lg.queue]
        return {"n_slots": self.n_slots, "pool_blocks": self.pool_blocks,
                "running_peak": max(lg.running),
                "running_mean": sum(lg.running) / len(lg),
                "waiting_peak": max(waiting),
                "waiting_mean": sum(waiting) / len(lg),
                "blocks_peak": max(lg.blocks),
                "blocks_mean": sum(lg.blocks) / len(lg)}


class _Span:
    """Host seconds of the scheduler's calls in the window; under the
    profiler each labelled call is also a ``record_function`` range that
    labels idle gaps."""

    def __init__(self):
        self.acc = {"admit_batch": 0.0, "order": 0.0}
        self.on = False
        self.labels = False

    def wrap(self, name, fn):
        acc = self.acc

        def call(*a, **k):
            t0 = time.perf_counter()
            with self.label(name):
                out = fn(*a, **k)
            if self.on:
                acc[name] += time.perf_counter() - t0
            return out
        return call

    def label(self, name):
        return torch.profiler.record_function(name) if self.labels \
            else contextlib.nullcontext()


class Run:
    """One run of a cell: set-up, window, and what the check needs.

    With ``trace`` the window runs as without, and the profiler then
    records ``TRACE_SECONDS`` more of the same traffic (its start-up and
    its read-out fall outside the window)."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, seconds: float,
                 *, device="cuda", model_config=None, trace: bool = False,
                 t_process: float | None = None):
        self.t0 = t_process if t_process is not None else time.monotonic()
        self.cfg_file, self.mix = cfg_file, mix
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.mc = model_config or port_config(cfg_file)
        self.arch = arch_of(self.mc)
        if model_config is None:
            check_arch(cfg_file["arch"], self.arch)
        self.temperature = float(mix["temperature"])
        e = cfg_file["engine"]
        self.schedule = tr.build_schedule(
            mix, seed, seconds, n_slots=int(e["n_slots"]),
            max_total=int(e["max_seq_len"]) - 1,
            after_s=TRACE_SECONDS if trace else 0.0)
        self.span = _Span()
        self._sched_seen = 0.0
        self.win = Window(kind=self.schedule.kind, arch=self.arch)
        self.live: dict = {}           # rid -> ServeRequest, not yet done
        self.reqs: dict = {}           # rid -> ServeRequest, every sent
        self.meta: dict = {}           # rid -> traffic.Request
        self.seen: dict = {}           # rid -> [tokens seen, prefill pos]
        self.chunks: dict = {}         # rid -> [(start, end)]
        self.recomputed: set = set()
        self.skipped = 0               # resident lanes a step passed over

    # --------------------------------------------------------------- set-up

    def setup(self) -> None:
        from repro_torch.models import build_model
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.params = make_weights(build_model(self.mc), self.seed, dev)
        self.engine = build_engine(self.cfg_file, self.mc, self.params,
                                   self.seed, dev)
        sched = self.engine.scheduler
        sched.predictor.seed(*tr.history_records(self.mix))
        reqs = self.schedule.requests
        self.warm_keys = warm_shapes(
            self.engine, max(q.input_len for q in reqs),
            max(q.input_len + q.output_len for q in reqs))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sched.admit_batch = self.span.wrap("admit_batch", sched.admit_batch)
        sched.order = self.span.wrap("order", sched.order)

    def _request(self, q: tr.Request, arrival: float):
        from repro_torch.serving.request import ServeRequest
        toks = tr.prompt_tokens(q, self.seed, self.arch["vocab_size"])
        r = ServeRequest(q.rid, q.prompt, toks.tolist(),
                         max_new_tokens=int(q.output_len), eos_token=-1,
                         temperature=self.temperature,
                         arrival=arrival)
        self.reqs[q.rid] = self.live[q.rid] = r
        self.meta[q.rid] = q
        self.seen[q.rid] = [0, 0]
        self.chunks[q.rid] = []
        self.win.recs[q.rid] = RequestTimes(due=arrival)
        return r

    def _submit(self, batch: list) -> None:
        if batch:
            with self.span.label("submit"):
                self.engine.submit_batch(batch)

    def _step(self, log: StepLog | None) -> None:
        """One engine step, then what it did, read from the requests."""
        from repro_torch.serving.request import RequestState
        t0 = time.perf_counter()
        with self.span.label("step"):
            self.engine.step()
        t1 = time.perf_counter()
        now = time.monotonic()
        keys = lanes = 0
        chunks, done = [], []
        for rid, r in self.live.items():
            s = self.seen[rid]
            n = len(r.output_tokens)
            if r.prefill_pos != s[1] and not r.done:
                if r.prefill_pos < s[1]:
                    # preempted without a swap: its context is prefilled
                    # again
                    self.recomputed.add(rid)
                else:
                    chunks.append((s[1], r.prefill_pos - s[1]))
                    self.chunks[rid].append((s[1], r.prefill_pos))
                s[1] = r.prefill_pos
            if n > s[0]:
                rec = self.win.recs[rid]
                rec.token_stamps.extend([now] * (n - s[0]))
                keys += r.input_len + s[0]
                lanes += 1
                s[0] = n
            elif r.state == RequestState.RUNNING \
                    and r.prefill_pos >= r.input_len:
                # resident and prefilled: every step decodes it
                self.skipped += 1
            if r.done:
                if r.state == RequestState.FINISHED:
                    self.win.recs[rid].finish = now
                done.append(rid)
        for rid in done:
            del self.live[rid]
        if log is not None:
            log.dur.append(t1 - t0)
            sched = self.span.acc["admit_batch"] + self.span.acc["order"]
            log.sched.append(sched - self._sched_seen)
            self._sched_seen = sched
            log.keys.append(keys)
            log.lanes.append(lanes)
            log.chunks.append(chunks)
            running = sum(1 for r in self.live.values()
                          if r.state == RequestState.RUNNING)
            log.queue.append((now, len(self.live) - running))
            log.running.append(running)
            log.blocks.append(self.engine.kv.used_blocks)

    def _counters(self) -> dict:
        m = self.engine.metrics
        return {k: getattr(m, k) for k in (
            "preemptions", "swap_outs", "swap_ins", "swapped_out_tokens",
            "swapped_in_tokens", "prefill_chunks", "prefill_tokens",
            "decode_tokens", "completed", "aborted", "forced_evictions")}

    # --------------------------------------------------------------- drive

    def drive(self) -> Window:
        open_loop = self.schedule.kind == "poisson"
        send = self._drive_open() if open_loop else self._drive_backlog()
        w = self.win
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            w.memory_peak = torch.cuda.max_memory_allocated(self.device)
        w.captures = self.engine.graphs_captured - self.captured0
        w.pool_blocks, w.n_slots = self.engine.kv.n_blocks, self.engine.n_slots
        c1 = self._counters()
        w.counters = {k: c1[k] - self.c0[k] for k in c1}
        self.span.on = False
        in_window = [rid for rid, rec in w.recs.items()
                     if w.start <= rec.due < w.end]
        w.attempted = len(in_window)
        w.failed = sum(1 for rid in in_window
                       if self.reqs[rid].done
                       and self.reqs[rid].finish_reason != "length")
        if self.trace:
            self._traced(send)
        self._settle()
        w.skipped_decodes = self.skipped
        return w

    def _settle(self, limit_s: float = 60.0) -> None:
        """The check judges finished requests: where none has finished by
        now (a window too short for the mix), step on without new
        arrivals, a minute at most, until one has."""
        def finished():
            return any(r.done and r.finish_reason == "length"
                       for r in self.reqs.values())
        t_end = time.monotonic() + limit_s
        while self.live and not finished() and time.monotonic() < t_end:
            self._step(None)

    def _open_window(self, start: float) -> None:
        self.win.start = start
        self.win.end = start + self.seconds
        self.win.setup_s = self.win.start - self.t0
        self.c0 = self._counters()
        self.captured0 = self.engine.graphs_captured
        self.span.on = True

    def _loop(self, send, until: float, log: StepLog | None) -> None:
        while True:
            now = time.monotonic()
            if now >= until:
                return
            nxt = send(now)
            if self.live:
                self._step(log)
            else:
                with self.span.label("idle_wait"):
                    time.sleep(max(0.0, min(nxt, until)
                                   - time.monotonic()))

    def _sender(self, queue: list, dues: list):
        """A sender of each request of ``queue`` once its due time (host
        clock) has come; it returns the next due time, and ``pos`` holds
        how many it has sent."""
        def send(now):
            i, batch = send.pos, []
            while i < len(queue) and dues[i] <= now:
                batch.append(self._request(queue[i], dues[i]))
                i += 1
            send.pos = i
            self._submit(batch)
            return dues[i] if i < len(queue) else float("inf")
        send.pos = 0
        return send

    def _drive_open(self):
        """Prelude and window on the schedule's due times; returns the
        maker of the traced span's sender (requests due in the window and
        not yet sent, then the "after" block, from the span's start)."""
        reqs = [q for q in self.schedule.requests if q.block != "after"]
        after = [q for q in self.schedule.requests if q.block == "after"]
        w0 = time.monotonic() + self.schedule.prelude_s
        send = self._sender(reqs, [w0 + q.due for q in reqs])
        self._loop(send, w0, None)
        self._open_window(w0)
        self._loop(send, self.win.end, self.win.log)
        self.win.end = time.monotonic()
        rest = reqs[send.pos:]
        return lambda base: self._sender(
            rest + after, [base] * len(rest)
            + [base + q.due - self.seconds for q in after])

    def _drive_backlog(self):
        """Prelude to a full batch, then the window with the waiting
        queue kept at its depth; returns the same sender for the traced
        span."""
        from repro_torch.serving.request import RequestState
        reqs = self.schedule.requests
        first = [q for q in reqs if q.block == "prelude"]
        refill = iter(q for q in reqs if q.block == "refill")
        now = time.monotonic()
        self._submit([self._request(q, now) for q in first])
        n_slots = self.engine.n_slots
        for _ in range(100_000):
            running = sum(1 for r in self.live.values()
                          if r.state == RequestState.RUNNING
                          and r.output_tokens)
            if running >= n_slots:
                break
            self._step(None)
        else:
            raise SystemExit("servebench: the prelude never filled the batch")
        depth = self.schedule.backlog

        def send(now):
            waiting = sum(1 for r in self.live.values()
                          if r.state != RequestState.RUNNING)
            batch = []
            for _ in range(max(0, depth - waiting)):
                q = next(refill, None)
                if q is None:
                    raise SystemExit("servebench: the refill pool ran out; "
                                     "raise refill_pool in the mix")
                batch.append(self._request(q, now))
            self._submit(batch)
            return now

        self._open_window(time.monotonic())
        self._loop(send, self.win.end, self.win.log)
        self.win.end = time.monotonic()
        return lambda base: send

    def _traced(self, make_send) -> None:
        """``TRACE_SECONDS`` of the same traffic under the profiler, after
        the window: the profiler starts up first (CUPTI), the traffic goes
        on from there, and the trace is read once recording stops."""
        from .trace import prepare_profiler, summarize
        prof = prepare_profiler()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.labels = True
        t0 = time.monotonic()
        prof.start_trace()
        log = StepLog()
        self._loop(make_send(t0), t0 + TRACE_SECONDS, log)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        prof.stop_trace()
        self.span.labels = False
        self.win.trace = summarize(prof, (t0, t1))
        self.win.trace_log = log

    # ---------------------------------------------------------- the check

    def program_priorities(self) -> dict:
        """Every live row of the scheduler refreshed by the program's
        Gittins kernel at the run's depth, with the inputs the reference
        recomputes it from."""
        sched = self.engine.scheduler
        st = sched._state
        n = st.n
        st.dirty[:n] = True
        sched.refresh()
        ids = list(st.ids[:n])
        gen = np.array([len(self.reqs[i].output_tokens) for i in ids])
        inp = np.array([self.reqs[i].input_len for i in ids])
        return {"support": np.array(st.cost_sup[:n]),
                "probs": np.array(st.cost_probs[:n]),
                "priority": np.array(st.priority[:n]),
                "generated": gen, "input_len": inp}

    def release_program(self) -> None:
        """Free the engine (pool, graphs, runners); the weights stay for
        the reference."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def run_cell(cfg_file, mix, seed, seconds, **kw) -> Run:
    run = Run(cfg_file, mix, seed, seconds, **kw)
    run.setup()
    run.drive()
    return run
