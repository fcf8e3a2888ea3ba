"""Synthetic workload generation calibrated to the paper's datasets.

The paper evaluates on three request datasets (Fig. 1(b), Sec. 4.1):

  * ShareGPT            — conversational: short/medium inputs, medium
                          outputs with heavy right tail.
  * Alpaca-Summarization — long inputs (documents), short outputs.
  * Document-Write      — short inputs (instructions), long outputs.

Two structural properties of real traces matter for reproducing the
paper's results and are built in:

  1. **Semantic clusters** (Fig. 4 premise): prompts form clusters; prompts
     within a cluster share vocabulary (high embedding cosine similarity)
     and share an *output-length distribution*.  The true output length of
     a request is a sample from its cluster's distribution — this is the
     ground truth the semantic-aware predictor can recover and the
     semantic-unaware ones cannot.
  2. **Per-request uncertainty** (Fig. 1(a)): even conditioned on the
     cluster, the output length is random (temperature-0.6 sampling).

Arrivals are Poisson at a configurable RPS (Sec. 4.1).  One generated
workload is a single cluster-global arrival stream: the single-node
simulator (``simulator.NodeSimulator``, paper Sec. 4.2–4.3 experiments)
consumes it directly, while the event-driven multi-node loop
(``cluster.simulate_cluster``, the Sec. 4.4 scalability topology)
routes each ``SimRequest`` to a serving node *at its arrival time* —
requests carry no node affinity here; placement is the router's job.
For cluster sweeps at fixed per-node load, scale ``rps`` with the node
count (8 RPS/node in the paper's Fig. 12 setup).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = ["SemanticCluster", "DatasetProfile", "SimRequest",
           "make_profile", "DATASET_NAMES", "generate_workload",
           "generate_session_workload"]

DATASET_NAMES = ("sharegpt", "alpaca", "write")

# a compact word bank; clusters draw disjoint-ish vocab subsets from it
_WORDS = (
    "model train data neural layer token sample batch learn logic matrix "
    "vector tensor graph node edge path search sort merge hash tree heap "
    "stack queue list array string parse regex compile link load store fetch "
    "cache memory disk file socket packet route server client thread lock "
    "mutex atomic async await yield stream buffer pixel image audio video "
    "frame codec signal filter noise wave photon atom molecule protein gene "
    "cell tissue organ heart brain nerve blood bone muscle skin liver kidney "
    "story dragon castle knight wizard forest river mountain ocean island "
    "city village market bridge tower garden temple palace desert winter "
    "summer spring autumn morning evening night shadow light colour music "
    "poem novel essay letter report summary review article chapter verse "
    "contract clause statute court judge jury verdict appeal motion brief "
    "revenue profit margin equity asset bond stock option future hedge risk"
).split()


@dataclass
class SemanticCluster:
    """A family of semantically-similar prompts sharing an output-length
    distribution (lognormal, clipped)."""

    cluster_id: str
    template: str         # shared instruction prefix (template-like prompts)
    vocab: list[str]
    input_mu: float       # lognormal params for input length
    input_sigma: float
    output_mu: float      # lognormal params for output length
    output_sigma: float
    max_output: int = 4096
    max_input: int = 8192
    mutation: float = 0.15  # fraction of free words drawn off-cluster
    # Early-termination mode: with prob ``short_prob`` the model answers
    # briefly (clarification, refusal, early <EOS>) — the multimodality
    # visible in the paper's Fig. 1(a)/2(a) output-length histograms.
    short_prob: float = 0.0
    short_lo: int = 8
    short_hi: int = 96

    def sample_prompt(self, rng: np.random.Generator, n_free: int = 12) -> str:
        """Real request families share an instruction template ("Summarize
        the following report: ...") plus variable payload words."""
        n_mut = int(round(n_free * self.mutation))
        words = list(rng.choice(self.vocab, size=n_free - n_mut))
        words += list(rng.choice(_WORDS, size=n_mut))
        rng.shuffle(words)
        return self.template + " " + " ".join(words)

    def sample_input_len(self, rng: np.random.Generator) -> int:
        v = int(rng.lognormal(self.input_mu, self.input_sigma))
        return int(np.clip(v, 8, self.max_input))

    def sample_output_len(self, rng: np.random.Generator) -> int:
        if self.short_prob > 0.0 and rng.random() < self.short_prob:
            return int(rng.integers(self.short_lo, self.short_hi + 1))
        v = int(rng.lognormal(self.output_mu, self.output_sigma))
        return int(np.clip(v, 4, self.max_output))

    def true_length_samples(self, rng: np.random.Generator,
                            n: int = 512) -> np.ndarray:
        """Ground-truth output-length sample set (for oracle predictors and
        predictor-accuracy evaluation)."""
        return np.array([self.sample_output_len(rng) for _ in range(n)])


@dataclass
class DatasetProfile:
    name: str
    clusters: list[SemanticCluster] = field(default_factory=list)


def _lognormal_params(median: float, sigma: float) -> tuple[float, float]:
    return float(np.log(median)), sigma


def make_profile(name: str, n_clusters: int = 12,
                 seed: int | None = None) -> DatasetProfile:
    """Build a dataset profile with per-cluster I/O length statistics drawn
    around the dataset-level medians observed in the paper's Fig. 1(b)."""
    if name not in DATASET_NAMES:
        raise KeyError(f"unknown dataset {name!r}; have {DATASET_NAMES}")
    if seed is None:
        seed = zlib.crc32(name.encode()) % (2**31)  # process-stable
    rng = np.random.default_rng(seed)
    # dataset-level (input_median, output_median) anchors
    anchors = {
        "sharegpt": (220.0, 260.0, 0.9),   # conversational, heavy tail
        "alpaca":   (1800.0, 150.0, 0.6),  # summarization: long in, short out
        "write":    (140.0, 1100.0, 0.5),  # writing: short in, long out
    }
    in_med, out_med, out_sig = anchors[name]
    templates = {
        "sharegpt": "please chat with me and explain in detail about",
        "alpaca": "summarize the following document into key points covering",
        "write": "write a long detailed piece in the requested style about",
    }
    clusters = []
    for k in range(n_clusters):
        vocab = list(rng.choice(_WORDS, size=18, replace=False))
        topic = " ".join(rng.choice(vocab, size=4, replace=False))
        template = f"{templates[name]} {topic} [{name}-{k}]"
        # cluster-level medians jitter around dataset anchors (x0.4 .. x2.2)
        imed = in_med * float(rng.uniform(0.4, 2.2))
        omed = out_med * float(rng.uniform(0.4, 2.2))
        imu, isig = _lognormal_params(imed, 0.25)
        omu, osig = _lognormal_params(omed, out_sig * float(rng.uniform(0.6, 1.3)))
        clusters.append(SemanticCluster(
            cluster_id=f"{name}-{k}", template=template, vocab=vocab,
            input_mu=imu, input_sigma=isig,
            output_mu=omu, output_sigma=osig,
            short_prob=float(rng.uniform(0.05, 0.35))))
    return DatasetProfile(name=name, clusters=clusters)


@dataclass
class SimRequest:
    """One request as the simulator sees it.

    The three prefix fields describe the *sharing structure* of session
    workloads (all default to "no sharing", so every existing generator
    and test is unchanged): requests with the same ``prefix_group``
    belong to one prefix chain (a multi-turn session, or a tenant pool
    sharing a system prompt).  ``shared_prefix_len`` is how many leading
    tokens of THIS prompt are shared with *earlier* members of the group
    (adoptable from a prefix cache); ``sharable_prefix_len`` is how many
    of its leading tokens *later* members will share (what it publishes
    — a session turn publishes its whole prompt because the next turn
    extends it; a tenant request publishes only the system prompt, since
    siblings diverge right after it)."""

    request_id: str
    arrival: float            # seconds
    prompt: str
    input_len: int
    true_output_len: int      # hidden from the scheduler until completion
    dataset: str
    cluster: SemanticCluster
    prefix_group: str = ""
    shared_prefix_len: int = 0
    sharable_prefix_len: int = 0
    # multiplicative drift applied to this request's true output length
    # (generate_workload(drift_scale=...)); 1.0 = undrifted.  Recorded so
    # drift-aware baselines (e.g. the regret bench's oracle) can
    # reconstruct the drifted truth a predictor trained on the original
    # clusters cannot see.
    drift_factor: float = 1.0


def _drift_factor(i: int, n: int, scale: float, start: float,
                  ramp: float, mode: str) -> float:
    """Length-scale multiplier for request ``i`` of ``n`` under a drift
    schedule.  ``start``/``ramp`` are fractions of the trace: drift
    begins at ``start * n`` and (for ``ramp`` mode) reaches full
    ``scale`` after another ``ramp * n`` requests.  Modes:

      * ``ramp``      — linear 1 -> scale over the ramp window, then flat
                        (a dataset-mix shift settling in);
      * ``step``      — instant jump to ``scale`` at ``start`` (a
                        deployment flipping the traffic);
      * ``oscillate`` — alternates 1x / ``scale`` every ``ramp * n``
                        requests after ``start`` (the adversarial case:
                        any frozen correction is wrong half the time).
    """
    pos = i - start * n
    if pos < 0:
        return 1.0
    if mode == "step":
        return scale
    span = max(1.0, ramp * n)
    if mode == "oscillate":
        return scale if int(pos // span) % 2 == 0 else 1.0
    return 1.0 + (scale - 1.0) * min(1.0, pos / span)  # ramp


def generate_workload(profiles: list[DatasetProfile], n_requests: int,
                      rps: float, seed: int = 0, *,
                      burst_factor: float = 1.0,
                      burst_period_s: float = 10.0,
                      burst_duty: float = 0.2,
                      drift_scale: float = 1.0,
                      drift_start: float = 0.5,
                      drift_ramp: float = 0.25,
                      drift_mode: str = "ramp") -> list[SimRequest]:
    """Poisson arrivals at ``rps``; each request uniformly picks a dataset
    profile then a cluster (mixed-dataset experiment when len(profiles)>1).

    ``burst_factor > 1`` modulates the Poisson rate: for the first
    ``burst_duty`` fraction of every ``burst_period_s`` window the rate
    is ``burst_factor * rps`` — the flash-crowd overload pattern the
    gateway's admission control is tested against.  ``burst_factor=1``
    (default) draws the exact same RNG sequence as the unmodulated
    generator, so every seeded workload in existing experiments is
    unchanged.

    ``drift_scale != 1`` injects *prediction drift*: true output lengths
    are multiplied by a per-request factor following ``drift_mode``
    (see ``_drift_factor``) while prompts/clusters are untouched — so
    any predictor trained or seeded on the original clusters is
    honestly, progressively wrong.  Applied AFTER sampling (same
    RNG-compatibility pattern as ``burst_factor``): with the default
    scale of 1.0 the trace is bit-identical to the undrifted one, and a
    drifted trace differs only in ``true_output_len``/``drift_factor``.
    """
    if drift_mode not in ("ramp", "step", "oscillate"):
        raise ValueError(f"unknown drift_mode {drift_mode!r}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out: list[SimRequest] = []
    for i in range(n_requests):
        rate = rps
        if burst_factor != 1.0 and (t % burst_period_s
                                    ) < burst_duty * burst_period_s:
            rate = rps * burst_factor
        t += float(rng.exponential(1.0 / rate))
        prof = profiles[int(rng.integers(len(profiles)))]
        cluster = prof.clusters[int(rng.integers(len(prof.clusters)))]
        # draw order (prompt, input, output) is part of the seed contract
        prompt = cluster.sample_prompt(rng)
        input_len = cluster.sample_input_len(rng)
        tol = cluster.sample_output_len(rng)
        df = 1.0
        if drift_scale != 1.0:
            df = _drift_factor(i, n_requests, drift_scale, drift_start,
                               drift_ramp, drift_mode)
            if df != 1.0:
                tol = max(1, int(round(tol * df)))
        out.append(SimRequest(
            request_id=f"req-{i:06d}",
            arrival=t,
            prompt=prompt,
            input_len=input_len,
            true_output_len=tol,
            dataset=prof.name,
            cluster=cluster,
            drift_factor=df))
    return out


def generate_session_workload(profiles: list[DatasetProfile],
                              n_sessions: int, rps: float, seed: int = 0, *,
                              turns: tuple[int, int] = (2, 4),
                              think_time_s: float = 4.0,
                              tenant_prob: float = 0.4,
                              n_tenants: int = 4,
                              system_prompt_tokens: int = 64,
                              turn_user_tokens: int = 24
                              ) -> list[SimRequest]:
    """Session arrivals — the compound workload class prefix sharing
    unlocks (LLMSched's stage-structured requests).  Sessions arrive
    Poisson at ``rps`` and take one of two sharing shapes:

      * **multi-turn chat** (prob ``1 - tenant_prob``): 2..N turns where
        turn j's prompt is the whole accumulated conversation (previous
        prompt + previous answer + a fresh user message), so each turn
        shares its predecessor's full context (``shared_prefix_len``)
        and publishes its own full prompt for the next turn
        (``sharable_prefix_len == input_len``).  Turns are spaced by
        exponential think time.
      * **shared-system-prompt tenant** (prob ``tenant_prob``): a
        one-shot request whose first ``system_prompt_tokens`` tokens are
        the tenant's fixed system prompt — shared with every other
        request of that tenant, diverging immediately after (so only the
        system prompt is published as sharable).

    Deterministic per seed; returned sorted by arrival time.  Output
    lengths still come from the semantic clusters, so predictors behave
    exactly as on the one-shot workloads."""
    lo, hi = int(turns[0]), int(turns[1])
    if lo < 1 or hi < lo:
        raise ValueError(f"bad turns range {turns!r}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out: list[SimRequest] = []
    for i in range(n_sessions):
        t += float(rng.exponential(1.0 / rps))
        prof = profiles[int(rng.integers(len(profiles)))]
        cluster = prof.clusters[int(rng.integers(len(prof.clusters)))]
        if rng.random() < tenant_prob:
            tenant = int(rng.integers(n_tenants))
            user_len = cluster.sample_input_len(rng)
            out.append(SimRequest(
                request_id=f"sess-{i:05d}-t0",
                arrival=t,
                prompt=(f"[tenant-{tenant} system] "
                        + cluster.sample_prompt(rng)),
                input_len=system_prompt_tokens + user_len,
                true_output_len=cluster.sample_output_len(rng),
                dataset=prof.name,
                cluster=cluster,
                prefix_group=f"tenant-{tenant}",
                shared_prefix_len=system_prompt_tokens,
                sharable_prefix_len=system_prompt_tokens))
            continue
        n_turns = int(rng.integers(lo, hi + 1))
        base_prompt = cluster.sample_prompt(rng)
        arrival = t
        ctx = 0
        for j in range(n_turns):
            user_len = int(rng.integers(8, 2 * turn_user_tokens + 1))
            input_len = ctx + user_len
            out_len = cluster.sample_output_len(rng)
            out.append(SimRequest(
                request_id=f"sess-{i:05d}-t{j}",
                arrival=arrival,
                prompt=f"{base_prompt} [turn {j}]",
                input_len=input_len,
                true_output_len=out_len,
                dataset=prof.name,
                cluster=cluster,
                prefix_group=f"sess-{i:05d}",
                shared_prefix_len=ctx,
                sharable_prefix_len=input_len))
            ctx = input_len + out_len
            arrival += float(rng.exponential(think_time_s))
    out.sort(key=lambda r: (r.arrival, r.request_id))
    return out
