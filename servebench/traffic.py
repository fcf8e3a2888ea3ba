"""Traffic: one general generator driven by a mix file ``traffic/<mix>.json``.

The request profiles are a frozen copy of the port's workload generator
(``repro_torch.simulator.workload``: the paper's ShareGPT,
Alpaca-Summarization and Document-Write profiles, semantic clusters with
lognormal lengths and early-stop modes, Poisson arrivals).  The copy lives
here so that a change to the program cannot change the benchmark's traffic.

The work of a run does not depend on ``--seed``.  A mix fixes a pool of
requests (profile, cluster, prompt text, input and output length) and the arrival times from its own ``pool_seed``; the run's seed
only permutes which request takes which arrival, within runs of
``permute_within`` consecutive requests of a block, and draws the prompt
token ids.  The blocks (prelude, window) are permuted apart, so every seed
sends the window the same set of sizes at the same times, in another
order.

Mix file keys (see ``traffic/*.json``):
  kind            "poisson" (open loop) or "backlog" (closed, a waiting
                  queue kept at a fixed depth)
  profiles        {profile name: share}
  clusters_per_profile
  rate_rps        poisson: the arrival rate
  prelude_s       poisson: seconds of the same schedule before the window
  backlog_per_slot  backlog: waiting requests per engine slot
  refill_pool     backlog: requests drawn for refills after the prelude
  pool_seed       the fixed stream of sizes and arrivals
  history_per_cluster, history_seed_offset   the predictor's seed history
  order_seed_offset  the stream of the seed's permutation
  permute_within  the seed reorders requests within runs of this many
  max_input, max_output  optional clips of the drawn lengths
  temperature     every request's sampling temperature
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["Cluster", "make_profile", "Request", "load_mix", "Schedule",
           "build_schedule", "history_records", "PROFILE_NAMES"]

PROFILE_NAMES = ("sharegpt", "alpaca", "write")

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

# dataset-level (input median, output median, output sigma), Fig. 1(b)
_ANCHORS = {"sharegpt": (220.0, 260.0, 0.9),
            "alpaca": (1800.0, 150.0, 0.6),
            "write": (140.0, 1100.0, 0.5)}
_TEMPLATES = {
    "sharegpt": "please chat with me and explain in detail about",
    "alpaca": "summarize the following document into key points covering",
    "write": "write a long detailed piece in the requested style about",
}


@dataclass
class Cluster:
    """Prompts of one family share a template, a vocabulary and an
    output-length distribution (lognormal, clipped, with an early-stop
    mode)."""

    cluster_id: str
    template: str
    vocab: list
    input_mu: float
    input_sigma: float
    output_mu: float
    output_sigma: float
    short_prob: float
    max_output: int = 4096
    max_input: int = 8192
    mutation: float = 0.15
    short_lo: int = 8
    short_hi: int = 96

    def sample_prompt(self, rng: np.random.Generator, n_free: int = 12) -> str:
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


def make_profile(name: str, n_clusters: int = 12) -> list[Cluster]:
    """The clusters of one dataset profile, from the profile's own fixed
    stream (crc32 of its name), as the port's ``make_profile`` draws them."""
    if name not in PROFILE_NAMES:
        raise KeyError(f"unknown profile {name!r}; have {PROFILE_NAMES}")
    rng = np.random.default_rng(zlib.crc32(name.encode()) % (2**31))
    in_med, out_med, out_sig = _ANCHORS[name]
    clusters = []
    for k in range(n_clusters):
        vocab = list(rng.choice(_WORDS, size=18, replace=False))
        topic = " ".join(rng.choice(vocab, size=4, replace=False))
        imed = in_med * float(rng.uniform(0.4, 2.2))
        omed = out_med * float(rng.uniform(0.4, 2.2))
        osig = out_sig * float(rng.uniform(0.6, 1.3))
        clusters.append(Cluster(
            cluster_id=f"{name}-{k}",
            template=f"{_TEMPLATES[name]} {topic} [{name}-{k}]",
            vocab=vocab, input_mu=float(np.log(imed)), input_sigma=0.25,
            output_mu=float(np.log(omed)), output_sigma=osig,
            short_prob=float(rng.uniform(0.05, 0.35))))
    return clusters


@dataclass
class Request:
    """One request of the schedule.  ``due`` is seconds from the window's
    start (negative in the prelude; None for a backlog refill, which is
    sent when the queue has room).  ``output_len`` is hidden from the
    scheduler: it is the request's ``max_new_tokens``, and its EOS id is
    one the model cannot emit."""

    rid: str
    due: float | None
    prompt: str
    input_len: int
    output_len: int
    profile: str
    cluster: str
    block: str                 # "prelude" | "window" | "refill" | "after"


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    for key in ("kind", "profiles", "pool_seed", "temperature"):
        if key not in mix:
            raise KeyError(f"{path}: mix file lacks {key!r}")
    if mix["kind"] not in ("poisson", "backlog"):
        raise ValueError(f"{path}: unknown kind {mix['kind']!r}")
    if not float(mix["temperature"]) > 0:
        raise ValueError(f"{path}: the check scores sampled tokens; the "
                         "temperature must be above 0")
    return mix


def _profiles(mix: dict):
    names = list(mix["profiles"])
    shares = np.asarray([float(mix["profiles"][n]) for n in names])
    shares = shares / shares.sum()
    n_cl = int(mix.get("clusters_per_profile", 12))
    return names, shares, {n: make_profile(n, n_cl) for n in names}


def _draw(rng, names, shares, clusters, max_total, max_in, max_out):
    """One request's (profile, cluster, prompt, input, output) in the
    port generator's draw order."""
    prof = names[int(rng.choice(len(names), p=shares))]
    cl = clusters[prof][int(rng.integers(len(clusters[prof])))]
    prompt = cl.sample_prompt(rng)
    n_in = cl.sample_input_len(rng)
    n_out = cl.sample_output_len(rng)
    n_in, n_out = min(n_in, max_in), min(n_out, max_out)
    # a context may not reach the engine's last position
    n_out = max(1, min(n_out, max_total - n_in))
    return prof, cl.cluster_id, prompt, n_in, n_out


@dataclass
class Schedule:
    kind: str
    requests: list                      # every request, in send order
    prelude_s: float = 0.0
    backlog: int = 0                    # backlog: waiting queue depth


def build_schedule(mix: dict, seed: int, seconds: float, *, n_slots: int,
                   max_total: int, after_s: float = 0.0) -> Schedule:
    """The run's schedule.  ``max_total`` is the longest context the engine
    serves (its ``max_seq_len`` - 1).  ``after_s`` > 0 adds a block
    "after" of the arrivals due in the ``after_s`` seconds past the window
    (an open loop's traced span), drawn after every other block, so that
    those are the same with or without it."""
    names, shares, clusters = _profiles(mix)
    pool = np.random.default_rng(int(mix["pool_seed"]))
    order = np.random.default_rng(
        [int(seed) % 2**48, int(mix.get("order_seed_offset", 7))])
    max_in = int(mix.get("max_input", max_total))
    max_out = int(mix.get("max_output", max_total))

    group = int(mix.get("permute_within", 0)) or None

    def block(n, name, dues):
        rows = [_draw(pool, names, shares, clusters, max_total, max_in,
                      max_out) for _ in range(n)]
        # the seed reorders requests within runs of ``group`` consecutive
        # ones (the whole block without it): the sizes near each time,
        # and so the window's end, stay the same for every seed
        g = group or max(1, n)
        perm = [a + int(j) for a in range(0, n, g)
                for j in order.permutation(min(g, n - a))]
        out = []
        for j, i in enumerate(perm):
            prof, cl, prompt, n_in, n_out = rows[int(i)]
            out.append(Request(f"{name[0]}{j:05d}", dues[j], prompt, n_in,
                               n_out, prof, cl, name))
        return out

    if mix["kind"] == "poisson":
        rate = float(mix["rate_rps"])
        prelude = float(mix["prelude_s"])

        def arrivals(span):
            t, out = 0.0, []
            while True:
                t += float(pool.exponential(1.0 / rate))
                if t >= span:
                    return out
                out.append(t)

        pre = [t - prelude for t in arrivals(prelude)]
        win = arrivals(float(seconds))
        reqs = block(len(pre), "prelude", pre) + block(len(win), "window",
                                                       win)
        if after_s > 0:
            aft = [float(seconds) + t for t in arrivals(after_s)]
            reqs += block(len(aft), "after", aft)
        return Schedule("poisson", reqs, prelude_s=prelude)
    depth = int(round(float(mix["backlog_per_slot"]) * n_slots))
    first = block(n_slots + depth, "prelude", [None] * (n_slots + depth))
    refill = int(mix["refill_pool"])
    rest = block(refill, "refill", [None] * refill)
    return Schedule("backlog", first + rest, backlog=depth)


def history_records(mix: dict) -> tuple[list, list, list]:
    """The predictor's seed history: ``history_per_cluster`` completed
    requests of every cluster of the mix's profiles, drawn from a stream
    apart from the traffic's (prompts, input lengths, output lengths)."""
    names, _, clusters = _profiles(mix)
    rng = np.random.default_rng(
        [int(mix["pool_seed"]), int(mix.get("history_seed_offset", 1))])
    per = int(mix.get("history_per_cluster", 60))
    prompts, ins, outs = [], [], []
    for n in names:
        for cl in clusters[n]:
            for _ in range(per):
                prompts.append(cl.sample_prompt(rng))
                ins.append(cl.sample_input_len(rng))
                outs.append(cl.sample_output_len(rng))
    return prompts, ins, outs


def prompt_tokens(req: Request, seed: int, vocab: int) -> np.ndarray:
    """The request's prompt token ids, drawn from the run's seed over
    [3, vocab)."""
    rng = np.random.default_rng(
        [int(seed) % 2**48, zlib.crc32(req.rid.encode())])
    return rng.integers(3, vocab, req.input_len, dtype=np.int64)
