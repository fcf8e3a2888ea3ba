"""The comparison that decides ``correct``.

Once the window has closed and the peak memory is read:

1. The scheduler's live rows, at the window's depth, are refreshed by the
   program's Gittins kernel; the reference recomputes each priority in
   float64 from the row's cost distribution (the predictor's, the
   program's state) and the attained cost of the tokens the harness saw
   served.  ``gittins_rel`` is the widest relative gap.
2. The program is freed.  A sample of the finished requests (a run too
   short to finish any steps on, without arrivals, until one has), drawn
   from the seed, with the longest, and where there are any, requests
   swapped out and restored, is run through the reference over each
   prompt and its served tokens.  Every request is sampled: at every
   served position the reference scores the vocabulary as the program
   draws from it (logit / T plus the request's Gumbel noise) and reads
   how far the served token's score lies below the best, in logit units
   (the gap times T): ``gap_sampled`` is the widest over the sample,
   ``gap_sampled_mean`` the mean over its tokens (steady from seed to
   seed where expert routing flips on rounding make the widest gap swing:
   each configuration's ``correct`` names the numbers it limits).
3. Exact counts, limit 0: ``length_mismatch``, finished requests whose
   served count is not the length drawn for them (EOS cannot be emitted,
   so every request ends by length); ``skipped_decodes``, resident,
   prefilled requests that a step left without a token (every step
   decodes each of them once).

The control (``control=True``) reads the same numbers from the reference
in the precision below the configuration's: fp8 e4m3 GEMMs for the served
model (at each position, the f32 gap of the token the fp8 scores put
first), bfloat16 arithmetic for the index.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as ref

__all__ = ["sample", "served_gaps", "priority_gap", "exact_counts",
           "readings", "judge", "SAMPLE_TOKENS", "SAMPLE_MAX"]

# the sample: served tokens it reaches for, and requests at most
SAMPLE_TOKENS = 800
SAMPLE_MAX = 12
SWAPPED_MIN = 2


def _padded(n: int, floor: int = 64) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def sample(run, rng: np.random.Generator) -> list:
    """Request ids of the sample (see the module docstring)."""
    w = run.win
    done = [rid for rid, rec in w.recs.items()
            if rec.finish is not None and rid not in run.recomputed
            and run.reqs[rid].finish_reason == "length"]
    done.sort()
    if not done:
        return []
    served = {rid: len(run.reqs[rid].output_tokens) for rid in done}
    picked = [max(done, key=lambda r: (served[r], r))]
    swapped = [r for r in done
               if run.reqs[r].n_swap_restores > 0 and r not in picked]
    for j in rng.permutation(len(swapped))[:SWAPPED_MIN]:
        picked.append(swapped[int(j)])
    rest = [r for r in done if r not in picked]
    for j in rng.permutation(len(rest)):
        if sum(served[r] for r in picked) >= SAMPLE_TOKENS \
                or len(picked) >= SAMPLE_MAX:
            break
        picked.append(rest[int(j)])
    return picked


@torch.no_grad()
def served_gaps(run, rids, decoder, engine_seed: int, *,
                control_decoder=None, block: int = 64) -> dict:
    """Widest gap of the served tokens (or, with ``control_decoder``, of
    the tokens it puts first) below the reference's best, in logit units,
    and the gaps' spread."""
    out = {"gap_sampled": None, "tokens": 0}
    parts = []
    for rid in rids:
        r = run.reqs[rid]
        served = list(r.output_tokens)
        n_in = r.input_len
        seq = list(r.prompt_tokens) + served[:-1]
        chunks = [(a, b, _padded(b - a)) for a, b in run.chunks[rid]]
        logits = decoder.logits(seq, chunks, n_in - 1)          # (n, V)
        other = control_decoder.logits(seq, chunks, n_in - 1) \
            if control_decoder is not None else None
        t = float(r.temperature)
        dev = logits.device
        tok = torch.as_tensor(served, device=dev)
        for a in range(0, len(served), block):
            b = min(len(served), a + block)
            keys = ref.request_keys(engine_seed, rid, range(a, b), dev)
            noise = ref.gumbel_noise(keys, logits.shape[1])
            score = logits[a:b].double() / t + noise
            pick = tok[a:b] if other is None else \
                (other[a:b].double() / t + noise).argmax(dim=1)
            gap = score.max(dim=1).values - score.gather(
                1, pick[:, None])[:, 0]
            parts.append((gap * t).cpu().numpy())
        out["tokens"] += len(served)
    if parts:
        g = np.concatenate(parts)
        out["gap_sampled"] = float(g.max())
        out["gap_sampled_dist"] = {
            "tokens": int(g.size), "share_above_0": float((g > 0).mean()),
            "p50": float(np.quantile(g, 0.5)),
            "p90": float(np.quantile(g, 0.9)),
            "p99": float(np.quantile(g, 0.99)), "mean": float(g.mean())}
    return out


def priority_gap(prio: dict, control: bool = False) -> float:
    """Widest relative gap of the program's priorities (or, as the
    control, of the bfloat16 index) to the float64 reference."""
    att = ref.attained_cost(prio["input_len"], prio["generated"])
    want = ref.gittins_index(prio["support"], prio["probs"], att)
    got = ref.gittins_bf16(prio["support"], prio["probs"], att) if control \
        else prio["priority"]
    if want.size == 0:
        return 0.0
    got = np.asarray(got, np.float64)
    same = (got == want)                       # equal infinities too
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    rel = np.where(same, 0.0, rel)
    return float(np.nan_to_num(rel, nan=math.inf).max())


def exact_counts(run) -> dict:
    w = run.win
    bad = 0
    for rid, rec in w.recs.items():
        r = run.reqs[rid]
        if rec.finish is not None \
                and len(r.output_tokens) != run.meta[rid].output_len:
            bad += 1
    return {"length_mismatch": bad, "skipped_decodes": w.skipped_decodes}


def readings(run, prio: dict, rids, arch: dict, rweights, engine_seed,
             *, control: bool = False) -> dict:
    """Every number compared."""
    dec = ref.Decoder(arch, rweights, "f32")
    ctl = ref.Decoder(arch, rweights, "fp8") if control else None
    g = served_gaps(run, rids, dec, engine_seed, control_decoder=ctl)
    sampled = g.get("gap_sampled_dist")
    out = {"gap_sampled": g["gap_sampled"],
           "gap_sampled_mean": sampled["mean"] if sampled else None,
           "gittins_rel": priority_gap(prio, control=control)}
    out.update(exact_counts(run))
    out["sampled_requests"] = len(rids)
    out["sampled_tokens"] = g["tokens"]
    if sampled:
        out["gap_sampled_dist"] = sampled
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every limited number;
    a number that could not be read fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or not (v <= limit):
            ok = False
    return ok, checks
