"""The knee sweep of an open-loop cell: the cell's traffic at each given
rate, one engine at a time in one process, without the check.

    python servebench/sweep.py --workload qwen2-1.5b.mix-poisson \\
        --rates 8,12,16,20 --seconds 30 --seed 1 [--out FILE]

Prints one JSON line a rate: the end-to-end metrics, the steps, the
preemptions, and the waiting queue's least-squares slope over the window
(requests/s) with its mean in the window's first and last thirds.  The
knee is the highest rate at which the queue does not grow: a slope times
the window under max(2, 5% of the window's arrivals).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

import numpy as np  # noqa: E402


def queue_growth(queue, start, end) -> dict:
    t = np.array([q[0] for q in queue]) - start
    n = np.array([q[1] for q in queue], np.float64)
    slope = float(np.polyfit(t, n, 1)[0]) if len(t) > 2 else 0.0
    third = (end - start) / 3
    return {"slope_rps": slope,
            "first_third": float(n[t < third].mean()) if (t < third).any()
            else 0.0,
            "last_third": float(n[t >= 2 * third].mean())
            if (t >= 2 * third).any() else 0.0}


def main(argv=None) -> int:
    from servebench import harness
    from servebench.run import _cache_dirs, load_cell, reader
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _cache_dirs()
    bench, _, cfg, mix0 = load_cell(args.workload)
    names = [m["name"] for m in bench["end_to_end"]
             if args.workload in m.get("workloads", [args.workload])]
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(mix0)
        mix["rate_rps"] = rate
        run = harness.run_cell(cfg, mix, args.seed, args.seconds)
        w = run.win
        row = {"rate_rps": rate, "arrivals": w.attempted,
               "steps": w.n_steps, "step_ms": sum(w.log.dur) / w.n_steps * 1e3,
               "counters": w.counters, "failed": w.failed,
               "queue": queue_growth(w.log.queue, w.start, w.end),
               "occupancy": w.occupancy()}
        row["grows"] = row["queue"]["slope_rps"] * w.seconds \
            >= max(2.0, 0.05 * w.attempted)
        for n in names:
            row[n] = reader(n)(w)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        run.release_program()
        del run, w
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
