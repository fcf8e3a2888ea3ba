"""Readings of the check for many seeds, the program's and the control's.

    python servebench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 30] [--out FILE]

For each seed a run of the cell (without a trace) and, on the same
sample, every number the check compares, read once from the program
against the float32 reference and once from the control: the reference
in the precision below the configuration's (fp8 GEMMs for the served
model, bfloat16 for the Gittins index).  The limits in the configuration
files are set from these readings (``PERF.md`` gives them).  One JSON line
a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    from servebench import check, harness
    from servebench.run import _cache_dirs, load_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _cache_dirs()
    _, _, cfg, mix = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.run_cell(cfg, mix, seed, args.seconds)
        prio = run.program_priorities()
        engine_seed = run.engine.seed
        run.release_program()
        rng = np.random.default_rng([seed % 2**48, 0x5EED])
        rids = check.sample(run, rng)
        rw = harness.reference_weights(run.params, run.arch)
        t0 = time.monotonic()
        prog = check.readings(run, prio, rids, run.arch, rw, engine_seed)
        t1 = time.monotonic()
        ctl = check.readings(run, prio, rids, run.arch, rw, engine_seed,
                             control=True)
        row = {"seed": seed, "program": prog, "control": ctl,
               "reference_s": t1 - t0,
               "swapped_in_sample": sum(run.reqs[r].n_swap_restores > 0
                                        for r in rids),
               "preemptions": run.win.counters["preemptions"],
               "live_rows": int(prio["priority"].size)}
        print(json.dumps(row, default=float), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row, default=float) + "\n")
        del run, rw, prio
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
