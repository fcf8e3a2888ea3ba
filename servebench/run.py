"""servebench: the benchmark of the PyTorch and CUDA port of SageSched.

    python servebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on one card and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, every number compared beside its
limit (also the last lines of standard error).

A cell names a configuration (``configs/<config>.json``: the model, the
engine and scheduler settings, the limits of the check) and a traffic mix
(``traffic/<mix>.json``); each metric is read by ``metrics/<name>.py``.
Exit codes: 2 no card (or fewer than the cell needs), 3 the program cannot
be imported, 4 JAX or the JAX package was loaded, 5 a CUDA graph was
captured inside the window (the warm-up missed a shape), 1 any other
failure; no result is printed then.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its own kernels under ``build/repro_torch_kernels``)."""
    base = ROOT / "build" / "servebench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def _paths() -> None:
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_cell(workload: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell's entry, its configuration file, its mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"servebench: no workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = json.loads((root / configs[cell["config"]]["file"]
                           ).read_text())
    from servebench.traffic import load_mix
    mix = load_mix(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg_file, mix


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics the cell reports: its end-to-end ones, or with a trace
    its per-layer ones (those that list the cell, or list no cells)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", cfg_file=None, mix=None,
            model_config=None, root: Path = ROOT) -> tuple[dict, dict]:
    """One run: (the result object, the numbers compared).  ``cfg_file``,
    ``mix`` and ``model_config`` replace the cell's own (the CPU tests
    run a cell so at a small size)."""
    import numpy as np
    import torch

    from servebench import check, harness
    from servebench.trace import breakdown
    bench, _, cfg0, mix0 = load_cell(workload, root)
    cfg_file = cfg_file or cfg0
    mix = mix or mix0
    run = harness.Run(cfg_file, mix, seed, seconds, device=device,
                      model_config=model_config, trace=trace,
                      t_process=T_PROCESS)
    run.setup()
    w = run.drive()
    prio = run.program_priorities()
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = reader(m["name"])(w)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(dev),
                    "count": 1, "memory_peak_bytes": int(w.memory_peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    if trace and w.trace is not None:
        dev_info["busy_s"] = w.trace.busy_s
        dev_info["window_s"] = w.trace.window_s
    engine_seed = run.engine.seed
    run.release_program()
    rng = np.random.default_rng([int(seed) % 2**48, 0x5EED])
    rids = check.sample(run, rng)
    rweights = harness.reference_weights(run.params, run.arch)
    values = check.readings(run, prio, rids, run.arch, rweights, engine_seed)
    ok, checks = check.judge(values, cfg_file["correct"])
    result = {"correct": ok, "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": dev_info}
    if trace and w.trace is not None:
        result["breakdown"] = breakdown(w.trace)
    result["checks"] = checks
    info = {"values": values, "window_s": w.seconds, "steps": w.n_steps,
            "setup_s": w.setup_s, "captures_in_window": w.captures,
            "warm_keys": run.warm_keys, "counters": w.counters,
            "occupancy": w.occupancy()}
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    _paths()
    import torch
    bench, cell, _, _ = load_cell(args.workload)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"servebench: {args.workload} needs {need} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"servebench: cannot import the program: {exc}",
              file=sys.stderr)
        return 3
    result, info = execute(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    print(json.dumps({"servebench_info": info}, default=float),
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"servebench: modules loaded that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 4
    if info["captures_in_window"]:
        print(f"servebench: {info['captures_in_window']} CUDA graph(s) "
              "captured inside the window: the warm-up missed a shape, so "
              "the window timed a capture", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
