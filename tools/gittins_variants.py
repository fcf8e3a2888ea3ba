"""Time the Gittins refresh kernel on the card: the package's kernel
(``src/repro_torch/csrc/gittins.cu``: four columns a lane in 16-byte
loads, several rows a warp, one row group a warp) beside the kernel it
replaced (``tools/gittins_variants/warp_row.cu``: one warp a row,
ceil(k / 32) scalar columns a lane) and a grid-stride variant
(``tools/gittins_variants/grid_stride.cu``: warps walk the row groups
with a grid stride over the blocks the card holds at once), at the
refresh shapes of ``chip_smoke.py`` phase 6, each held to the plain
version and timed as CUDA-graph replays in turns (package, variants,
variants reversed, package).  At (16384, 256), 33.7 MB, the calls also
cycle over four copies of the inputs (135 MB, beyond the 50 MB L2), so
each reads from HBM.

    python3 tools/gittins_variants.py      # one H100; builds into build/

Prints the card's name and power limit, each build's ptxas registers and
spills, then one line per (shape, variant) with the byte bound.  The
variants are not part of the package; ``chip_smoke.py`` times the
replaced kernel too, as the parent's number beside the package's.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
SOURCES = {name: ROOT / "tools" / "gittins_variants" / f"{name}.cu"
           for name in ("warp_row", "grid_stride")}
OUT = ROOT / "build" / "gittins_variants"
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(names=tuple(SOURCES)) -> dict:
    """One nvcc per variant source, together.  Returns, per name, the
    variant's ``fn(support, probs, attained)`` -> out (f32 tensors on the
    card, k a power of two in [8, 256]) and the compiler's output."""
    import torch

    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / f"{name}.so"),
         str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {SOURCES[name]}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).gittins_attained
        fn.argtypes = [_P] * 4 + [_I] * 2 + [_P]
        fn.restype = _I

        def run(support, probs, attained, fn=fn):
            n, k = support.shape
            out = torch.empty(n, dtype=torch.float32, device=support.device)
            code = fn(support.data_ptr(), probs.data_ptr(),
                      attained.data_ptr(), out.data_ptr(), n, k,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"gittins variant: CUDA error {code}")
            return out

        built[name] = (run, log)
    return built


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from chip_smoke import (GITTINS_COLD, GITTINS_RTOL, GITTINS_SHAPES,
                            check, device_ms, gittins_bound, gittins_case,
                            print_ptxas)
    from repro_torch.kernels.build import build as build_package
    from repro_torch.kernels.gittins.ops import gittins_attained
    from repro_torch.kernels.gittins.ref import gittins_attained_reference

    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("package:")
    print_ptxas(build_package(["gittins"])["gittins"][1])
    variants = build()
    for name, (_, log) in variants.items():
        print(f"{name}:")
        print_ptxas(log)
    dev = torch.device("cuda", 0)
    fns = {"package": gittins_attained,
           **{k: v[0] for k, v in variants.items()}}
    for n, k in ((8, 8),) + GITTINS_SHAPES:
        copies = GITTINS_COLD if (n, k) == GITTINS_SHAPES[-1] else 1
        inputs = [[torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                   for x in gittins_case(n, k, seed=n + k + i)]
                  for i in range(copies)]
        want = gittins_attained_reference(*inputs[0])
        for name, fn in fns.items():
            got = fn(*inputs[0])
            torch.cuda.synchronize()
            check(f"({n}, {k}) {name}", got, want, GITTINS_RTOL, rel=True)
        bound = gittins_bound(n, k)[0]
        for label, sets in (("warm", inputs[:1]), ("cold", inputs)):
            if label == "cold" and copies == 1:
                continue
            order = list(fns) + list(reversed(fns))
            times = {name: [] for name in fns}
            for name in order:
                cyc, fn = itertools.cycle(sets), fns[name]
                times[name].append(device_ms(lambda: fn(*next(cyc)),
                                             iters=40))
            for name, ms in times.items():
                print(f"({n}, {k}) {label} {name}: "
                      f"{' / '.join(f'{t:.5f}' for t in ms)} ms "
                      f"(byte bound {bound:.3e} ms, "
                      f"{bound / min(ms):.1%} of it)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
