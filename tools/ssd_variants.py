"""Time the SSD scan kernel on the card: the package's kernel
(``src/repro_torch/csrc/ssd_scan.cu``: four passes on the tensor cores)
beside the kernel it replaced (``tools/ssd_variants/scalar.cu``: one
block per head, scalar f32 products) and a variant tried
(``tools/ssd_variants/wgmma_scan.cu``: pass 4's W x on wgmma), at
mamba2-2.7b's and zamba2-1.2b's prefill shapes (B 1, S 1024), each held
to the plain chunked version and timed as CUDA-graph replays in turns
(package, variants, variants reversed, package); then the package
kernel's four passes under ``torch.profiler`` (device time per pass).

    python3 tools/ssd_variants.py      # one H100; builds into build/

Prints the card's name and power limit, each build's ptxas registers and
spills, then one line per (shape, variant) and one per pass.  The scalar
kernel is not part of the package; ``chip_smoke.py`` times it too, as the
parent's number beside the package's.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
# name: (source, entry point signature): "scalar" is the replaced
# kernel's, "passes" the package kernel's (with its scratch)
SOURCES = {"scalar": (ROOT / "tools" / "ssd_variants" / "scalar.cu",
                      "scalar"),
           "wgmma_scan": (ROOT / "tools" / "ssd_variants" / "wgmma_scan.cu",
                          "passes")}
OUT = ROOT / "build" / "ssd_variants"
SHAPES = (("mamba2-2.7b", 80, 64, 128), ("zamba2-1.2b", 64, 64, 64))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(names=tuple(SOURCES)) -> dict:
    """One nvcc per variant source, together.  Returns, per name, the
    variant's ``scan(x, dt, a, bm, cm, init_state, chunk)`` -> (y, state)
    and the compiler's output."""
    import torch

    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.ssd_scan.ops import _scratch

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / f"{name}.so"),
         str(SOURCES[name][0])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in names}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {SOURCES[name][0]}:\n{log}")
        passes = SOURCES[name][1] == "passes"
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).ssd_scan
        fn.argtypes = [_P] * (12 if passes else 8) + [_I] * 6 + [_P]
        fn.restype = _I

        def scan(x, dt, a, bm, cm, init_state=None, chunk=256, fn=fn,
                 passes=passes):
            b, s, h, p = x.shape
            n = bm.shape[-1]
            q = min(chunk, s)
            if s % q:
                raise ValueError("the variants take whole chunks")
            y = torch.empty_like(x)
            state = torch.empty((b, h, p, n), dtype=torch.float32,
                                device=x.device)
            scratch = (_scratch(b, s // q, h, p, n, q, x.device)
                       if passes else ())
            code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      bm.data_ptr(), cm.data_ptr(),
                      None if init_state is None else init_state.data_ptr(),
                      y.data_ptr(), state.data_ptr(),
                      *(t.data_ptr() for t in scratch), b, s, h, p, n, q,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"ssd_scan variant: CUDA error {code}")
            return y, state

        built[name] = (scan, log)
    return built


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (BF16_TOL, SSD_STATE_TOL, check, device_ms,
                            print_ptxas)
    from repro_torch.kernels.build import build as build_package
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_reference

    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("package:")
    print_ptxas(build_package(["ssd_scan"])["ssd_scan"][1])
    variants = build()
    for name, (_, log) in variants.items():
        print(f"{name}:")
        print_ptxas(log)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    for arch, h, p, n in SHAPES:
        s = 1024
        x = torch.randn(1, s, h, p, generator=gen, device=dev).bfloat16()
        dt = torch.rand(1, s, h, generator=gen, device=dev) * 0.99 + 0.01
        a = torch.rand(1, s, h, generator=gen, device=dev) * 0.499 + 0.5
        bm = (torch.randn(1, s, n, generator=gen, device=dev)
              * 0.5).bfloat16()
        cm = (torch.randn(1, s, n, generator=gen, device=dev)
              * 0.5).bfloat16()
        ry, rst = ssd_chunked_reference(x, dt, a, bm, cm)
        fns = {"package": ssd_scan,
               **{k: v[0] for k, v in variants.items()}}
        for name, fn in fns.items():
            y, st = fn(x, dt, a, bm, cm)
            torch.cuda.synchronize()
            check(f"{arch} {name}: y (bf16)", y, ry, BF16_TOL)
            check(f"{arch} {name}: final state (f32)", st, rst,
                  SSD_STATE_TOL)
        order = list(fns) + list(reversed(fns))
        times = {k: [] for k in fns}
        for name in order:
            fn = fns[name]
            times[name].append(device_ms(lambda: fn(x, dt, a, bm, cm)))
        for name, ms in times.items():
            print(f"{arch} (B 1, S {s}, H {h}, P {p}, N {n}) {name}: "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ssd_scan(x, dt, a, bm, cm)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            if "ssd" in ev.key and dev_us:
                print(f"{arch} pass {ev.key[:60]}: {dev_us / 20 / 1e3:.4f} "
                      f"ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
