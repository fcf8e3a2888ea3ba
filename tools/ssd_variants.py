"""Time the SSD scan kernels on the card against the kernels they
replaced.

The forward: the package's kernel (``src/repro_torch/csrc/ssd_scan.cu``:
four passes on the tensor cores) beside the kernel it replaced
(``tools/ssd_variants/scalar.cu``: one block per head, scalar f32
products) and a variant tried (``tools/ssd_variants/wgmma_scan.cu``: pass
4's W x on wgmma), at mamba2-2.7b's and zamba2-1.2b's prefill shapes (B
1, S 1024).  With ``--backward``, the backward: the package's kernel
(``src/repro_torch/csrc/ssd_scan_bwd.cu``: seven passes on the tensor
cores) beside the one it replaced (``tools/ssd_variants/bwd_scalar.cu``:
f32 on the CUDA cores, per-head dB and dC partials), at both models'
training shapes (B 2 and B 8, S 1024).  Each kernel is held to the plain
version and timed as CUDA-graph replays in turns (package, variants,
variants reversed, package); then the package kernel's passes under
``torch.profiler`` (device time per pass).

    python3 tools/ssd_variants.py [--backward]   # one H100; builds into build/

Prints the card's name and power limit, each build's ptxas registers and
spills, then one line per (shape, variant) and one per pass.  The
replaced kernels are not part of the package; ``chip_smoke.py`` times
them too, as the parents' numbers beside the package's.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
# name: (source, entry point signature): "scalar" is the replaced forward
# kernel's, "passes" the package forward's (with its scratch), "backward"
# the replaced backward kernel's (with its scratch)
SOURCES = {"scalar": (ROOT / "tools" / "ssd_variants" / "scalar.cu",
                      "scalar"),
           "wgmma_scan": (ROOT / "tools" / "ssd_variants" / "wgmma_scan.cu",
                          "passes"),
           "bwd_scalar": (ROOT / "tools" / "ssd_variants" / "bwd_scalar.cu",
                          "backward")}
FORWARD = ("scalar", "wgmma_scan")
BACKWARD = ("bwd_scalar",)
OUT = ROOT / "build" / "ssd_variants"
SHAPES = (("mamba2-2.7b", 80, 64, 128), ("zamba2-1.2b", 64, 64, 64))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(names=FORWARD) -> dict:
    """One nvcc per variant source, together.  Returns, per name, the
    variant's ``scan(x, dt, a, bm, cm, init_state, chunk)`` -> (y, state)
    (a backward variant's ``backward(x, dt, a, bm, cm, init_state, dy,
    dstate, chunk)`` -> (dx, ddt, da, dB, dC, dinit)) and the compiler's
    output."""
    import torch

    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.ssd_scan.ops import _scratch, _whole_chunks

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
        if SOURCES[name][1] == "backward":
            built[name] = (_backward_entry(OUT / f"{name}.so", name,
                                           _whole_chunks), log)
            continue
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


def _backward_entry(lib: Path, name: str, whole_chunks):
    """The replaced backward kernel's entry point with its own scratch:
    cum (B, nc, H, q), the states and their gradients (B, nc, H, P, N),
    C.B^T (B, nc, q, q), the per-head dB and dC partials (B, nc, H, q, N);
    padded to whole chunks as the op pads."""
    import torch

    fn = ctypes.CDLL(str(lib)).ssd_scan_backward
    fn.argtypes = [_P] * 20 + [_I] * 6 + [_P]
    fn.restype = _I

    def backward(x, dt, a, bm, cm, init_state, dy, dstate=None, chunk=256):
        b, s, h, p = x.shape
        n = bm.shape[-1]
        q = min(chunk, s)
        x, dt, a, bm, cm, dy = whole_chunks(q, x, dt, a, bm, cm, dy)
        nc = x.shape[1] // q
        dx, ddt, da, dbm, dcm = (torch.empty_like(t)
                                 for t in (x, dt, a, bm, cm))
        dinit = None if init_state is None else torch.empty_like(init_state)
        f32 = dict(dtype=torch.float32, device=x.device)
        scratch = (torch.empty((b, nc, h, q), **f32),
                   torch.empty((b, nc, h, p, n), **f32),
                   torch.empty((b, nc, h, p, n), **f32),
                   torch.empty((b, nc, q, q), **f32),
                   torch.empty((b, nc, h, q, n), **f32),
                   torch.empty((b, nc, h, q, n), **f32))
        ptr = (lambda t: None if t is None else t.data_ptr())
        code = fn(*(ptr(t) for t in (
            x, dt, a, bm, cm, init_state, dy, dstate, dx, ddt, da, dbm, dcm,
            dinit) + scratch), b, x.shape[1], h, p, n, q,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"ssd_scan_backward {name}: CUDA error "
                               f"{code}")
        return dx[:, :s], ddt[:, :s], da[:, :s], dbm[:, :s], dcm[:, :s], \
            dinit

    return backward


def main_backward() -> int:
    """The backward kernels at the training shapes (see the module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import BF16_TOL, check, device_ms, print_ptxas
    from repro_torch.kernels.build import build as build_package
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_backward
    from repro_torch.kernels.ssd_scan.ref import ssd_backward_reference

    print("package:")
    print_ptxas(build_package(["ssd_scan_bwd"])["ssd_scan_bwd"][1])
    variants = build(BACKWARD)
    for name, (_, log) in variants.items():
        print(f"{name}:")
        print_ptxas(log)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    for arch, h, p, n in SHAPES:
        for b in (2, 8):
            s = 1024
            x = torch.randn(b, s, h, p, generator=gen, device=dev).bfloat16()
            dt = torch.rand(b, s, h, generator=gen, device=dev) * 0.99 + 0.01
            a = torch.rand(b, s, h, generator=gen, device=dev) * 0.01 + 0.99
            bm = (torch.randn(b, s, n, generator=gen, device=dev)
                  * 0.5).bfloat16()
            cm = (torch.randn(b, s, n, generator=gen, device=dev)
                  * 0.5).bfloat16()
            dy = torch.randn(b, s, h, p, generator=gen, device=dev).bfloat16()
            args = (x, dt, a, bm, cm, None, dy, None)
            fns = {"package": ssd_scan_backward,
                   **{k: v[0] for k, v in variants.items()}}
            if b == 2:
                want = ssd_backward_reference(*args)
                for name, fn in fns.items():
                    got = fn(*args)
                    torch.cuda.synchronize()
                    for gname, g, w in zip(("dx", "ddt", "da", "dB", "dC"),
                                           got, want):
                        check(f"{arch} B {b} {name}: {gname}", g, w,
                              BF16_TOL)
                del want
            order = list(fns) + list(reversed(fns))
            times = {k: [] for k in fns}
            for name in order:
                fn = fns[name]
                times[name].append(device_ms(lambda: fn(*args), iters=5))
            for name, ms in times.items():
                print(f"{arch} backward (B {b}, S {s}, H {h}, P {p}, N {n}) "
                      f"{name}: {' / '.join(f'{t:.4f}' for t in ms)} ms")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    ssd_scan_backward(*args)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                if "bwd" in ev.key and dev_us:
                    print(f"{arch} B {b} pass {ev.key[:60]}: "
                          f"{dev_us / 5 / 1e3:.4f} ms a call")
            del x, dt, a, bm, cm, dy, args
    return 0


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
    if sys.argv[1:] == ["--backward"]:
        return main_backward()
    if sys.argv[1:]:
        print(f"usage: {sys.argv[0]} [--backward]", file=sys.stderr)
        return 2
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
