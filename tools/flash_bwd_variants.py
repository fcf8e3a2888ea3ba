"""Time the flash backward kernel on the card: the package's kernel
(``src/repro_torch/csrc/flash_attention_bwd.cu``: dK/dV and dQ passes on
wgmma) beside the kernel it replaced (``tools/flash_variants/
bwd_mma_sync.cu``: mma.sync, a block per 64-column block of dh), at
``chip_smoke.py``'s backward shapes (``BWD_CASES``), each held to the
plain version (``attention_backward_reference``) and timed as CUDA-graph
replays in turns (package, parent, parent, package); then each call's
passes (D, dK/dV, dQ) under ``torch.profiler`` (device time per pass).

    python3 tools/flash_bwd_variants.py      # one H100; builds into build/

Prints the card's name and power limit, each build's ptxas registers and
spills, then one line per (shape, kernel) and one per pass.  The parent
kernel is not part of the package; ``chip_smoke.py`` phase 6c (a) times
it too, as the parent's number beside the package's.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
# name: source of a kernel with the package's C entry point
SOURCES = {"bwd_mma_sync": ROOT / "tools" / "flash_variants" /
           "bwd_mma_sync.cu"}
OUT = ROOT / "build" / "flash_bwd_variants"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(names=tuple(SOURCES)) -> dict:
    """One nvcc per source, together.  Returns, per name, the variant's
    ``backward(q, k, v, pos, kv_pos, out, lse, dout, causal=, window=)``
    -> (dq, dk, dv) and the compiler's output."""
    import torch

    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / f"{name}.so"),
         str(SOURCES[name])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in names}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {SOURCES[name]}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_backward
        fn.argtypes = [_P] * 12 + [_I] * 8 + [_F, _P]
        fn.restype = _I

        def backward(q, k, v, pos, kv_pos, out, lse, dout, *, causal=True,
                     window=0, fn=fn, name=name):
            b, sq, h, dh = q.shape
            sk, kvh = k.shape[1], k.shape[2]
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            dsum = torch.empty((b, h, sq), dtype=torch.float32,
                               device=q.device)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      pos.data_ptr(), kv_pos.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), b, sq,
                      sk, h, kvh, dh, int(causal), int(window), dh ** -0.5,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"flash backward {name}: CUDA error "
                                   f"{code}")
            return dq, dk, dv

        built[name] = (backward, log)
    return built


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (BWD_CASES, attn_check, bwd_case, device_ms,
                            print_ptxas)
    from repro_torch.kernels.build import build as build_package
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward, flash_attention_lse)
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)

    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("package:")
    print_ptxas(build_package(["flash_attention_bwd"])
                ["flash_attention_bwd"][1])
    variants = build()
    for name, (_, log) in variants.items():
        print(f"{name}:")
        print_ptxas(log)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    for spec in BWD_CASES:
        label = spec[0]
        causal, window = spec[6], spec[7]
        q, k, v, dout, pos, kv_pos = bwd_case(spec, dev, gen)
        kw = dict(causal=causal, window=window)
        out, lse = flash_attention_lse(q, k, v, pos, kv_pos, **kw)
        want = attention_backward_reference(q, k, v, pos, kv_pos, out, lse,
                                            dout, **kw)
        fns = {"package": flash_attention_backward,
               **{name: fn for name, (fn, _) in variants.items()}}
        for name, fn in fns.items():
            got = fn(q, k, v, pos, kv_pos, out, lse, dout, **kw)
            torch.cuda.synchronize()
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                attn_check(f"{label} {name} {gname}", g, w)
        order = list(fns) + list(reversed(fns))
        times = {name: [] for name in fns}
        for name in order:
            fn = fns[name]
            times[name].append(device_ms(
                lambda: fn(q, k, v, pos, kv_pos, out, lse, dout, **kw)))
        for name, ms in times.items():
            print(f"{label} {name}: {' / '.join(f'{t:.4f}' for t in ms)} ms")
        for name, fn in fns.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn(q, k, v, pos, kv_pos, out, lse, dout, **kw)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                if "flash_bwd" in ev.key and dev_us:
                    print(f"{label} {name} pass {ev.key[:60]}: "
                          f"{dev_us / 10 / 1e3:.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
