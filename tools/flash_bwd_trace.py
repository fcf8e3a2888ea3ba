"""Trace where a tile iteration of the flash backward's dK/dV pass spends
its cycles, on the card.

Writes a copy of the package's kernel (``src/repro_torch/csrc/
flash_attention_bwd.cu``) with ``clock64()`` stamps at each phase of the
dK/dV loop (the producer warps' wait for a free stage and their copies;
the first consumer warpgroup's wait for a full stage, S^T, the P^T
exponent loop, the wait for the exchange buffer, the store of P^T and dV;
the second's dP^T, the wait for P^T, dS^T and dK) of the first warp of
each role in blocks 0 .. 15 of (kv head 0, batch row 0), builds it into
``build/flash_bwd_trace/``, runs it once at each of ``chip_smoke.py``'s
``BWD_CASES`` and prints, for blocks 0 and 7, the median cycles of each
phase over iterations 1 .. 14 and the median period of an iteration.
The stamps cost registers (the copy may spill where the package does
not) and some issue slots: read the phases against each other, not the
copy's time against the package's.

    python3 tools/flash_bwd_trace.py      # one H100

The copy is made by inserting the stamps at fixed lines of the package's
source; a change to those lines makes this script stop with the line it
could not find.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_bwd_trace"
BLOCKS, ITERS, PHASES = 16, 16, 8

STAMP = '''#include "hopper.cuh"

__device__ long long* g_trace = nullptr;
#define TR(role, it, ph)                                                    \\
  do {                                                                      \\
    if (g_trace && blockIdx.y == 0 && blockIdx.z == 0 &&                    \\
        blockIdx.x < BLOCKS && (threadIdx.x & 31) == 0 &&                   \\
        ((threadIdx.x >> 5) & 3) == 0 && (it) < ITERS)                      \\
      g_trace[((blockIdx.x * 3 + (role)) * ITERS + (it)) * PHASES + (ph)] = \\
          clock64();                                                        \\
  } while (0)
extern "C" __attribute__((visibility("default"))) int set_trace(void* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
'''.replace("BLOCKS", str(BLOCKS)).replace("ITERS", str(ITERS)).replace(
    "PHASES", str(PHASES))

# (function, [(line, the line with its stamps)]): role 0 the first consumer
# warpgroup, 1 the second, 2 the producer warps
MARKS = (
    ("void p_consumer(", [
        ("  for (int it = 0;; ++it) {\n    mbar_wait(&full[stage], phase);\n",
         "  for (int it = 0;; ++it) {\n    TR(0, it, 0);\n"
         "    mbar_wait(&full[stage], phase);\n    TR(0, it, 1);\n"),
        ("    wgmma_wait<0>();\n    fence_regs(s);\n",
         "    wgmma_wait<0>();\n    fence_regs(s);\n    TR(0, it, 2);\n"),
        ("    const int buf = it & 1;\n",
         "    TR(0, it, 3);\n    const int buf = it & 1;\n"),
        ("    float* pb = pbuf + buf * 32 * 128;\n",
         "    TR(0, it, 4);\n    float* pb = pbuf + buf * 32 * 128;\n"),
        ("    mbar_arrive(&p_full[buf]);\n",
         "    mbar_arrive(&p_full[buf]);\n    TR(0, it, 5);\n"),
        ("    wgmma_wait<0>();\n    fence_regs(acc);\n",
         "    wgmma_wait<0>();\n    fence_regs(acc);\n    TR(0, it, 6);\n"),
    ]),
    ("void ds_consumer(", [
        ("  for (int it = 0;; ++it) {\n    mbar_wait(&full[stage], phase);\n",
         "  for (int it = 0;; ++it) {\n    TR(1, it, 0);\n"
         "    mbar_wait(&full[stage], phase);\n    TR(1, it, 1);\n"),
        ("    wgmma_wait<0>();\n    fence_regs(dp);\n",
         "    wgmma_wait<0>();\n    fence_regs(dp);\n    TR(1, it, 2);\n"),
        ("    const float* pb = pbuf + buf * 32 * 128;\n",
         "    TR(1, it, 3);\n    const float* pb = pbuf + buf * 32 * 128;\n"),
        ("    if (lane == 0) mbar_arrive(&p_empty[buf]);\n",
         "    if (lane == 0) mbar_arrive(&p_empty[buf]);\n    TR(1, it, 4);\n"),
        ("    wgmma_wait<0>();\n    fence_regs(acc);\n",
         "    wgmma_wait<0>();\n    fence_regs(acc);\n    TR(1, it, 5);\n"),
    ]),
    ("void kv_producer(", [
        ("  int stage = 0, phase = 1;  // the first pass finds every slot free\n",
         "  int stage = 0, phase = 1;  // the first pass finds every slot free\n"
         "  int issued = 0;\n"),
        ("    mbar_wait(&empty[stage], phase);\n    if (w == 0) {",
         "    TR(2, issued, 0);\n    mbar_wait(&empty[stage], phase);\n"
         "    TR(2, issued, 1);\n    if (w == 0) {"),
        ("    mbar_arrive_on_cp_async(&full[stage]);  // once this lane's "
         "copies land\n",
         "    mbar_arrive_on_cp_async(&full[stage]);  // once this lane's "
         "copies land\n    TR(2, issued, 2);\n    ++issued;\n"),
    ]),
)
NAMES = {0: ("wait full", "S^T", "P^T", "wait buffer", "store P^T", "dV"),
         1: ("wait full", "dP^T", "wait P^T", "dS^T", "dK"),
         2: ("wait empty", "copies")}


def traced_source() -> str:
    """The package's source with the stamps inserted."""
    s = (CSRC / "flash_attention_bwd.cu").read_text()
    s = s.replace('#include "hopper.cuh"\n', STAMP, 1)
    for fname, marks in MARKS:
        a = s.index(fname)
        b = s.index("\n}\n", a)
        seg = s[a:b]
        for line, stamped in marks:
            if seg.count(line) != 1:
                raise SystemExit(f"flash_bwd_trace: {fname} no longer has "
                                 f"exactly one line {line!r}")
            seg = seg.replace(line, stamped)
        s = s[:a] + seg + s[b:]
    return s


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from chip_smoke import BWD_CASES, bwd_case, print_ptxas
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.flash_attention.ops import (
        backward_head_split, flash_attention_lse)

    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "flash_bwd_trace.cu"
    src.write_text(traced_source())
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o",
                           str(OUT / "trace.so"), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print_ptxas(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(OUT / "trace.so"))
    fn = lib.flash_attention_backward
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.set_trace.argtypes = [ctypes.c_void_p]
    lib.set_trace.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for spec in BWD_CASES:
        causal, window = spec[6], spec[7]
        q, k, v, dout, pos, kv_pos = bwd_case(spec, dev, gen)
        out, lse = flash_attention_lse(q, k, v, pos, kv_pos, causal=causal,
                                       window=window)
        b, sq, h, dh = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dsum = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        split = backward_head_split(b, sk, h, kvh)
        part = (torch.empty((2, 2, b, sk, kvh, dh), dtype=torch.float32,
                            device=dev) if split else None)
        stamps = torch.zeros(BLOCKS * 3 * ITERS * PHASES, dtype=torch.int64,
                             device=dev)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), pos.data_ptr(),
                    kv_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), dsum.data_ptr(),
                    None if part is None else part.data_ptr(), b, sq, sk, h,
                    kvh, dh, int(causal), int(window), dh ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"traced kernel: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        lib.set_trace(stamps.data_ptr())
        call()
        torch.cuda.synchronize()
        lib.set_trace(None)
        t = stamps.view(BLOCKS, 3, ITERS, PHASES).cpu()
        print(f"{spec[0]} (head split: {split}); cycles, median over "
              f"iterations 1-14")
        for blk in (0, 7):
            for role, names in NAMES.items():
                rows, periods = [], []
                for it in range(1, ITERS - 1):
                    ts = t[blk, role, it]
                    if (ts[:len(names) + 1] != 0).all():
                        rows.append([int(ts[i + 1] - ts[i])
                                     for i in range(len(names))])
                    if ts[0] and t[blk, role, it + 1, 0]:
                        periods.append(int(t[blk, role, it + 1, 0] - ts[0]))
                if not rows:
                    continue
                med = [sorted(c)[len(c) // 2] for c in zip(*rows)]
                period = sorted(periods)[len(periods) // 2] if periods \
                    else -1
                print(f"  block {blk} role {role}: period {period}; " +
                      ", ".join(f"{n} {m}" for n, m in zip(names, med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
