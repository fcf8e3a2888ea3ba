"""Time flash prefill variants on the card: the package's kernel
(``src/repro_torch/csrc/flash_attention.cu``) beside two experiments,
each at the flash paths' prefill shapes, held against the plain version
and timed as CUDA-graph replays:

- ``tools/flash_variants/pipelined.cu``: tile j + 1's QK^T in flight
  with tile j's value product (one and two consumer warpgroups, the two
  in a named-barrier ping-pong);
- ``tools/flash_variants/wide.cu``: the package's consumer with two or
  three warpgroups a block sharing each K/V tile, with and without a
  token ring ("ring") through which they take turns on the tensor
  cores.

    python3 tools/flash_variants.py      # one H100; builds into build/

Prints the card's name and power limit, then one line per (shape,
variant).  The experiment is not part of the package; it stays so that
its numbers in PERF.md can be remeasured.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from chip_smoke import device_ms  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference)

CSRC = ROOT / "src" / "repro_torch" / "csrc"
SOURCES = {"package": CSRC / "flash_attention.cu",
           "pipelined": ROOT / "tools" / "flash_variants" / "pipelined.cu",
           "wide": ROOT / "tools" / "flash_variants" / "wide.cu"}
# each experiment's instances by head dim: consumer warpgroups, negative
# for the wide variant's token ring
INSTANCES = {"pipelined": {64: (1, 2), 128: (1, 2), 192: (1,)},
             "wide": {64: (2, 3, -2, -3), 128: (2, -2), 192: ()}}
OUT = ROOT / "build" / "flash_variants"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build() -> dict:
    """One nvcc per source, together; the entry points of each library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / f"{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, src in SOURCES.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {SOURCES[name]}:\n{log}")
        report_ptxas(name, log)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        op = lib.flash_attention_prefill
        op.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
        op.restype = _I
        inst = getattr(lib, "flash_attention_prefill_instance", None)
        if inst is not None:
            inst.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
            inst.restype = _I
        fns[name] = (op, inst)
    return fns


def report_ptxas(name: str, log: str) -> None:
    """Each prefill instance's registers and spills, from ptxas -v."""
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*flash_prefill_kernel"
                      r"I(\w*?)EEv", line)
        if m:
            entry = "<" + ", ".join(re.findall(r"L[ib](\d+)E",
                                               m.group(1) + "E")) + ">"
        elif entry and ("Used" in line or "spill stores" in line):
            print(f"ptxas {name} {entry}: {line.split(':')[-1].strip()}")


def case(gen, dev, b, sq, sk, h, kvh, dh):
    """q, k, v and positions, the queries at the end of the keys."""
    q = torch.randn(b, sq, h, dh, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    pos = (sk - sq + torch.arange(sq, device=dev)).int()
    kpos = torch.arange(sk, device=dev, dtype=torch.int32)
    return q, k, v, pos, kpos


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = (("seamless encoder, dh 64, bidirectional", (1, 4096, 4096, 16, 16, 64), 0),
              ("llama3.2-1b C 512 over 1024, causal", (1, 512, 1024, 32, 8, 64), 1),
              ("qwen2-1.5b C 512 over 1024, dh 128", (1, 512, 1024, 12, 2, 128), 1),
              ("nemotron-4-340b C 512 over 1024, dh 192", (1, 512, 1024, 96, 8, 192), 1),
              ("zamba2-1.2b C 1024, causal", (1, 1024, 1024, 32, 32, 64), 1))
    for label, shape, causal in shapes:
        q, k, v, pos, kpos = case(gen, dev, *shape)
        b, sq, h, dh = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        want = attention_reference(q, k, v, pos, kpos,
                                   causal=bool(causal)).float()
        for name, (op, inst) in fns.items():
            runs = [("", None)] if name != "wide" else []
            if inst is not None:
                runs += [(f" {abs(w)} warpgroup(s){' ring' * (w < 0)}", w)
                         for w in INSTANCES[name][dh]]
            for tag, wg in runs:
                out = torch.empty_like(q)

                def run():
                    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            pos.data_ptr(), kpos.data_ptr(), out.data_ptr(),
                            b, sq, sk, h, kvh, dh, causal, 0, dh ** -0.5]
                    stream = torch.cuda.current_stream().cuda_stream
                    rc = inst(*args, wg, stream) if wg else op(*args, stream)
                    if rc:
                        raise SystemExit(f"{name}{tag}: CUDA error {rc}")
                run()
                torch.cuda.synchronize()
                err = float((out.float() - want).abs().max())
                print(f"{label}: {name}{tag} {device_ms(run, iters=10):.4f} "
                      f"ms, max abs err {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
