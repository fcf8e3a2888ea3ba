"""Time the sampling kernel on the card beside the kernel it replaced,
count its per-column instructions in the built SASS, and check its
division and noise against the library's over every input.

The package's kernel (``src/repro_torch/csrc/categorical.cu``: one launch,
64 column blocks a lane whose last block merges the lane) is timed beside
the kernel it replaced (``tools/categorical_variants/two_launch.cu``: 64
column blocks a lane and a merge kernel) and beside the first design of
its redesign (``pruned.cu``: the same launch, single columns strided over
the threads, a block's columns below the Gumbel noise's bound skipped), at
``chip_smoke.py``'s sampling shapes and both of its draws.  Each is held to
the plain version (tokens equal but a near tie) and timed as CUDA-graph
replays in turns (package, variants, variants reversed, package), TURNS
times: the mean of the turns and their spread are printed.

``sass_counts`` reads the package kernel's SASS with ``cuobjdump -sass``
and counts the instructions of a sampled column's draw (``count_sass``
says how); ``--sass-out DIR`` writes the package's SASS there.

``tools/categorical_variants/exact_check.cu`` runs the kernel's division
over all 2**32 f32 bit patterns at DIVIDE_TEMPS, and its noise over all
2**23 uniforms, and counts the values whose bits differ from
``__fdiv_rn``'s and from ``-logf(-logf(u))``'s (0 expected for both).

    python3 tools/categorical_variants.py      # one H100; builds into build/

Prints the card's name and power limit, each build's ptxas registers and
spills, the SASS counts and the exact checks, then one line per (shape,
draw).
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
PACKAGE = CSRC / "categorical.cu"
VARIANTS = ROOT / "tools" / "categorical_variants"
# name: (source, entry point's kind)
SOURCES = {
    "two_launch": (VARIANTS / "two_launch.cu", "two_launch"),
    "pruned": (VARIANTS / "pruned.cu", "pruned"),
    "exact_check": (VARIANTS / "exact_check.cu", "exact_check"),
}
OUT = ROOT / "build" / "categorical_variants"
# the replaced kernel's column blocks a lane (its scratch's width)
PARENT_BLOCKS = 64
# rounds of in_turns a shape and draw
TURNS = 3
# the temperatures of the division check: the engine's and the paper's,
# then 52 spread log-uniformly over [2**-7, 2**3]
DIVIDE_TEMPS = (0.6, 1.0, 0.3, 0.7, 0.8, 0.9, 0.5, 0.45, 0.25, 0.1, 1.5,
                2.0) + tuple(2.0 ** (-7 + 10 * (k + 0.5) / 52)
                             for k in range(52))
_P, _I, _L, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint, ctypes.c_float)
_ARGS = {
    "package": [_P, _I, _L, _P, _P, _P, _P, _U, _U, _P, _I, _P, _P, _I, _I,
                _L, _P],
    "two_launch": [_P, _I, _L, _P, _P, _P, _P, _U, _U, _P, _P, _I, _P, _P,
                   _I, _I, _L, _P],
    "pruned": [_P, _I, _L, _P, _P, _P, _P, _U, _U, _F, _P, _I, _P, _P, _I,
               _I, _L, _P],
}
# the f32 maximum of the noise -log(-log u) over all 2**23 uniforms: the
# bound by which pruned.cu skips columns
NOISE_MAX = 15.942384719848633


def draw_fn(fn, kind: str = "package", blocks: int = 64):
    """``draw(logits, temps, greedy, base_key, seeds, counters, offset=0)``
    -> (value, index) through the C entry point ``fn`` of ``kind``'s
    signature (the package's; the replaced kernel's, ``two_launch``; the
    first design's, ``pruned``), with ``blocks`` column blocks a lane."""
    import torch

    from repro_torch.kernels.categorical.ref import MASK32

    def draw(logits, temps, greedy, base_key, seeds, counters, offset=0):
        lanes, n = logits.shape
        dev = logits.device
        k0, k1 = (int(w) & MASK32 for w in base_key.tolist())
        value = torch.empty(lanes, dtype=torch.float32, device=dev)
        index = torch.empty(lanes, dtype=torch.int64, device=dev)
        if kind == "two_launch":
            part_v = torch.empty((lanes, blocks), dtype=torch.float32,
                                 device=dev)
            part_i = torch.empty((lanes, blocks), dtype=torch.int32,
                                 device=dev)
            mid = [part_v.data_ptr(), part_i.data_ptr(), blocks]
        else:
            partials = torch.empty((lanes, blocks, 2), dtype=torch.int32,
                                   device=dev)
            mid = [partials.data_ptr(), blocks]
            if kind == "pruned":
                mid = [NOISE_MAX] + mid
        code = fn(logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                  logits.stride(0), temps.data_ptr(), greedy.data_ptr(),
                  seeds.data_ptr(), counters.data_ptr(), k0, k1, *mid,
                  value.data_ptr(), index.data_ptr(), lanes, n, offset,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"categorical variant: CUDA error {code}")
        return value, index

    return draw


def exact_checks(lib):
    """``check()`` -> (fast-path divisions, those that differ from
    __fdiv_rn, noises that differ from -logf(-logf(u))) over DIVIDE_TEMPS,
    every f32 x and every uniform, through exact_check's library."""
    import torch

    divide, noise = lib.divide_check, lib.noise_check
    divide.argtypes, divide.restype = [_P, _I, _P, _P, _P], _I
    noise.argtypes, noise.restype = [_P, _P], _I

    def check():
        t = torch.tensor(DIVIDE_TEMPS, dtype=torch.float32, device="cuda")
        fast = torch.zeros(len(DIVIDE_TEMPS), dtype=torch.int64,
                           device="cuda")
        bad = torch.zeros_like(fast)
        bad_noise = torch.zeros(1, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for code in (divide(t.data_ptr(), len(DIVIDE_TEMPS), fast.data_ptr(),
                            bad.data_ptr(), stream),
                     noise(bad_noise.data_ptr(), stream)):
            if code:
                raise RuntimeError(f"exact_check: CUDA error {code}")
        return int(fast.sum()), int(bad.sum()), int(bad_noise)

    return check


def build(names=tuple(SOURCES)) -> dict:
    """One nvcc per variant, together.  Returns, per name, the variant's
    callable and the compiler's output: a draw (``draw_fn``) for the
    kernels, ``exact_checks`` for exact_check."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / f"{name}.so"),
         str(SOURCES[name][0])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        kind = SOURCES[name][1]
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if kind == "exact_check":
            built[name] = (exact_checks(lib), log)
            continue
        fn = lib.categorical_sample
        fn.argtypes = _ARGS[kind]
        fn.restype = _I
        built[name] = (draw_fn(fn, kind), log)
    return built


# --------------------------------------------------------------- SASS

# the integer ALU pipe's opcodes (Nsight Compute's "alu": integer and
# logic, not IMAD / IMUL, which issue on the FMA pipe)
ALU = frozenset(("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA",
                 "ISETP", "IMNMX", "SEL", "PRMT", "POPC", "FLO", "BREV",
                 "BMSK", "SGXT", "IABS", "PLOP3"))
IMAD = frozenset(("IMAD", "IMUL", "VIADD", "VIMNMX"))
FP32 = frozenset(("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FCHK",
                  "FSET"))
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_LABEL = re.compile(r"^\s*\.L_x_\d+:")
# the main path's instance: categorical_kernel<__nv_bfloat16, 256, 8> (256
# threads, 8 columns a thread)
KERNEL_RE = re.compile(r"categorical_kernel.*nv_bfloat16Li256ELi8E")


def cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    return str(default) if default.exists() else None


def _function_lines(sass: str) -> dict:
    """Each function's instructions [(whether a label precedes it,
    (opcode with modifiers, text))]."""
    funcs, name, label = {}, None, False
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
            continue
        if name is None:
            continue
        if _LABEL.match(line):
            label = True
            continue
        insn = _INSN.search(line)
        if not insn:
            continue
        words = insn.group(2).strip().split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            funcs[name].append((label, (words[0], insn.group(2).strip())))
            label = False
    return funcs


def _classes(body) -> Counter:
    count = Counter()
    for _, op, _ in body:
        base = op.split(".")[0]
        cls = ("alu" if base in ALU else "imad" if base in IMAD
               else "fp32" if base in FP32 else "mufu" if base == "MUFU"
               else "other")
        count[cls] += 1
        count["all"] += 1
    return count


def sass_of(library: Path) -> str:
    """``cuobjdump -sass library``.  Raises if cuobjdump is missing."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    return subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_counts(library: Path) -> dict:
    """``count_sass`` of the library's SASS."""
    return count_sass(sass_of(library))


def _blocks(insns) -> list:
    """The function's straight-line runs of instructions: a run ends at a
    label and after a branch, call, return, exit or convergence barrier."""
    runs, cur = [], []
    for line, (op, text) in insns:
        if line and cur:
            runs.append(cur)
            cur = []
        cur.append((op, text))
        if op.split(".")[0] in _ENDS:
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    return runs


_ENDS = frozenset(("BRA", "EXIT", "RET", "CALL", "BSYNC", "BSSY", "WARPSYNC",
                   "BREAK", "JMP"))


def count_sass(sass: str) -> dict:
    """The instructions of a sampled column's draw in the main path's
    instance (categorical_kernel<__nv_bfloat16, 256, 8>): each pair of
    columns is drawn in one straight-line run (two threefry chains: 40
    SHF; four logs: some 44 FFMA), and a column is half of such a run, by
    class (``column``, a Counter: alu, imad, fp32, mufu, other, all),
    averaged over the instance's ``runs``.  The column's load and its
    division (three FFMA, before the key's barrier) are not in it.
    Raises if no such run is found."""
    insns = None
    for name, lines in _function_lines(sass).items():
        if KERNEL_RE.search(name):
            insns = lines
    if insns is None:
        raise RuntimeError("cuobjdump: no categorical_kernel<__nv_bfloat16, "
                           "256, 8>")
    draws = []
    for run in _blocks(insns):
        ops = [op.split(".")[0] for op, _ in run]
        if ops.count("SHF") >= 40 and ops.count("FFMA") >= 40:
            draws.append(_classes([(0, op, text) for op, text in run]))
    if not draws:
        raise RuntimeError("no run with two columns' threefry and logs in "
                           "the SASS")
    total = sum(draws, Counter())
    return {"column": Counter({k: v / (2 * len(draws))
                               for k, v in total.items()}),
            "runs": len(draws)}


def format_counts(counts: dict) -> str:
    c = counts["column"]
    return (f"a sampled column's draw ({counts['runs']} runs of two "
            f"columns): " + ", ".join(f"{k} {c[k]:.2f}" for k in
                                      ("all", "alu", "imad", "fp32", "mufu",
                                       "other")))


# --------------------------------------------------------------- timing

def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels.build import _library_path
    from repro_torch.kernels.build import build as build_package

    argv = sys.argv[1:]
    sass_out = Path(argv[argv.index("--sass-out") + 1]) \
        if "--sass-out" in argv else None
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import (CATEGORICAL_DRAWS, categorical_agrees,
                            categorical_bound_ms, categorical_shapes,
                            categorical_case, in_turns, print_ptxas)
    from repro_torch.kernels.categorical import categorical
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("package:")
    print_ptxas(build_package(["categorical"])["categorical"][1])
    variants = build()
    fast, bad, bad_noise = variants.pop("exact_check")[0]()
    print(f"division over every f32 x at {len(DIVIDE_TEMPS)} temperatures: "
          f"{fast} fast-path divisions, {bad} differ from __fdiv_rn; noise "
          f"over all 2**23 uniforms: {bad_noise} differ from "
          f"-logf(-logf(u)) (0 expected for both)")
    if bad or bad_noise:
        print("FAIL: the kernel's arithmetic differs from the library's",
              file=sys.stderr)
        return 1
    for name, (_, log) in variants.items():
        print(f"{name}:")
        print_ptxas(log)
    try:
        sass = sass_of(_library_path(PACKAGE))
        if sass_out is not None:
            sass_out.mkdir(parents=True, exist_ok=True)
            (sass_out / "package.sass").write_text(sass)
        print("SASS package: " + format_counts(count_sass(sass)))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        print(f"SASS package: not counted ({e})")
    fns = {"package": categorical, **{k: v[0] for k, v in variants.items()}}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(28)
    for draw, std, temps in CATEGORICAL_DRAWS:
        for lanes, n, offset, mixed in categorical_shapes():
            args = categorical_case(dev, gen, lanes, n, offset=offset,
                                    mixed=mixed, std=std, temps=temps)
            label = f"{lanes} x {n} {draw}"
            for name, fn in fns.items():
                categorical_agrees(f"{label} {name}", fn(*args, offset=offset),
                                   args, offset)
            rounds = [in_turns({name: (lambda fn=fn: fn(*args,
                                                         offset=offset))
                                for name, fn in fns.items()})
                      for _ in range(TURNS)]
            bound, by = categorical_bound_ms(args[0], args[2])
            parts = []
            for name in fns:
                ts = [r[name] for r in rounds]
                parts.append(f"{name} {sum(ts) / len(ts):.5f} "
                             f"[{min(ts):.5f}-{max(ts):.5f}]")
            print(f"{label}: " + ", ".join(parts)
                  + f" ms; bound {bound:.5f} ms ({by})")
            del args
    return 0


if __name__ == "__main__":
    sys.exit(main())
