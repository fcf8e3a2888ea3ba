"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, for ``sm_90a``, into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries land in ``build/repro_torch_kernels/``
at the repository root, named by a digest of the source and the flags, and
are built at first use.  ``build_all`` starts one ``nvcc`` per source, all
at once, for callers that want every kernel ready up front.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``CudaKernel.__call__`` raises if that is not 0.
Nothing here is imported or compiled at module import time beyond plain
path arithmetic, so the CPU tests can import every module.

``launches_withheld`` takes back the launches counted while a CUDA graph
is captured (a capture launches nothing), so that whoever replays the
graph can add them at each replay.

``shape_pass`` is the dry-run's switch: inside it the kernel ops take
their plain versions on meta tensors, for shapes (``plain_here``);
outside it a meta tensor is refused as any device without a kernel is.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "CudaKernel", "build_all", "build",
           "launches_withheld", "shape_pass", "plain_here"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_lock = threading.Lock()
# every kernel entry point, in the order the kernel modules made them
_KERNELS: list["CudaKernel"] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit on PATH")


def _library_path(source: Path) -> Path:
    h = hashlib.sha256()
    h.update(source.read_bytes())
    for dep in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, tuple[float, str]]:
    """Compile ``csrc/<name>.cu`` for each name not yet built, one ``nvcc``
    process per source, all started together.  Returns, per name, the
    seconds the build took and the compiler's output (ptxas register and
    shared-memory report), or (0.0, "") where the library already
    existed.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, results = {}, {}
    with _lock:
        for name in names:
            src = CSRC_DIR / f"{name}.cu"
            out = _library_path(src)
            if out.exists():
                results[name] = (0.0, "")
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(tmp),
                   str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        failures = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            results[name] = (time.perf_counter() - t0, log)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu "
                                f"(rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)     # atomic: concurrent builders agree
        if failures:
            raise RuntimeError("\n".join(failures))
    return results


def build_all() -> dict[str, tuple[float, str]]:
    """Build every kernel source under ``csrc/`` (in parallel)."""
    return build(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))


class CudaKernel:
    """One C entry point of one kernel library, loaded at first call.

    ``launches`` counts the kernel's launches: the op wrapper adds one
    where it launches the kernel, and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None           # keeps the library loaded
        _KERNELS.append(self)

    def _load(self):
        build([self.source])
        self._lib = ctypes.CDLL(str(_library_path(
            CSRC_DIR / f"{self.source}.cu")))
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = self._lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn = fn

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._load()
        code = self._fn(*args)
        if code != 0:
            msg = self._lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: launch failed with CUDA "
                               f"error {code} ({msg})")


@contextlib.contextmanager
def launches_withheld():
    """Count nothing in the block: on exit every kernel's ``launches`` is
    back to its value before the block, and the yielded dict maps each
    kernel whose wrappers counted in the block to how many launches they
    counted.  For a CUDA-graph capture, which launches nothing: each
    replay of the graph then adds the dict's counts."""
    before = {k: k.launches for k in _KERNELS}
    counted: dict[CudaKernel, int] = {}
    try:
        yield counted
    finally:
        for k in _KERNELS:
            n0 = before.get(k, 0)
            if k.launches != n0:
                counted[k] = k.launches - n0
            k.launches = n0


_shape_pass = threading.local()


@contextlib.contextmanager
def shape_pass():
    """Inside, the kernel ops run their plain versions on meta tensors
    (the dry-run's shape pass, ``launch.dryrun``)."""
    prev = getattr(_shape_pass, "on", False)
    _shape_pass.on = True
    try:
        yield
    finally:
        _shape_pass.on = prev


def plain_here(device) -> bool:
    """Whether a kernel op on ``device`` runs its plain version: on the
    CPU, and on meta inside ``shape_pass``."""
    return device.type == "cpu" or (device.type == "meta" and getattr(
        _shape_pass, "on", False))
