"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one H100; exits non-zero on any failure
    python3 chip_smoke.py --trace    # phases 1-2, then a graphed and an
                                     # eager fused drive of each served
                                     # model under torch.profiler: device
                                     # busy share and the largest
                                     # device-time entries
    python3 chip_smoke.py --kernels  # phases 1-3 and 6 only: every kernel
                                     # check and time, no drive and no
                                     # result line

Phases:
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
  3. hold the paged-decode and flash-prefill kernels against their plain
     PyTorch versions in bf16 (``attn_check``: BF16_TOL, its absolute part
     capped at a tenth of the output's RMS) at the serving path's shapes (llama3.2-1b's
     GQA decode and 512-token prefill chunks; zamba2-1.2b's MHA decode and
     whole-prompt prefill), and time the kernel at each and the plain
     version and the library yardstick (SDPA) at llama's; hold the
     dense-cache decode kernel against its plain version at
     seamless-m4t-medium's decode shape, llama3.2-1b's long-context ring
     (some rows wrapped) and an MQA shape (48 heads of 128 over one kv
     head; the tensor-core instance, one block a kv head), and time it
     with SDPA at each; hold the flash op at seamless's three non-causal
     shapes (encoder self-attention over 4096 frames, a prompt's and one
     decode step's cross-attention over them: the last through the key
     split, the split-KV decode template with key positions) and time
     each, SDPA and the byte bound at the decode step's and the
     encoder's;
     each new shape with a flat draw (a wide softmax) and a peaked one
     (q scaled by 3: O(1) outputs that a wrong tile or rescale moves);
     hold the SSD scan kernel against its two plain versions (chunked and
     sequential) at the mamba2-2.7b and zamba2-1.2b prefill shapes, with
     short- and long-memory decays, check that end padding leaves its
     result bit-unchanged, and time it at both shapes beside the kernel it
     replaced (``tools/ssd_variants/scalar.cu``, built beside the
     package), its plain version and its byte and operation bounds; hold
     the partial (out, lse) paged
     kernel (fixed 64-row sub-splits) against its plain version stripe by
     stripe at qwen2-1.5b's tp = 4 shape (H12/KV2, dh 128) and
     llama3.2-1b's (H32/KV8, dh 64),
     2048-token tables split in 4 with rows short enough that later
     stripes are fully masked (out 0, lse <= -1e29, no NaN), the stripes
     merged by combine_lse_partials against the unsplit paged kernel and
     the plain version, and time it at every stripe (device time and the
     eager op's, host included) and at qwen2's first beside its byte
     bound, its plain version and the library call that returns the same
     (out, lse); time SDPA at seamless's decode-step cross-attention (B 8,
     Sq 1); then, after every earlier draw, hold the paged decode at
     nemotron-4-340b's (H96/KV8, dh 192) and granite-34b's (H48/KV1, dh
     128) serving shapes, the dense decode at H96/KV8, dh 192 (a ring),
     the flash kernel at nemotron's second 512-token chunk and the partial
     kernel at one granite stripe and one dh-192 stripe, flat and peaked,
     each timed beside its library call and bound (``--kernels`` over an
     older package without head dim 192 skips these).  Kernels and library
     calls are timed on the device (``device_ms``: calls captured in a
     CUDA graph and replayed), plain versions eagerly (``cuda_ms``);
  4. serve at full width, from random weights of a seed, llama3.2-1b,
     mamba2-2.7b (SSM) and zamba2-1.2b (hybrid): SageSched with the
     CUDA Gittins backend, 8 slots x 2048 tokens, 16 greedy requests in
     two waves so that the scheduler preempts and swaps; each once
     fused, once orchestrated, both decode steps as CUDA graphs (every
     drive of phases 4 and 4b prints its fused keys against
     ``max_fused_compiles()``, fails above it, and prints the graphs
     captured and a steady decode call's host ms).  Every request must
     finish, the scheduler must preempt and swap, the streams must agree
     under the tolerance contract, and every kernel of the model's path
     must have launched; llama3.2-1b and mamba2-2.7b are served fused
     once more without graphs (graphs=False), and llama3.2-1b at
     temperature 0.8 with and without graphs, each eager drive held
     token-identical, launch for launch, to its graphed twin (these
     drives' launches are not summed into phase 7's);
     then nemotron-4-340b and granite-34b at full width cut to 2 layers
     (head dim 192 and three head groups; MQA and six head groups), fused
     only, the same mix: every request must finish, the scheduler must
     preempt and swap, and the paged decode and flash kernels must launch
     exactly as often as the path calls them;
  4b. serve qwen2-1.5b at full width tensor-parallel, every shard on the
     one card (make_local_mesh(devices=["cuda:0"] * tp)), the same mix
     (fused): (a) without a mesh; (b) parallel="exact", tp 2, held
     token-identical to (a); (c) parallel="efficient", tp 2 (heads,
     MLP and vocab sharded), fused and orchestrated; (d)
     parallel="efficient", tp 4 (kv heads 2 do not divide: the LSE
     split, one stripe per shard), fused and orchestrated; the fused and
     orchestrated streams of (c) held token-identical, and (c) in both
     step modes run again without graphs and held token-identical,
     launch for launch, to the graphed drives; (d)'s printed with
     a check of what parts them (the split's stripes follow the table's
     width; each stripe's partial kernel does not).  Each drive must finish every request, preempt and
     swap, report its plan's branch and launch each kernel of its path
     exactly as often as the path calls it; (c) and (d) hold one decode
     step of the plan to the same step without a mesh on the same pool
     and inputs (logits within TP_STEP_ULPS bf16 steps, argmax identical
     but where the unsharded maximum is within 2 steps), and print their
     streams' match rate against (a);
  5. generate at full width through Model.prefill -> Model.decode_step
     over the dense cache, from random weights of a seed:
     seamless-m4t-medium (all 12 + 12 layers; 8 x 4096 frames, 128-token
     prompts, a dense cache of 512, 256 greedy steps), llama3.2-1b (all
     16 layers; 8 x 512-token prompts, a cache of 1024, 128 steps),
     mamba2-2.7b and zamba2-1.2b (8 x 512-token prompts, a cache of 1024,
     64 steps; all layers, and cut to 2 layers), nemotron-4-340b cut to 2
     layers (8 x 512-token prompts, a cache of 1024, 64 steps, on phase
     4's weights).  Every logit must be
     finite, the logits and greedy streams must agree under the
     tolerance contract with a teacher-forced Model.forward over prompt +
     generated tokens (the decode step's cross-attention through the key
     split; see
     ``repro_torch.testing.generate.teacher_forced_check``, at each
     drive's bar in GENERATE_DRIVES; printed but not held for the
     recurrent families at full depth), and the dense-decode, flash and
     SSD kernels must have launched exactly as often as the path calls
     them;
  6. hold the Gittins kernel (and the kernel it replaced,
     ``tools/gittins_variants/warp_row.cu``, built beside the package)
     against its plain version at the largest refresh shape the serve
     drives gave it (padded to the pow2 ladder), at GITTINS_SHAPES and at
     (1000, 256) and (100, 12); hold a row alone bit-identical to the same
     row in its batch, and the staged refresh (``CudaPriorityBackend``)
     bit-identical to the kernel on the same padded inputs; time the
     kernel and the replaced one on the device in turns at each shape
     (the largest also cycling over input copies beyond the L2) beside
     the byte bound; time the op, numpy in to numpy out, on the host
     clock at (8, 8) and (1024, 32), staged refresh against the parent's
     op path (``ParentOpBackend``), count the staged refresh's copies
     under torch.profiler, and time ``Scheduler.refresh()`` over a
     1024-deep backlog under the numpy, staged and parent backends;
  7. print one JSON line of per-kernel results (launches summed over
     every serve and generate drive; the flash row counts both of the
     flash op's entry points and names them), then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CudaPriorityBackend, Scheduler,  # noqa: E402
                              make_policy)
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
    decode_attention_op, decode_attention_paged_lse_op,
    decode_attention_paged_op)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_dense_reference, decode_attention_paged_lse_reference,
    decode_attention_paged_reference)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_PREFILL_KERNEL, HEAD_DIMS, flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference)
from repro_torch.kernels.bucketing import pow2_bucket  # noqa: E402
from repro_torch.kernels.gittins.ops import (  # noqa: E402
    GITTINS_KERNEL, gittins_attained, gittins_attained_op, padded_rows)
from repro_torch.kernels.gittins.ref import (  # noqa: E402
    gittins_attained_reference)
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    SSD_SCAN_KERNEL, ssd_scan)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_reference, ssd_sequential_reference)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    decode_attention_paged)
from repro_torch.models.encdec import encode  # noqa: E402
from repro_torch.serving import (RequestState, ServeRequest,  # noqa: E402
                                 ServingEngine)
from repro_torch.testing import assert_tokens_close  # noqa: E402
from repro_torch.testing.generate import (  # noqa: E402
    bf16_ulp, greedy_generate, teacher_forced_check)

# the flash op's key split for a few bidirectional queries (None over an
# older package, timed with --kernels)
FLASH_SPLIT_KERNEL = getattr(flash_kernel, "FLASH_SPLIT_KERNEL", None)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
BF16_TOL = 2e-2          # bf16 kernel vs plain version (tests/test_kernels.py)
# attention kernels: BF16_TOL, but the absolute part never above this
# fraction of the compared output's RMS (a wide softmax over thousands of
# keys gives outputs of about sqrt(e / n), the size of BF16_TOL itself)
ATTN_RMS_FRACTION = 0.1
# q scale of the peaked draws: scores of std 3, so a few keys carry the
# softmax and the outputs are O(1)
PEAKED_Q = 3.0
GITTINS_RTOL = 1e-4      # f32 kernel vs plain version
# the partial kernel's lse (f32, max and sum of another order) vs plain
LSE_TOL = 1e-4
# SSD final state (f32, sums of up to a chunk's terms in another order)
SSD_STATE_TOL = 1e-3
SERVED = ("llama3.2-1b", "mamba2-2.7b", "zamba2-1.2b")
# phase 4 (fused only, exact launch counts) and, for nemotron, phase 5:
# full width cut to 2 layers -- nemotron-4-340b's head dim 192 with 12
# query heads a kv head (33 GB of bf16 weights, shared by both drives) and
# granite-34b's MQA (48 query heads of 128 over one kv head)
WIDE = (("nemotron-4-340b", dict(n_layers=2)),
        ("granite-34b", dict(n_layers=2)))
# phase 4: the served models whose fused drive is run again eagerly
# (graphs=False) and held token-identical, launch for launch, to the
# graphed one; and those with a sampled pair (temperature SAMPLED_T,
# graphed and eager) held the same way
EAGER_HELD = ("llama3.2-1b", "mamba2-2.7b")
SAMPLED_HELD = ("llama3.2-1b",)
SAMPLED_T = 0.8
# phase 4b: (label, tp, parallel, step modes); tp None = no mesh
TP_ARCH = "qwen2-1.5b"
TP_DRIVES = (("a", None, "exact", ("fused",)),
             ("b", 2, "exact", ("fused",)),
             ("c", 2, "efficient", ("fused", "orchestrated")),
             ("d", 4, "efficient", ("fused", "orchestrated")))
# phase 4b: the drives whose fused and orchestrated streams must be
# token-identical, as phase 4's are without a mesh.  (d)'s are printed:
# its LSE split cuts the logical pages into tp stripes of a width that
# follows the table's (models/attention.py _decode_attention_paged_split:
# a pow2 of the pages in use in the fused step, the whole table in the
# orchestrated one), so one row's keys are merged across other stripes
# in the two steps (ROADMAP Queue C; lse_stripe_check shows it)
TP_SAME_STREAMS = ("c",)
# phase 4b: the drives run again eagerly (graphs=False) in each of their
# step modes, held token-identical, launch for launch, to the graphed run
TP_EAGER_HELD = ("c",)
# phase 4b: one decode step of an efficient plan vs the same step without
# a mesh, max |logit| difference in bf16 steps at the largest |logit|: its
# drift on an H100 (2.00 for tp 2, 1.81 for tp 4; the step is
# deterministic), rounded up to a whole step, plus one so that the bar
# does not sit on the measured value
TP_STEP_ULPS = 3
# phase 5: (arch, depth cut, drive) through Model.prefill ->
# Model.decode_step.  ``logit_ulps`` is the drive's teacher-forced logit
# bar in bf16 steps (``teacher_forced_check``): its drift on an H100,
# rounded up to a whole step (seamless 2.06, llama 2.25, the cut mamba2
# 3.25, the cut zamba2 1.75; the drives are deterministic).  None prints
# the comparison without holding it: at random weights bf16 rounding
# differences grow with Mamba2 depth (3.25 steps at 2 layers, 226.5 at
# 64 on an H100), so at full depth the decode and a forward agree no
# better than unrelated logits; the recurrent families are held cut to
# 2 layers (zamba2 with its shared attention after each, two group
# layers)
GENERATE_DRIVES = (
    ("seamless-m4t-medium", {}, dict(b=8, prompt=128, max_len=512,
                                     steps=256, n_frames=4096,
                                     logit_ulps=3)),
    ("llama3.2-1b", {}, dict(b=8, prompt=512, max_len=1024, steps=128,
                             logit_ulps=3)),
    ("mamba2-2.7b", {}, dict(b=8, prompt=512, max_len=1024, steps=64,
                             logit_ulps=None)),
    ("zamba2-1.2b", {}, dict(b=8, prompt=512, max_len=1024, steps=64,
                             logit_ulps=None)),
    ("mamba2-2.7b", dict(n_layers=2), dict(b=8, prompt=512, max_len=1024,
                                           steps=64, logit_ulps=4)),
    ("zamba2-1.2b", dict(n_layers=2, hybrid_attn_every=1),
     dict(b=8, prompt=512, max_len=1024, steps=64, logit_ulps=2)),
    # teacher_forced_check's default bar: no drift measured before
    ("nemotron-4-340b", dict(n_layers=2), dict(b=8, prompt=512,
                                               max_len=1024, steps=64,
                                               logit_ulps=3)))


class BuildThread(threading.Thread):
    """A build beside the package's: ``join()`` re-raises what the build
    raised (a failed nvcc's SystemExit too), so it is not lost with the
    thread."""

    error: BaseException | None = None

    def run(self) -> None:
        try:
            super().run()
        except BaseException as e:  # noqa: BLE001 - re-raised in join()
            self.error = e

    def join(self, timeout=None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


# the SSD kernel this one replaced (tools/ssd_variants/scalar.cu), built
# beside the package and timed in phase 3; empty where the checkout has
# no tools/ssd_variants.py
PARENT_SSD: dict = {}


def build_parent_ssd() -> None:
    try:
        from tools import ssd_variants
    except ImportError:
        return
    scan, log = ssd_variants.build(["scalar"])["scalar"]
    PARENT_SSD.update(scan=scan, log=log)


# the Gittins kernel this one replaced (tools/gittins_variants/warp_row.cu),
# built beside the package and timed in phase 6; empty where the checkout
# has no tools/gittins_variants.py
PARENT_GITTINS: dict = {}
# phase 6: the refresh shapes timed beside the main path's: the paper's
# 1000-deep queue with the predictor's 20 buckets, (4096, 64), and a
# cluster-wide live set at max_k (33.7 MB: also timed cycling over
# GITTINS_COLD copies of its inputs, beyond the 50 MB L2)
GITTINS_SHAPES = ((1024, 32), (4096, 64), (16384, 256))
GITTINS_COLD = 4


def build_parent_gittins() -> None:
    try:
        from tools import gittins_variants
    except ImportError:
        return
    run, log = gittins_variants.build(["warp_row"])["warp_row"]
    PARENT_GITTINS.update(run=run, log=log)


def print_ptxas(log: str) -> None:
    """Each kernel's name (and template arguments), registers and spills
    from an nvcc build's ptxas -v report."""
    for line in log.splitlines():
        entry = "Compiling entry" in line and re.search(
            r"\d+([a-z_]+kernel)(I(\w*?)EEv)?", line)
        if entry:   # a kernel's template arguments, e.g. <192, 1, 4>
            args = re.findall(r"L[ib](\d+)E", (entry.group(3) or "") + "E")
            name = entry.group(1)
            if args:
                name += f"<{', '.join(args)}>"
            print(f"  ptxas: {name}")
        elif "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one eager call of ``fn``, the host's dispatch included
    where it outlasts the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between two events, so that the host's share
    of a call (the Python wrapper, ctypes, each launch's dispatch) is not
    in it.  Kernels and library calls are timed this way; ``cuda_ms``
    times eager calls, host included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float,
          rel: bool = False, atol: float | None = None) -> float:
    """Elementwise |got - want| <= tol * |want| + atol (atol = tol unless
    given; 0 with ``rel``)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    atol = 0.0 if rel else (tol if atol is None else atol)
    limit = tol * want.abs() + atol
    bad = int((err > limit).sum())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=rel {tol:g} + abs {atol:.3e} "
          f"{'OK' if bad == 0 else f'{bad} elements out of tolerance'}")
    if bad:
        raise SystemExit(f"FAIL {name}: kernel disagrees with plain version")
    return max_abs


def attn_check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """An attention kernel against its plain version: BF16_TOL, with the
    absolute part capped at ATTN_RMS_FRACTION of want's RMS."""
    rms = float(want.float().pow(2).mean().sqrt())
    return check(f"{name} [output RMS {rms:.3e}]", got, want, BF16_TOL,
                 atol=min(BF16_TOL, ATTN_RMS_FRACTION * rms))


# --------------------------------------------------------------- phase 3

def decode_case(cfg, dev, gen):
    """Paged decode at the serving shapes: 8 lanes, the full 2048-token
    table (128 pages of 16), the pool of 8 slots x 2048 tokens."""
    b, h, kvh, dh, page = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    p_max, n_pages = 2048 // page, 8 * 2048 // page + 1
    q = torch.randn(b, h, dh, generator=gen, device=dev).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * p_max].reshape(b, p_max).to(torch.int32).contiguous()
    cache_len = torch.randint(32, 1281, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
    return q, kp, vp, tables, cache_len


def paged_sdpa_ms(q, kp, vp, tables, cl) -> float:
    """SDPA over the gathered dense cache, the paged decode's yardstick."""
    b, h, dh = q.shape
    page, kvh = kp.shape[1], kp.shape[2]
    s = tables.shape[1] * page
    tok = ((tables.long() * page)[:, :, None]
           + torch.arange(page, device=q.device)).reshape(b, s)
    kd = kp.reshape(-1, kvh, dh)[tok].transpose(1, 2).contiguous()
    vd = vp.reshape(-1, kvh, dh)[tok].transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < cl[:, None].long()
            )[:, None, None, :]
    qd = q[:, :, None, :]
    return device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))


def paged_bytes_flops(q, kvh, tables, cl):
    """Bytes the paged decode must move (q and the output, each row's
    cache_len K and V rows, its table and length, once) and its flops."""
    b, h, dh = q.shape
    valid = float(cl.long().sum())
    n_bytes = (2 * q.numel() * 2 + 2 * valid * kvh * dh * 2
               + tables.numel() * 4 + cl.numel() * 4)
    return n_bytes, 4.0 * valid * h * dh


def phase_decode(cfgs, dev, gen) -> dict:
    """Checks at the shapes of every served model with attention (llama:
    32 heads over 8 kv heads, dh 64; zamba2: 32 over 32, dh 64); times at
    the first's."""
    err = 0.0
    for cfg in reversed(cfgs):      # the first model's inputs stay for timing
        q, kp, vp, tables, cl = decode_case(cfg, dev, gen)
        got = decode_attention_paged_op(q, kp, vp, tables, cl)
        want = decode_attention_paged_reference(q, kp, vp, tables, cl)
        torch.cuda.synchronize()
        shape = f"H{cfg.n_heads}/KV{cfg.n_kv_heads}, dh {cfg.head_dim}"
        err = max(err, attn_check(f"paged decode {cfg.name} (bf16, {shape}, "
                                  f"8 lanes, cache_len 32..1280)", got, want))
        # windowed variant: same kernel, logical sliding window of 256
        got_w = decode_attention_paged_op(q, kp, vp, tables, cl, window=256)
        want_w = decode_attention_paged_reference(q, kp, vp, tables, cl,
                                                  window=256)
        err = max(err, attn_check(f"paged decode {cfg.name}, window 256",
                                  got_w, want_w))
        if cfg is not cfgs[0]:
            ms = device_ms(lambda: decode_attention_paged_op(q, kp, vp, tables,
                                                           cl))
            print(f"  paged decode {cfg.name}: kernel {ms:.4f} ms")
    ms = device_ms(lambda: decode_attention_paged_op(q, kp, vp, tables, cl))
    plain_ms = cuda_ms(lambda: decode_attention_paged_reference(
        q, kp, vp, tables, cl), iters=5)
    lib_ms = paged_sdpa_ms(q, kp, vp, tables, cl)
    bnd, by = bound_ms(*paged_bytes_flops(q, kp.shape[2], tables, cl),
                       BF16_FLOPS)
    print(f"  paged decode {cfg.name}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA on gathered cache {lib_ms:.4f} ms, bound "
          f"{bnd:.5f} ms ({by})")
    return {"name": "decode_attention_paged", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:232",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def flash_case(cfg, dev, gen, s_past: int, start: int, c: int):
    """A chunk of c queries at positions start.. over s_past gathered
    prefix rows (rows >= start masked at -1e9) plus the chunk itself."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sk = s_past + c
    q = torch.randn(1, c, h, dh, generator=gen, device=dev).bfloat16()
    k = torch.randn(1, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, sk, kvh, dh, generator=gen, device=dev).bfloat16()
    pos = (start + torch.arange(c, device=dev)).to(torch.int32)
    past = torch.arange(s_past, device=dev)
    kv_pos = torch.cat([torch.where(past < start, past,
                                    torch.full_like(past, -10 ** 9)),
                        pos.long()]).to(torch.int32)
    return q, k, v, pos, kv_pos


def phase_flash(cfgs, dev, gen) -> dict:
    """Checks at the prefill shapes of every served model with attention;
    times at the first's (llama's second 512-token chunk)."""
    err = 0.0
    # (cfg, S_past, start, C): llama's chunked prefill -- a first chunk
    # (no past), the second 512-token chunk of a 1024-token prompt, and a
    # chunk whose gathered prefix carries masked rows past its start;
    # zamba2's atomic prefill -- one whole pow2-bucketed prompt
    cases = [(cfgs[0], 0, 0, 512), (cfgs[0], 512, 512, 512),
             (cfgs[0], 512, 448, 256)] + [(c, 0, 0, 1024) for c in cfgs[1:]]
    for cfg, s_past, start, c in cases:
        q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, s_past, start, c)
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        err = max(err, attn_check(f"flash prefill {cfg.name} (bf16, H"
                                  f"{cfg.n_heads}/KV{cfg.n_kv_heads}, C={c}, "
                                  f"S_past={s_past}, start={start})", got,
                                  want))
        ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
        print(f"  flash prefill {cfg.name} (C={c}, S_past={s_past}, start="
              f"{start}): kernel {ms:.4f} ms")
    cfg = cfgs[0]
    q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, 512, 512, 512)
    ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v, pos, kv_pos),
                       iters=5)

    mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    h, dh = q.shape[2], q.shape[3]
    pairs = float(mask.sum())
    n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + (pos.numel() + kv_pos.numel()) * 4
    flops = 4.0 * pairs * h * dh
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  flash prefill {cfg.name} (C=512, S_past=512): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
          f"{bnd:.5f} ms ({by})")
    return {"name": "flash_attention_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def dense_decode_case(dev, gen, b, h, kvh, dh, s_max, hi, q_scale=1.0):
    """q and dense (B, S_max, KV, dh) caches; cache_len in [1, hi], with
    row 0 at hi and row 1 at exactly S_max, so that a ring (hi > S_max)
    has a wrapped row and one at the wrap point."""
    q = (torch.randn(b, h, dh, generator=gen, device=dev)
         * q_scale).bfloat16()
    k = torch.randn(b, s_max, kvh, dh, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s_max, kvh, dh, generator=gen, device=dev).bfloat16()
    cl = torch.randint(1, hi + 1, (b,), generator=gen, device=dev,
                       dtype=torch.int32)
    cl[0], cl[1] = hi, s_max
    return q, k, v, cl


def dense_decode_bytes_flops(q, k, cl):
    """Bytes the call must move (q and the output once, each row's
    min(cache_len, S_max) K and V rows once, cache_len) and its flops."""
    b, h, dh = q.shape
    s_max, kvh = k.shape[1], k.shape[2]
    rows = float(torch.clamp(cl.long(), max=s_max).sum())
    n_bytes = 2 * q.numel() * 2 + rows * kvh * dh * 2 * 2 + cl.numel() * 4
    return n_bytes, 4.0 * rows * h * dh


def dense_decode_sdpa_ms(q, k, v, cl) -> float:
    """The yardstick of the dense decode: one SDPA call over the same
    caches, the valid slots (the first min(cache_len, S_max)) as a
    boolean mask, the kv heads shared through enable_gqa."""
    s_max = k.shape[1]
    kd, vd = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < cl[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    return device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))


def phase_dense_decode(dev, gen) -> dict:
    """The dense-cache decode kernel at seamless-m4t-medium's decode shape
    (8 rows, H16/KV16, dh 64, 512 slots), llama3.2-1b's long-context ring
    (its window of 8192 slots, cache_len up to 8392 so some rows wrapped)
    and an MQA shape (H48/KV1, dh 128); timed at seamless's."""
    seam = get_config("seamless-m4t-medium")
    llama = get_config("llama3.2-1b", long_context=True)
    cases = [("seamless-m4t-medium", seam.n_heads, seam.n_kv_heads,
              seam.head_dim, 512, 512, 0),
             ("llama3.2-1b long-context ring", llama.n_heads,
              llama.n_kv_heads, llama.head_dim, llama.window,
              llama.window + 200, llama.window),
             ("MQA", 48, 1, 128, 1024, 1024, 0)]
    err, inputs = 0.0, {}
    for name, h, kvh, dh, s_max, hi, window in cases:
        # a flat draw (scores ~ N(0, 1), a wide softmax) and a peaked one
        # (O(1) outputs: a wrong tile or rescale moves them by O(1))
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, k, v, cl = dense_decode_case(dev, gen, 8, h, kvh, dh, s_max,
                                            hi, q_scale)
            got = decode_attention_op(q, k, v, cl, window=window)
            want = decode_attention_dense_reference(q, k, v, cl,
                                                    window=window)
            torch.cuda.synchronize()
            ring = (f", window {window}, {int((cl > s_max).sum())} rows "
                    f"wrapped" if window else "")
            err = max(err, attn_check(
                f"dense decode {name} {draw} (bf16, H{h}/KV{kvh}, dh {dh}, "
                f"S_max {s_max}, cache_len 1..{hi}{ring})", got, want))
            if draw == "flat":
                inputs[name] = (q, k, v, cl, window)
    for name in list(inputs)[1:]:
        q, k, v, cl, window = inputs[name]
        ms = device_ms(lambda: decode_attention_op(q, k, v, cl, window=window))
        lib_ms = dense_decode_sdpa_ms(q, k, v, cl)
        bnd, by = bound_ms(*dense_decode_bytes_flops(q, k, cl), BF16_FLOPS)
        print(f"  dense decode {name}: kernel {ms:.4f} ms, SDPA with a "
              f"boolean mask {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    q, k, v, cl, _ = inputs["seamless-m4t-medium"]
    ms = device_ms(lambda: decode_attention_op(q, k, v, cl))
    plain_ms = cuda_ms(lambda: decode_attention_dense_reference(q, k, v, cl),
                       iters=5)
    lib_ms = dense_decode_sdpa_ms(q, k, v, cl)
    n_bytes, flops = dense_decode_bytes_flops(q, k, cl)
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  dense decode seamless-m4t-medium: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA with a boolean mask {lib_ms:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}; {n_bytes / 1e6:.2f} MB)")
    return {"name": "decode_attention_dense", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:79",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def phase_flash_noncausal(dev, gen) -> float:
    """The flash kernel at seamless-m4t-medium's bidirectional shapes: the
    encoder's self-attention over 4096 frames, a 128-token prompt's
    cross-attention over them, and one decode step's (Sq = 1); times the
    encoder's beside SDPA.  Returns the largest max abs error."""
    cfg = get_config("seamless-m4t-medium")
    h, kvh, dh, s_enc = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4096
    err = 0.0
    for what, b, sq in (("encoder self-attention", 1, s_enc),
                        ("prompt cross-attention", 8, 128),
                        ("decode cross-attention", 8, 1)):
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q = (torch.randn(b, sq, h, dh, generator=gen, device=dev)
                 * q_scale).bfloat16()
            k = torch.randn(b, s_enc, kvh, dh, generator=gen,
                            device=dev).bfloat16()
            v = torch.randn(b, s_enc, kvh, dh, generator=gen,
                            device=dev).bfloat16()
            pos = torch.arange(sq, device=dev, dtype=torch.int32)
            kv_pos = torch.arange(s_enc, device=dev, dtype=torch.int32)
            got = flash_attention(q, k, v, pos, kv_pos, causal=False)
            want = attention_reference(q, k, v, pos, kv_pos, causal=False)
            torch.cuda.synchronize()
            err = max(err, attn_check(
                f"flash {cfg.name} {what} {draw} (bf16, non-causal, B {b}, "
                f"Sq {sq}, Sk {s_enc}, H{h}/KV{kvh})", got, want))
            if draw == "flat":
                ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos,
                                                     causal=False), iters=5)
                lib = ""
                if sq == 1:
                    # the yardstick of one decode step's cross-attention
                    # (the key split), and its bound: K and V read once
                    qt, kt, vt = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v))
                    bnd, by = bound_ms(
                        (2 * q.numel() + k.numel() + v.numel()) * 2,
                        4.0 * b * s_enc * h * dh, BF16_FLOPS)
                    lib = (f", SDPA "
                           f"{device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=5):.4f} ms, "
                           f"bound {bnd:.5f} ms ({by})")
                    del qt, kt, vt
                print(f"  flash {cfg.name} {what} (B {b}, Sq {sq}): kernel "
                      f"{ms:.4f} ms{lib}")
            if sq == s_enc and draw == "flat":
                enc = (q, k, v, pos, kv_pos)

            del want
            torch.cuda.empty_cache()
    q, k, v, pos, kv_pos = enc
    ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos, causal=False),
                 iters=5)
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v, pos, kv_pos,
                                                   causal=False), iters=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4.0 * s_enc * s_enc * h * dh
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  flash {cfg.name} encoder self-attention (B 1, S {s_enc}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
          f"ms, bound {bnd:.5f} ms ({by})")
    return err


def ssd_case(cfg, dev, gen, s: int, init: bool = False,
             a_range=(0.5, 0.999)):
    """Inputs of one prefill scan of ``cfg`` (B = 1) in the model path's
    types: x, B, C bf16; dt, a and the state f32.  Decays near 1 (long
    memory, as trained Mamba2 dt gives) carry the initial state and the
    chunk-to-chunk carry into the final state and most rows of y."""
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = torch.randn(1, s, h, p, generator=gen, device=dev).bfloat16()
    dt = torch.rand(1, s, h, generator=gen, device=dev) * 0.99 + 0.01
    lo, hi = a_range
    a = torch.rand(1, s, h, generator=gen, device=dev) * (hi - lo) + lo
    bm = (torch.randn(1, s, n, generator=gen, device=dev) * 0.5).bfloat16()
    cm = (torch.randn(1, s, n, generator=gen, device=dev) * 0.5).bfloat16()
    st = torch.randn(1, h, p, n, generator=gen, device=dev) if init else None
    return x, dt, a, bm, cm, st


def phase_ssd(dev, gen) -> dict:
    err = 0.0
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_config(arch)
        chunk = cfg.ssm_chunk
        for s, init, a_range in ((1024, False, (0.5, 0.999)),
                                 (777, False, (0.5, 0.999)),
                                 (777, True, (0.5, 0.999)),
                                 (1024, True, (0.99, 1.0))):
            x, dt, a, bm, cm, st = ssd_case(cfg, dev, gen, s, init, a_range)
            y, fin = ssd_scan(x, dt, a, bm, cm, st, chunk=chunk)
            torch.cuda.synchronize()
            for name, (ry, rst) in (
                    ("chunked", ssd_chunked_reference(x, dt, a, bm, cm, st,
                                                      chunk=chunk)),
                    ("sequential", ssd_sequential_reference(x, dt, a, bm,
                                                            cm, st))):
                what = (f"ssd scan {arch} (S={s}, a in [{a_range[0]}, "
                        f"{a_range[1]}]{', init state' if init else ''}) vs "
                        f"{name}")
                err = max(err, check(f"{what}: y (bf16)", y, ry, BF16_TOL))
                check(f"{what}: final state (f32)", fin, rst, SSD_STATE_TOL)
        # end padding as the model makes it (dt = 0, a = 1, real x, B, C)
        # leaves the valid rows and the state bit-unchanged
        x, dt, a, bm, cm, _ = ssd_case(cfg, dev, gen, 1024)
        dt[:, 777:], a[:, 777:] = 0.0, 1.0
        y0, s0 = ssd_scan(x[:, :777], dt[:, :777], a[:, :777], bm[:, :777],
                          cm[:, :777], chunk=chunk)
        y1, s1 = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        same = torch.equal(y0, y1[:, :777]) and torch.equal(s0, s1)
        print(f"  ssd scan {arch}: S=777 vs padded to 1024 with dt=0, a=1: "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise SystemExit("FAIL ssd scan: end padding changed the result")
    # times at both prefill shapes: the kernel, the parent's kernel (the
    # scalar one it replaced, tools/ssd_variants/scalar.cu) in the same
    # call, the plain chunked version, and the bound
    parent = PARENT_SSD.get("scan")
    instances = {}
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_config(arch)
        x, dt, a, bm, cm, _ = ssd_case(cfg, dev, gen, 1024)
        ms = device_ms(lambda: ssd_scan(x, dt, a, bm, cm))
        parent_ms = (device_ms(lambda: parent(x, dt, a, bm, cm))
                     if parent else None)
        plain_ms = cuda_ms(lambda: ssd_chunked_reference(x, dt, a, bm, cm),
                           iters=5)
        b, s, h, p = x.shape
        n, q = bm.shape[-1], cfg.ssm_chunk
        n_bytes = (2 * x.numel() * 2 + (dt.numel() + a.numel()) * 4
                   + (bm.numel() + cm.numel()) * 2 + b * h * p * n * 4)
        # causal pairs per chunk; C.B^T once per chunk (one group), then
        # per head the weighted sum over pairs, the state read-out and
        # update (the kernel's extra products for the f32 factors' bf16 parts
        # are not the function's work)
        pairs = (s // q) * q * (q + 1) / 2
        flops = b * (pairs * 2 * n + h * (pairs * 2 * p + 2 * s * 2 * p * n))
        bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
        t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
        print(f"  ssd scan ({arch}, S={s}, H {h}, P {p}, N {n}): kernel "
              f"{ms:.4f} ms, parent's kernel "
              f"{'not built' if parent_ms is None else f'{parent_ms:.4f} ms'}"
              f", plain chunked {plain_ms:.4f} ms, bound {bnd:.5f} ms ({by}; "
              f"bytes {t_bytes:.5f} ms for {n_bytes / 1e6:.1f} MB, "
              f"operations {t_ops:.5f} ms for {flops / 1e9:.2f} GFLOP)")
        instances[f"{arch} S={s}"] = {
            "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by}
    main_shape = instances["mamba2-2.7b S=1024"]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:64",
            "max_abs_err": err, "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "instances": instances}


def phase_flash_dh128(dev, gen) -> float:
    """The flash kernel at qwen2-1.5b's chunked-prefill shapes (H12/KV2,
    dh 128; phase 4b's path): a first 512-token chunk and a chunk whose
    gathered prefix carries masked rows past its start.  Returns the
    largest max abs error."""
    cfg = get_config(TP_ARCH)
    err = 0.0
    for s_past, start, c in ((0, 0, 512), (512, 448, 256)):
        q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, s_past, start, c)
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        err = max(err, attn_check(f"flash prefill {cfg.name} (bf16, H"
                                  f"{cfg.n_heads}/KV{cfg.n_kv_heads}, dh "
                                  f"{cfg.head_dim}, C={c}, S_past={s_past}, "
                                  f"start={start})", got, want))
        ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
        print(f"  flash prefill {cfg.name} (C={c}, S_past={s_past}, start="
              f"{start}): kernel {ms:.4f} ms")
    mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    h, dh = q.shape[2], q.shape[3]
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 \
        + (pos.numel() + kv_pos.numel()) * 4
    bnd, by = bound_ms(n_bytes, 4.0 * float(mask.sum()) * h * dh,
                       BF16_FLOPS)
    print(f"  flash prefill {cfg.name} (C={c}, S_past={s_past}): kernel "
          f"{ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return err


def lse_case(dev, gen, h, kvh, dh, q_scale=1.0):
    """Partial paged decode at the tp = 4 serving shape: 8 lanes, 2048-token
    tables (128 pages of 16) split in 4 stripes of 32 pages, rows of 1 to
    2048 tokens (the short ones leave the later stripes fully masked)."""
    b, page, p_max = 8, 16, 128
    n_pages = b * p_max + 1
    q = (torch.randn(b, h, dh, generator=gen, device=dev)
         * q_scale).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=gen,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * p_max].reshape(b, p_max).to(torch.int32).contiguous()
    cl = torch.tensor([1, 100, 511, 512, 513, 1000, 1600, 2048],
                      dtype=torch.int32, device=dev)
    return q, kp, vp, tables, cl


def stripe(tables, cl, s: int, n: int = 4, page: int = 16):
    """Stripe s of n: its column slice of the tables and its lengths."""
    per = tables.shape[1] // n
    return (tables[:, s * per:(s + 1) * per].contiguous(),
            torch.clamp(cl - s * per * page, min=0).contiguous())


def lse_bytes_flops(q, kvh, bt, cl, page: int = 16):
    """Bytes the call must move (q, the stripe's valid K and V rows -- a
    row's positions up to the stripe's end --, its table and lengths once;
    out and lse written once) and its flops."""
    b, h, dh = q.shape
    valid = float(torch.clamp(cl.long(), max=bt.shape[1] * page).sum())
    n_bytes = (2 * q.numel() * 2 + 2 * valid * kvh * dh * 2 + bt.numel() * 4
               + b * 4 + b * h * 4)
    return n_bytes, 4.0 * valid * h * dh


def phase_lse(dev, gen) -> dict:
    """The partial (out, lse) paged kernel against its plain version, per
    stripe, at qwen2-1.5b's tp = 4 shape and llama3.2-1b's; the merged
    stripes against the unsplit kernel and the plain version; times at
    qwen2's first stripe (every row has positions there)."""
    err = 0.0
    for arch in (TP_ARCH, "llama3.2-1b"):
        cfg = get_config(arch)
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, kp, vp, tables, cl = lse_case(dev, gen, h, kvh, dh, q_scale)
            what = f"paged lse {arch} {draw} (bf16, H{h}/KV{kvh}, dh {dh})"
            for s in range(4):
                bt, cls = stripe(tables, cl, s)
                out, lse = decode_attention_paged_lse_op(q, kp, vp, bt, cls)
                want_o, want_l = decode_attention_paged_lse_reference(
                    q, kp, vp, bt, cls)
                torch.cuda.synchronize()
                live = cls > 0
                if not (torch.isfinite(out).all()
                        and torch.isfinite(lse).all()):
                    raise SystemExit(f"FAIL {what}: non-finite output")
                dead_out, dead_lse = 0.0, -math.inf
                if bool((~live).any()):
                    dead_out = float(out[~live].float().abs().max())
                    dead_lse = max(float(lse[~live].max()),
                                   float(want_l[~live].max()))
                print(f"  {what} stripe {s}: {int((~live).sum())} rows "
                      f"fully masked, their |out| max {dead_out:g}, lse max "
                      f"{dead_lse:.4g}")
                if dead_out != 0.0 or dead_lse > -1e29:
                    raise SystemExit(f"FAIL {what}: a fully masked stripe "
                                     "must give out 0 and lse <= -1e29")
                err = max(err, attn_check(f"{what} stripe {s}: out",
                                          out[live], want_o[live]))
                check(f"{what} stripe {s}: lse (f32)", lse[live],
                      want_l[live], LSE_TOL)
            merged = decode_attention_paged(q[:, None], kp, vp, tables, cl,
                                            n_splits=4)[:, 0]
            whole = decode_attention_paged_op(q, kp, vp, tables, cl)
            plain = decode_attention_paged_reference(q, kp, vp, tables, cl)
            torch.cuda.synchronize()
            err = max(err, attn_check(f"{what}: 4 stripes merged vs the "
                                      "unsplit kernel", merged, whole))
            err = max(err, attn_check(f"{what}: 4 stripes merged vs plain",
                                      merged, plain))
            if draw == "flat":
                for s in range(4):
                    bt, cls = stripe(tables, cl, s)
                    ms = device_ms(lambda: decode_attention_paged_lse_op(
                        q, kp, vp, bt, cls))
                    # eager, the host's share included: the op's Python
                    # and ctypes call outlast its two kernels
                    op_ms = cuda_ms(lambda: decode_attention_paged_lse_op(
                        q, kp, vp, bt, cls), iters=100, warmup=20)
                    print(f"  paged lse {arch} stripe {s} of 4: kernel "
                          f"{ms:.4f} ms, eager op {op_ms:.4f} ms")
            if arch == TP_ARCH and draw == "flat":
                timed = (q, kp, vp) + stripe(tables, cl, 0)
    q, kp, vp, bt, cls = timed
    ms = device_ms(lambda: decode_attention_paged_lse_op(q, kp, vp, bt, cls))
    plain_ms = cuda_ms(lambda: decode_attention_paged_lse_reference(
        q, kp, vp, bt, cls), iters=5)
    lib_name, lib_ms = lse_library_ms(q, kp, vp, bt, cls)
    n_bytes, flops = lse_bytes_flops(q, kp.shape[2], bt, cls)
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  paged lse {TP_ARCH} stripe 0 of 4 (B 8, 32 pages): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}; {n_bytes / 1e6:.2f} MB)")
    return {"name": "decode_attention_paged_lse", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:275",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def lse_library_ms(q, kp, vp, bt, cls) -> tuple[str, float]:
    """The library call that returns the same (out, lse) as the partial
    kernel: memory-efficient SDPA with compute_log_sumexp over the
    gathered stripe (heads expanded: it takes no GQA), a boolean mask as
    an additive bias; SDPA without the lse where this PyTorch refuses
    it.  Returns its name and device time."""
    dev = q.device
    b, h, dh = q.shape
    page, kvh = kp.shape[1], kp.shape[2]
    s_len = bt.shape[1] * page
    tok = ((bt.long() * page)[:, :, None]
           + torch.arange(page, device=dev)).reshape(b, s_len)
    rep = h // kvh
    kd = kp.reshape(-1, kvh, dh)[tok].repeat_interleave(rep, 2) \
        .transpose(1, 2).contiguous()
    vd = vp.reshape(-1, kvh, dh)[tok].repeat_interleave(rep, 2) \
        .transpose(1, 2).contiguous()
    qd = q[:, :, None, :].contiguous()
    masked = torch.arange(s_len, device=dev)[None, :] >= cls[:, None].long()
    bias = torch.zeros(b, h, 1, s_len, dtype=q.dtype, device=dev)
    bias.masked_fill_(masked[:, None, None, :], float("-inf"))
    lib_name = "aten._scaled_dot_product_efficient_attention " \
               "(compute_log_sumexp=True)"
    lib = getattr(torch.ops.aten, "_scaled_dot_product_efficient_attention",
                  None)
    try:
        if lib is None:
            raise RuntimeError("the op is missing from this PyTorch")
        lib(qd, kd, vd, bias, True)
    except RuntimeError as e:
        # the yardstick only (no kernel of the port runs here): say so
        lib_name = (f"SDPA without lse ({lib_name} refused: "
                    f"{str(e).splitlines()[0][:120]})")
        lib = None
    if lib is not None:
        return lib_name, device_ms(lambda: lib(qd, kd, vd, bias, True))
    return lib_name, device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=bias))


def phase_wide_heads(dev, gen, rows: dict, kernels_only: bool) -> None:
    """The attention kernels at the head shapes the earlier checks do not
    reach, each with a flat and a peaked draw (after every earlier draw,
    whose inputs stay as they were): the paged decode at nemotron-4-340b's
    (H96/KV8, dh 192: three head groups a kv head) and granite-34b's
    (H48/KV1, dh 128: six) serving shapes, the dense decode at H96/KV8, dh
    192 (a ring of 1024 slots, some rows wrapped), the flash kernel at
    nemotron's second 512-token chunk over 512 rows, the partial kernel at
    one granite stripe and one dh-192 stripe.  Each new shape is timed
    beside its library yardstick and bound.  Raises the kernels' rows'
    max_abs_err."""
    if not (hasattr(decode_ops, "head_groups") and 192 in HEAD_DIMS):
        # an older package (a parent commit timed with --kernels) has no
        # head dim 192 and no head groups in the paged kernels
        if kernels_only:
            print("  wide heads: skipped, the package under test predates "
                  "head dim 192")
            return
        raise SystemExit("FAIL: the package's kernels take no head dim 192")
    nem, gra = get_config("nemotron-4-340b"), get_config("granite-34b")
    for cfg in (nem, gra):
        shape = f"H{cfg.n_heads}/KV{cfg.n_kv_heads}, dh {cfg.head_dim}"
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, kp, vp, tables, cl = decode_case(cfg, dev, gen)
            q = (q.float() * q_scale).bfloat16()
            for window in (0, 256):
                got = decode_attention_paged_op(q, kp, vp, tables, cl,
                                                window=window)
                want = decode_attention_paged_reference(q, kp, vp, tables,
                                                        cl, window=window)
                torch.cuda.synchronize()
                rows["decode_attention_paged"]["max_abs_err"] = max(
                    rows["decode_attention_paged"]["max_abs_err"],
                    attn_check(f"paged decode {cfg.name} {draw} (bf16, "
                               f"{shape}, 8 lanes, cache_len 32..1280"
                               f"{f', window {window}' if window else ''})",
                               got, want))
            if draw == "flat":
                ms = device_ms(lambda: decode_attention_paged_op(
                    q, kp, vp, tables, cl))
                lib = paged_sdpa_ms(q, kp, vp, tables, cl)
                bnd, by = bound_ms(*paged_bytes_flops(q, cfg.n_kv_heads,
                                                      tables, cl), BF16_FLOPS)
                print(f"  paged decode {cfg.name}: kernel {ms:.4f} ms, SDPA "
                      f"on gathered cache {lib:.4f} ms, bound {bnd:.5f} ms "
                      f"({by})")
            del q, kp, vp, tables, cl
    h, kvh, dh = nem.n_heads, nem.n_kv_heads, nem.head_dim
    for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
        q, k, v, cl = dense_decode_case(dev, gen, 8, h, kvh, dh, 1024, 1224,
                                        q_scale)
        got = decode_attention_op(q, k, v, cl, window=1024)
        want = decode_attention_dense_reference(q, k, v, cl, window=1024)
        torch.cuda.synchronize()
        rows["decode_attention_dense"]["max_abs_err"] = max(
            rows["decode_attention_dense"]["max_abs_err"],
            attn_check(f"dense decode nemotron-4-340b {draw} (bf16, H{h}/"
                       f"KV{kvh}, dh {dh}, S_max 1024, cache_len 1..1224, "
                       f"window 1024, {int((cl > 1024).sum())} rows "
                       f"wrapped)", got, want))
        if draw == "flat":
            ms = device_ms(lambda: decode_attention_op(q, k, v, cl))
            lib = dense_decode_sdpa_ms(q, k, v, cl)
            bnd, by = bound_ms(*dense_decode_bytes_flops(q, k, cl),
                               BF16_FLOPS)
            print(f"  dense decode nemotron-4-340b: kernel {ms:.4f} ms, SDPA "
                  f"with a boolean mask {lib:.4f} ms, bound {bnd:.5f} ms "
                  f"({by})")
        del q, k, v, cl
    for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
        q, k, v, pos, kv_pos = flash_case(nem, dev, gen, 512, 512, 512)
        q = (q.float() * q_scale).bfloat16()
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        rows["flash_attention_prefill"]["max_abs_err"] = max(
            rows["flash_attention_prefill"]["max_abs_err"],
            attn_check(f"flash prefill nemotron-4-340b {draw} (bf16, H{h}/"
                       f"KV{kvh}, dh {dh}, C=512, S_past=512, start=512)",
                       got, want))
        if draw == "flat":
            ms = device_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
            mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 \
                + (pos.numel() + kv_pos.numel()) * 4
            bnd, by = bound_ms(n_bytes, 4.0 * float(mask.sum()) * h * dh,
                               BF16_FLOPS)
            print(f"  flash prefill nemotron-4-340b (C=512, S_past=512): "
                  f"kernel {ms:.4f} ms, SDPA {lib:.4f} ms, bound "
                  f"{bnd:.5f} ms ({by})")
            del qt, kt, vt
        del q, k, v, want, got
    for cfg in (gra, nem):
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for draw, q_scale in (("flat", 1.0), ("peaked", PEAKED_Q)):
            q, kp, vp, tables, cl = lse_case(dev, gen, h, kvh, dh, q_scale)
            bt, cls = stripe(tables, cl, 0)
            out, lse = decode_attention_paged_lse_op(q, kp, vp, bt, cls)
            want_o, want_l = decode_attention_paged_lse_reference(
                q, kp, vp, bt, cls)
            torch.cuda.synchronize()
            what = (f"paged lse {cfg.name} {draw} (bf16, H{h}/KV{kvh}, dh "
                    f"{dh}) stripe 0")
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise SystemExit(f"FAIL {what}: non-finite output")
            rows["decode_attention_paged_lse"]["max_abs_err"] = max(
                rows["decode_attention_paged_lse"]["max_abs_err"],
                attn_check(f"{what}: out", out, want_o))
            check(f"{what}: lse (f32)", lse, want_l, LSE_TOL)
            if draw == "flat":
                ms = device_ms(lambda: decode_attention_paged_lse_op(
                    q, kp, vp, bt, cls))
                lib_name, lib = lse_library_ms(q, kp, vp, bt, cls)
                bnd, by = bound_ms(*lse_bytes_flops(q, kvh, bt, cls),
                                   BF16_FLOPS)
                print(f"  paged lse {cfg.name} stripe 0 of 4: kernel "
                      f"{ms:.4f} ms, {lib_name} {lib:.4f} ms, bound "
                      f"{bnd:.5f} ms ({by})")
            del q, kp, vp, tables, cl
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4

class ShapeRecordingBackend(CudaPriorityBackend):
    """The CUDA Gittins backend, noting the (n, k) of every refresh."""

    def __init__(self, device):
        super().__init__(device=device)
        self.shapes = []

    def gittins(self, support, probs, attained):
        self.shapes.append(np.shape(support))
        return super().gittins(support, probs, attained)


def make_requests(cfg, seed: int, temperature: float = 0.0):
    """Two waves of 8 requests (greedy unless ``temperature`` > 0): long
    prompts (512-1024 tokens, 128-256 new) first, then short ones
    (32-256 tokens, 32-128 new)."""
    rng = np.random.default_rng(seed)
    waves = []
    for w, (lo, hi, nlo, nhi) in enumerate(((512, 1024, 128, 256),
                                           (32, 256, 32, 128))):
        wave = []
        for i in range(8):
            n = int(rng.integers(lo, hi + 1))
            toks = [int(t) for t in rng.integers(3, cfg.vocab_size, n)]
            wave.append(ServeRequest(
                f"w{w}r{i}", f"wave {w} request {i} topic {i % 3}", toks,
                max_new_tokens=int(rng.integers(nlo, nhi + 1)),
                temperature=temperature, eos_token=-1))
        waves.append(wave)
    return waves


def serve(cfg, params, dev, step_mode: str, *, n_slots=8, max_seq_len=2048,
          capacity_tokens=8192, prefill_chunk=512, first_wave_steps=24,
          seed=0, mesh=None, parallel="exact", graphs=True,
          temperature=0.0):
    """Serve the two waves; returns (engine, requests, seconds, backend).
    Fails if the fused step's keys exceed ``max_fused_compiles()``."""
    backend = ShapeRecordingBackend(dev)
    engine = ServingEngine(
        model=build_model(cfg),
        scheduler=Scheduler(policy=make_policy("sagesched"),
                            priority_backend=backend, bucket_size=50),
        n_slots=n_slots, max_seq_len=max_seq_len,
        capacity_tokens=capacity_tokens, prefill_chunk=prefill_chunk,
        params=params, step_mode=step_mode, seed=seed, device=dev,
        mesh=mesh, parallel=parallel, graphs=graphs)
    waves = make_requests(cfg, seed, temperature)
    t0 = time.perf_counter()
    engine.submit_batch(waves[0])
    for _ in range(first_wave_steps):
        engine.step()
    engine.submit_batch(waves[1])
    engine.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    reqs = waves[0] + waves[1]
    unfinished = [r.request_id for r in reqs
                  if r.state != RequestState.FINISHED]
    if unfinished:
        raise SystemExit(f"FAIL serve[{step_mode}]: unfinished {unfinished}")
    if engine.fused_compile_count > engine.max_fused_compiles():
        raise SystemExit(f"FAIL serve[{step_mode}]: fused keys "
                         f"{engine.fused_compile_count} exceed the bound "
                         f"{engine.max_fused_compiles()}")
    return engine, reqs, seconds, backend


def graph_report(engine) -> str:
    """The fused keys against their bound, the graphs captured (and the
    host seconds of the keys' first calls: the eager step and its
    capture), and the host ms of a steady-state decode call (staging,
    replay or the eager step, copy back, wait; calls after each key's
    first)."""
    runners = list(engine._fused_runners.values())
    if engine._orchestrated_runner is not None:
        runners.append(engine._orchestrated_runner)
    calls = sum(r.calls - 1 for r in runners)
    ms = sum(r.steady_s for r in runners) * 1e3 / max(calls, 1)
    return (f"{'graphs' if engine.graphs else 'eager'}: fused keys "
            f"{engine.fused_compile_count} / max_fused_compiles() "
            f"{engine.max_fused_compiles()}, graphs captured "
            f"{engine.graphs_captured} (first calls and captures "
            f"{engine._step_graphs.first_s:.3f} s), {calls} steady calls "
            f"at {ms:.3f} host ms")


def hold_eager(label: str, got, launches, want, want_launches) -> None:
    """An eager drive against its graphed twin: token-identical streams
    and launch for launch the same kernel counts."""
    same = sum(a == b for a, b in zip(got, want))
    print(f"    {label} graphs vs eager: {same}/{len(got)} streams "
          f"identical (held), launches "
          f"{'equal' if launches == want_launches else 'DIFFERENT'} "
          f"(held)")
    if got != want or launches != want_launches:
        raise SystemExit(f"FAIL {label}: the eager drive parts from the "
                         f"graphed one (launches {launches} against "
                         f"{want_launches})")


def path_kernels(cfg) -> tuple:
    """The kernels a served model's main path launches."""
    attn = (PAGED_DECODE_KERNEL, FLASH_PREFILL_KERNEL)
    return (GITTINS_KERNEL,) + {"dense": attn, "ssm": (SSD_SCAN_KERNEL,),
                                "hybrid": (SSD_SCAN_KERNEL,) + attn
                                }[cfg.family]


def swap_bytes(engine) -> int:
    """Bytes of one request's recurrent state in a swap payload."""
    ssm = engine._cache.get("ssm", {})
    return sum(t[:, 0].numel() * t.element_size() for t in ssm.values())


def phase_serve(cfg, dev) -> tuple[dict, tuple]:
    """The graphed fused and orchestrated drives (their launches are the
    phase's), then, per EAGER_HELD and SAMPLED_HELD, the eager and
    sampled drives held to their graphed twins."""
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg).init(gen)
    kernels = path_kernels(cfg)
    drives = [("fused", True, 0.0), ("orchestrated", True, 0.0)]
    if cfg.name in EAGER_HELD:
        drives.append(("fused", False, 0.0))
    if cfg.name in SAMPLED_HELD:
        drives += [("fused", True, SAMPLED_T), ("fused", False, SAMPLED_T)]
    streams, launches, max_shape = {}, {}, (0, 0)
    for mode, graphs, temp in drives:
        label = f"{mode}, {'graphs' if graphs else 'eager'}" + (
            f", T {temp}" if temp else "")
        for kern in kernels:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        engine, reqs, secs, backend = serve(cfg, params, dev, mode,
                                            graphs=graphs, temperature=temp)
        launches[label] = {k.symbol: k.launches for k in kernels}
        streams[label] = [r.output_tokens for r in reqs]
        m = engine.metrics.summary(reqs)
        gen_tokens = sum(r.generated for r in reqs)
        ttft = np.array([r.ttft for r in reqs])
        ttlt = np.array([r.ttlt for r in reqs])
        print(f"  serve[{label}] {torch.cuda.get_device_name(0)}: "
              f"{len(reqs)}/{len(reqs)} finished, {gen_tokens} tokens in "
              f"{secs:.3f} s = {gen_tokens / secs:.1f} tok/s, TTFT p50 "
              f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} s, "
              f"preemptions {m['preemptions']}, swap outs {m['swap_outs']}, "
              f"swap ins {m['swap_ins']}, prefill chunks "
              f"{m['prefill_chunks']}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches {launches[label]}")
        print(f"    {graph_report(engine)}")
        if engine._slot_state:
            per = swap_bytes(engine)
            print(f"    recurrent state per swap payload {per / 1e6:.1f} MB; "
                  f"{(m['swap_outs'] + m['swap_ins']) * per / 1e9:.3f} GB "
                  f"moved by {m['swap_outs']} swap outs + {m['swap_ins']} "
                  f"swap ins")
        if m["preemptions"] == 0 or m["swap_outs"] == 0:
            raise SystemExit(f"FAIL serve[{label}]: the scheduler did not "
                             f"preempt and swap ({m['preemptions']} "
                             f"preemptions, {m['swap_outs']} swap outs)")
        for shape in backend.shapes:
            if shape[0] * shape[1] > max_shape[0] * max_shape[1]:
                max_shape = shape
        missing = [s for s, n in launches[label].items() if n == 0]
        if missing:
            raise SystemExit(f"FAIL serve[{label}]: kernels never launched "
                             f"on the main path: {missing}")
        if not graphs:
            twin = label.replace("eager", "graphs")
            hold_eager(f"serve[{label}]", streams[label], launches[label],
                       streams[twin], launches[twin])
        del engine
        torch.cuda.empty_cache()
    fused, orch = streams["fused, graphs"], streams["orchestrated, graphs"]
    assert_tokens_close(fused, orch)
    same = sum(a == b for a, b in zip(fused, orch))
    print(f"  fused vs orchestrated: assert_tokens_close OK, {same}/"
          f"{len(fused)} streams identical")
    sampled = streams.get(f"fused, graphs, T {SAMPLED_T}")
    if sampled is not None:
        differ = sum(a != b for a, b in zip(sampled, fused))
        print(f"  sampled vs greedy (graphs): {differ}/{len(fused)} streams "
              f"differ (the noise is drawn)")
        if differ == 0:
            raise SystemExit("FAIL serve: the sampled streams equal the "
                             "greedy ones")
    del params
    torch.cuda.empty_cache()
    total = {s: launches["fused, graphs"][s]
             + launches["orchestrated, graphs"][s]
             for s in launches["fused, graphs"]}
    return total, max_shape


def phase_serve_wide(cfg, params, dev) -> dict:
    """One fused drive of the two waves at a WIDE shape: every request
    must finish, the scheduler must preempt and swap, and the paged
    decode and flash kernels must launch exactly as often as the path
    calls them (one a layer per decode call and per prefill chunk).
    Returns the launches."""
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
               FLASH_PREFILL_KERNEL)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    engine, reqs, secs, _ = serve(cfg, params, dev, "fused")
    launches = {k.symbol: k.launches for k in kernels}
    m = engine.metrics.summary(reqs)
    gen_tokens = sum(r.generated for r in reqs)
    ttft = np.array([r.ttft for r in reqs])
    ttlt = np.array([r.ttlt for r in reqs])
    print(f"  serve[fused] {cfg.name} {torch.cuda.get_device_name(0)}: "
          f"{len(reqs)}/{len(reqs)} finished, {gen_tokens} tokens in "
          f"{secs:.3f} s = {gen_tokens / secs:.1f} tok/s, TTFT p50 "
          f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} s, "
          f"preemptions {m['preemptions']}, swap outs {m['swap_outs']}, "
          f"swap ins {m['swap_ins']}, decode calls "
          f"{m['decode_iterations']}, prefill chunks {m['prefill_chunks']}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"launches {launches}")
    print(f"    {graph_report(engine)}")
    if m["preemptions"] == 0 or m["swap_outs"] == 0:
        raise SystemExit(f"FAIL serve {cfg.name}: the scheduler did not "
                         "preempt and swap")
    want = tp_launches(cfg, engine, m)
    if {k: launches[k] for k in want} != want \
            or launches[GITTINS_KERNEL.symbol] == 0:
        raise SystemExit(f"FAIL serve {cfg.name}: launches {launches}, the "
                         f"path calls {want} and Gittins")
    del engine
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------------------- phase 4b

def tp_launches(cfg, engine, m) -> dict:
    """The attention launches a drive's path makes: per decode call one
    paged kernel per layer and attention shard (kv-head shards where the
    plan shards attention, else one), or, under the LSE split, one partial
    kernel per layer and stripe; per prefill chunk one flash kernel per
    layer and attention shard."""
    report = engine.sharding_report() or {"attention": "replicated",
                                          "attn_splits": 1}
    shards = engine.tp if report["attention"] == "sharded" else 1
    per_step = cfg.n_layers * m["decode_iterations"]
    lse = report["attn_splits"] > 1
    return {PAGED_DECODE_KERNEL.symbol: 0 if lse else per_step * shards,
            PAGED_LSE_KERNEL.symbol: per_step * engine.tp if lse else 0,
            FLASH_PREFILL_KERNEL.symbol:
                cfg.n_layers * m["prefill_chunks"] * shards}


def tp_step_check(cfg, params, engine, dev) -> dict:
    """One decode step of ``engine``'s plan against the same step without
    a mesh, on the same pool and inputs: 8 rows of 37..512 tokens whose
    K/V a forward over random 512-token prompts wrote into a paged pool.
    Holds the logits within TP_STEP_ULPS bf16 steps (at the unsharded
    step's largest |logit|) and the argmax identical except where the
    plan's pick lies within 2 steps of the unsharded maximum."""
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, page = 8, 512, 16
    L, kvh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    toks = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)
    _, cache, _ = model.forward(params, {"tokens": toks}, collect_cache=True)
    p = s // page + 1
    tables = (1 + torch.arange(b * p, device=dev, dtype=torch.int32)
              ).reshape(b, p)
    pool = model.init_paged_cache(b * p + 1, page, b, device=dev)
    idx = (tables[:, :s // page].long()[:, :, None] * page
           + torch.arange(page, device=dev)).reshape(b * s)
    for name in ("k", "v"):
        pool[name].view(L, -1, kvh, dh)[:, idx] = \
            cache[name].reshape(L, b * s, kvh, dh)
    del cache
    cl = torch.tensor([37, 129, 250, 300, 401, 466, 500, 512],
                      dtype=torch.int32, device=dev)
    last = toks[:, -1:]
    want, _ = model.decode_step_paged(
        params, last, {k: v.clone() for k, v in pool.items()}, cl, tables,
        page_size=page)
    plan = engine.plan
    with plan.context():
        got, _ = model.decode_step_paged(
            engine.params, last, plan.place_cache(pool), cl, tables,
            page_size=page)
    if isinstance(got, list):
        got = plan.all_gather(got, -1)
    torch.cuda.synchronize()
    want, got = want.float(), got.float()
    if not torch.isfinite(got).all():
        raise SystemExit("FAIL tp step: non-finite logits")
    step = float(bf16_ulp(want.abs().max()))
    drift = float((got - want).abs().max()) / step
    wmax = want.max(dim=-1).values
    pick = got.argmax(dim=-1)
    flip = pick != want.argmax(dim=-1)
    margin = (wmax - want.gather(-1, pick[:, None])[:, 0]) / bf16_ulp(wmax)
    out = {"drift_ulps": drift, "flips": int(flip.sum()),
           "flip_ulps_max": float(margin[flip].max()) if bool(flip.any())
           else 0.0}
    print(f"    one decode step vs no mesh: max logit diff {drift:.2f} bf16 "
          f"steps (bar {TP_STEP_ULPS}; step {step:.4g} at max |logit| "
          f"{float(want.abs().max()):.4g}), argmax differs at "
          f"{out['flips']}/{b} rows (largest margin "
          f"{out['flip_ulps_max']:.2f} steps, excused within 2)")
    if drift > TP_STEP_ULPS or bool((flip & (margin > 2)).any()):
        raise SystemExit("FAIL tp step: the plan's decode step is not "
                         "within its bars of the unsharded step")
    return out


def lse_stripe_check(dev, n: int) -> None:
    """Whether the LSE split's merged decode of one row is the same at two
    table widths (the fused step's pow2 of the pages in use, 64, and the
    orchestrated step's whole table, 128): each stripe's partial kernel
    is width-invariant, the stripes' boundaries are not."""
    cfg = get_config(TP_ARCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, tables, cl = lse_case(dev, gen, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim)
    cl = torch.clamp(cl, max=1024)      # every row within the first 64 pages
    args = (q[:, None], kp, vp)
    narrow = decode_attention_paged(*args, tables[:, :64].contiguous(), cl,
                                    n_splits=n)
    whole = decode_attention_paged(*args, tables, cl, n_splits=n)
    cls = torch.clamp(cl, max=16 * 16)  # live rows within the 16 pages
    part = [decode_attention_paged_lse_op(q, kp, vp, t.contiguous(), cls)
            for t in (tables[:, :16], torch.nn.functional.pad(
                tables[:, :16], (0, 16)))]
    torch.cuda.synchronize()
    same = [int(torch.equal(narrow[r], whole[r])) for r in range(len(cl))]
    print(f"    LSE split of {n} stripes, tables of 64 and 128 pages: "
          f"{sum(same)}/{len(same)} rows bit-identical; one stripe's "
          f"partial at widths 16 and 32: "
          f"{'bit-identical' if all(torch.equal(a, b) for a, b in zip(*part)) else 'DIFFERENT'}")


def phase_serve_tp(dev) -> dict:
    """qwen2-1.5b at full width through the drives of TP_DRIVES, every
    shard on the one card.  Returns the summed launches."""
    cfg = get_config(TP_ARCH)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
               FLASH_PREFILL_KERNEL)
    total = {k.symbol: 0 for k in kernels}
    streams = {}
    for label, tp, parallel, modes in TP_DRIVES:
        graph_launches = {}
        mesh = None if tp is None else make_local_mesh(
            tp=tp, devices=[dev] * tp)
        runs = [(mode, graphs) for mode in modes
                for graphs in ((True, False) if label in TP_EAGER_HELD
                               else (True,))]
        for mode, graphs in runs:
            for kern in kernels:
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            engine, reqs, secs, _ = serve(cfg, params, dev, mode, mesh=mesh,
                                          parallel=parallel, graphs=graphs)
            launches = {k.symbol: k.launches for k in kernels}
            m = engine.metrics.summary(reqs)
            gen_tokens = sum(r.generated for r in reqs)
            ttft = np.array([r.ttft for r in reqs])
            ttlt = np.array([r.ttlt for r in reqs])
            report = engine.sharding_report()
            branch = "no mesh" if report is None else (
                f"tp {tp} {parallel}: attention {report['attention']}, "
                f"attn_splits {report['attn_splits']}, vocab "
                f"{report['vocab']}, mlp {report['mlp']}")
            how = "" if graphs else ", eager"
            print(f"  ({label}) serve[{mode}{how}] {TP_ARCH} {branch} "
                  f"{torch.cuda.get_device_name(0)}: {len(reqs)}/{len(reqs)} "
                  f"finished, {gen_tokens} tokens in {secs:.3f} s = "
                  f"{gen_tokens / secs:.1f} tok/s, TTFT p50 "
                  f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} "
                  f"s, preemptions {m['preemptions']}, swap outs "
                  f"{m['swap_outs']}, swap ins {m['swap_ins']}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                  f"decode calls {m['decode_iterations']}, launches "
                  f"{launches}")
            print(f"    {graph_report(engine)}")
            if m["preemptions"] == 0 or m["swap_outs"] == 0:
                raise SystemExit(f"FAIL tp ({label}): the scheduler did not "
                                 "preempt and swap")
            want = tp_launches(cfg, engine, m)
            if {k: launches[k] for k in want} != want \
                    or launches[GITTINS_KERNEL.symbol] == 0:
                raise SystemExit(f"FAIL tp ({label}): launches {launches}, "
                                 f"the path calls {want} and Gittins")
            expect = {"a": None,
                      "b": ("sharded", 1, "replicated", "replicated"),
                      "c": ("sharded", 1, "sharded", "sharded"),
                      "d": ("lse-split", 4, "sharded", "sharded")}[label]
            if (report and (report["attention"], report["attn_splits"],
                            report["vocab"], report["mlp"])) != expect:
                raise SystemExit(f"FAIL tp ({label}): plan {report}")
            got = [r.output_tokens for r in reqs]
            if not graphs:
                hold_eager(f"({label}) serve[{mode}]", got, launches,
                           streams[label, mode], graph_launches[mode])
                del engine
                torch.cuda.empty_cache()
                continue
            streams[label, mode] = got
            graph_launches[mode] = launches
            if label == "b" and got != streams["a", "fused"]:
                raise SystemExit("FAIL tp (b): exact tp=2 is not "
                                 "token-identical to no mesh")
            if label in ("b", "c", "d"):
                st = assert_tokens_close(got, streams["a", "fused"],
                                         min_match_rate=0.0)
                print(f"    streams vs (a): match rate {st['rate']:.4f} "
                      f"({st['matched']}/{st['compared']}, "
                      f"{st['divergences']} streams diverged)")
            if mode == "orchestrated":
                same = sum(a == b for a, b in zip(got,
                                                  streams[label, "fused"]))
                held = label in TP_SAME_STREAMS
                print(f"    fused vs orchestrated: {same}/{len(got)} streams "
                      f"identical ({'held' if held else 'printed'})")
                if held and got != streams[label, "fused"]:
                    raise SystemExit(f"FAIL tp ({label}): the fused and "
                                     "orchestrated streams part")
                if not held:
                    lse_stripe_check(dev, engine.tp)
            if label in ("c", "d") and mode == "fused":
                tp_step_check(cfg, params, engine, dev)
            for k, n in launches.items():
                total[k] += n
            del engine
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------- phase 5

def generate_launches(cfg, steps: int) -> dict:
    """The kernel launches the dense-cache path makes: per step, one dense
    decode per attention layer (the hybrid's G group layers) and, for the
    encoder-decoder, one flash cross-attention per decoder layer through
    the key split; in the prefill, flash for each attention layer's
    self-attention (plus the encoder's layers and the cross-attention of
    the encoder-decoder), and one SSD scan per Mamba2 layer."""
    attn = {"dense": cfg.n_layers, "encdec": cfg.n_layers, "ssm": 0,
            "hybrid": -(-cfg.n_layers // cfg.hybrid_attn_every)}[cfg.family]
    flash, split = attn, 0
    if cfg.family == "encdec":
        # the prefill's encoder and cross-attention layers; each step's
        # cross-attention (one query over the frames) takes the key split
        flash += cfg.n_encoder_layers + cfg.n_layers
        split = steps * cfg.n_layers
    return {DENSE_DECODE_KERNEL.symbol: steps * attn,
            FLASH_PREFILL_KERNEL.symbol: flash,
            FLASH_SPLIT_KERNEL.symbol: split,
            SSD_SCAN_KERNEL.symbol: cfg.n_layers
            if cfg.family in ("ssm", "hybrid") else 0}


def phase_generate(cfg, dev, *, b: int, prompt: int, max_len: int,
                   steps: int, logit_ulps: int | None,
                   n_frames: int = 0, params=None) -> dict:
    """Drive Model.prefill -> Model.decode_step at full width from random
    weights of a seeded generator on the card (or the given ``params``,
    another drive's); returns the launches of the drive's kernels.  The
    teacher-forced comparison is held at ``logit_ulps`` bf16 steps, or
    printed but not held where it is None."""
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg)
    if params is None:
        params = model.init(gen)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (b, prompt),
                                     generator=gen, device=dev)}
    encdec = cfg.family == "encdec"
    if encdec:
        batch["frames"] = (torch.randn(b, n_frames, cfg.d_model,
                                       generator=gen, device=dev)
                           * 0.02).bfloat16()
        enc_ms = cuda_ms(lambda: encode(params, cfg, batch["frames"]),
                         iters=1, warmup=1)
    kernels = (DENSE_DECODE_KERNEL, FLASH_PREFILL_KERNEL, FLASH_SPLIT_KERNEL,
               SSD_SCAN_KERNEL)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    run = greedy_generate(model, params, batch, max_len, steps)
    launches = {k.symbol: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not run["finite"]:
        raise SystemExit(f"FAIL generate {cfg.name}: non-finite logits")
    want = generate_launches(cfg, steps)
    if launches != want:
        raise SystemExit(f"FAIL generate {cfg.name}: launches {launches}, "
                         f"the path calls {want}")
    held = logit_ulps is not None
    bars = dict(logit_ulps=logit_ulps) if held else \
        dict(logit_ulps=math.inf, flip_ulps=math.inf)
    stats = teacher_forced_check(model, params, batch, run,
                                 f"generate {cfg.name}", **bars)
    toks = b * steps
    print(f"  generate {cfg.name} {torch.cuda.get_device_name(0)}: B {b}, "
          + (f"{n_frames} frames, encode {enc_ms:.3f} ms, " if encdec else "")
          + f"prompt {prompt}, cache {max_len}, {steps} steps: prefill "
          f"{run['prefill_s'] * 1e3:.3f} ms, decode "
          f"{run['decode_s'] * 1e3 / steps:.3f} ms per step = "
          f"{toks / run['decode_s']:.1f} tok/s, peak memory {peak:.3f} GiB, "
          f"launches {launches}; all logits finite; vs teacher-forced "
          f"forward ({'held' if held else 'printed, not held'}): max logit "
          f"diff {stats['max_logit_diff']:.4e} = "
          f"{stats['drift_ulps']:.2f} bf16 steps (bar "
          f"{stats['logit_bar']:.4e}), {stats['matched']}/"
          f"{stats['compared']} positions matched, {stats['divergences']} "
          f"divergences; argmax identical at {stats['exact']}/"
          f"{stats['positions']}, exact top-1 ties at {stats['ties']}, "
          f"{stats['coin_tosses']} flips excused, largest flip margin "
          f"{stats['flip_ulps_max']:.2f} bf16 steps")
    del params, model, run
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 6

class ParentOpBackend(CudaPriorityBackend):
    """The Gittins backend path the staged refresh replaced:
    ``gittins_attained_op`` (the rows padded into new numpy arrays, three
    pageable copies) and a blocking ``.cpu()`` on the current stream."""

    def gittins(self, support, probs, attained):
        out = gittins_attained_op(support, probs, attained,
                                  device=self.device)
        return out.cpu().numpy().astype(np.float64)


def gittins_case(n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    sup = np.sort(rng.uniform(1, 1e5, (n, k)), axis=1)
    probs = rng.dirichlet(np.ones(k), n)
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)
    return sup, probs, att


def gittins_bound(n: int, k: int):
    """(bound ms, by) of one (n, k) refresh: support, probs and attained
    read once, the index written once; ~15 f32 operations a column."""
    return bound_ms((2 * n * k + 2 * n) * 4, 15.0 * n * k, F32_FLOPS)


def host_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host-clock ms of one call of ``fn`` (which returns to the host)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def refresh_backlog_ms(backend, depth: int = 1024, reps: int = 20,
                       seed: int = 0) -> tuple[float, tuple]:
    """Host-clock ms of ``Scheduler.refresh()`` (sagesched) over a
    ``depth``-deep backlog made from ``seed``, every row dirty: 200
    completed requests give the predictor a history, then ``depth``
    arrivals; before each refresh every live request crosses its next
    bucket boundary.  Returns (ms, (rows, k))."""
    rng = np.random.default_rng(seed)
    topics = ("summarize the quarterly report", "write a short story about",
              "explain this python code", "translate the phrase into french",
              "list the steps to bake bread")
    sched = Scheduler(policy="sagesched", priority_backend=backend,
                      bucket_size=50)
    for i in range(200):
        sched.admit(f"h{i}", f"{topics[i % 5]} {i % 7}",
                    int(rng.integers(16, 2048)), arrival=0.0)
        sched.on_complete(f"h{i}", int(rng.integers(16, 1024)))
    ids = [f"r{i}" for i in range(depth)]
    sched.admit_batch(ids, [f"{topics[i % 5]} {i % 7}" for i in range(depth)],
                      [int(x) for x in rng.integers(16, 2048, depth)],
                      arrivals=[0.0] * depth)
    shape = (sched._state.n, sched._state.k)
    generated = np.zeros(depth, np.int64)
    total = 0.0
    for _ in range(reps):
        generated += 50
        sched.on_progress_many(ids, generated.tolist())
        t0 = time.perf_counter()
        rows = sched.refresh()
        total += time.perf_counter() - t0
        if rows != depth:
            raise SystemExit(f"FAIL refresh: {rows} of {depth} rows dirty")
    return total / reps * 1e3, shape


def phase_gittins(dev, shape) -> dict:
    """The kernel against its plain version at every refresh shape (a row
    alone bit-identical to the same row in its batch), the staged refresh
    against the kernel on the same padded inputs, device times of the
    kernel and of the parent's (tools/gittins_variants/warp_row.cu) in
    turns, host times of the staged refresh and of the parent's op path,
    its copies under torch.profiler, and Scheduler.refresh() over a
    1024-deep backlog under the numpy, staged and parent backends."""
    err = 0.0
    n_main, k_main = pow2_bucket(shape[0], 8), pow2_bucket(shape[1], 8)
    parent = PARENT_GITTINS.get("run")
    shapes = ((n_main, k_main),) + tuple(
        s for s in GITTINS_SHAPES if s != (n_main, k_main))
    for n, k in shapes + ((1000, 256), (100, 12)):
        sup, probs, att = gittins_case(n, k, seed=n + k)
        s, p, a = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                   for x in (sup, probs, att))
        got = gittins_attained(s, p, a)
        want = gittins_attained_reference(s, p, a)
        torch.cuda.synchronize()
        c = check(f"gittins (n={n}, k={k})", got, want, GITTINS_RTOL,
                  rel=True)
        err = max(err, c)
        if parent:
            check(f"gittins (n={n}, k={k}), the parent's kernel",
                  parent(s, p, a), want, GITTINS_RTOL, rel=True)
        rows = sorted({0, 1, n // 2, n - 1})
        alone = torch.cat([gittins_attained(s[r:r + 1], p[r:r + 1],
                                            a[r:r + 1]) for r in rows])
        if not torch.equal(alone, got[rows]):
            raise SystemExit(f"FAIL gittins (n={n}, k={k}): a row alone "
                             f"differs from the same row in its batch")
        staged = CudaPriorityBackend(dev).gittins(sup, probs, att)
        direct = gittins_attained(*(torch.from_numpy(x).to(dev) for x in
                                    padded_rows(sup, probs, att)))[:n]
        if not np.array_equal(staged, direct.cpu().numpy().astype(np.float64)):
            raise SystemExit(f"FAIL gittins (n={n}, k={k}): the staged "
                             f"refresh differs from the kernel on the same "
                             f"padded inputs")
    print("  gittins: a row alone == the row in its batch, staged refresh "
          "== kernel on the same padded inputs, bit for bit, at every shape")

    instances = {}
    for n, k in shapes:
        copies = GITTINS_COLD if (n, k) == GITTINS_SHAPES[-1] else 1
        sets = [[torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                 for x in gittins_case(n, k, seed=i)] for i in range(copies)]
        bnd, by = gittins_bound(n, k)
        fns = {"kernel": gittins_attained}
        if parent:
            fns["parent"] = parent
        for label, used in (("warm", sets[:1]), ("cold", sets)):
            if label == "cold" and copies == 1:
                continue
            times = {name: [] for name in fns}
            for name in list(fns) + list(reversed(fns)):
                cyc, fn = itertools.cycle(used), fns[name]
                times[name].append(device_ms(lambda: fn(*next(cyc)),
                                             iters=40))
            ms = min(times["kernel"])
            parent_ms = min(times["parent"]) if parent else None
            print(f"  gittins kernel (n={n}, k={k}, {label} L2"
                  f"{'' if len(used) == 1 else f', {len(used)} input copies'}"
                  f"): "
                  f"{' / '.join(f'{t:.5f}' for t in times['kernel'])} ms, "
                  f"parent's kernel "
                  + (' / '.join(f'{t:.5f}' for t in times['parent'])
                     + ' ms' if parent else 'not built')
                  + f", bound {bnd:.4e} ms ({by}), {bnd / ms:.1%} of it")
            instances[f"n={n} k={k} {label}"] = {
                "ms": ms, "parent_ms": parent_ms, "bound_ms": bnd,
                "bound_by": by}
    cold = instances.get(f"n={GITTINS_SHAPES[-1][0]} "
                         f"k={GITTINS_SHAPES[-1][1]} cold")
    if cold and cold["ms"] > 2 * cold["bound_ms"]:
        print(f"  gittins: NOT MET: under half the byte bound at "
              f"{GITTINS_SHAPES[-1]} ({cold['ms']:.5f} > "
              f"{2 * cold['bound_ms']:.5f} ms)")
    s, p, a = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
               for x in gittins_case(n_main, k_main, seed=1))
    plain_ms = cuda_ms(lambda: gittins_attained_reference(s, p, a), iters=20)

    # the op, numpy in to numpy out, on the host clock: the staged
    # refresh and the parent's path, in turns
    staged, parent_op = CudaPriorityBackend(dev), ParentOpBackend(dev)
    op_ms = {}
    for n, k in ((8, 8), (1024, 32)):
        case = gittins_case(n, k, seed=3)
        t = {"staged": [], "parent": []}
        for name in ("staged", "parent", "parent", "staged"):
            b = staged if name == "staged" else parent_op
            t[name].append(host_ms(lambda: b.gittins(*case)))
        op_ms[f"n={n} k={k}"] = {name: min(v) for name, v in t.items()}
        staged_s, parent_s = (" / ".join(f"{x:.4f}" for x in t[name])
                              for name in ("staged", "parent"))
        print(f"  gittins op (n={n}, k={k}), numpy in to numpy out, host "
              f"clock: staged refresh {staged_s} ms, parent's op path "
              f"{parent_s} ms")
    # the staged refresh's copies as the profiler sees them: 10 calls
    # traced after 10 in a warm-up cycle (the trace's first activity can
    # go unrecorded when tracing starts cold); a trace that records no
    # copy at all is taken once more, then fails
    from torch.profiler import ProfilerActivity, profile, schedule
    case = gittins_case(1024, 32, seed=4)
    for attempt in range(2):
        copies = {"HtoD": 0, "DtoH": 0}

        def count_copies(prof):
            for ev in prof.key_averages():
                for d in copies:
                    if d in ev.key:
                        copies[d] += ev.count
                        print(f"    traced: {ev.count} x {ev.key}")

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=count_copies) as prof:
            for _ in range(2):
                n0 = GITTINS_KERNEL.launches
                for _ in range(10):
                    staged.gittins(*case)
                torch.cuda.synchronize()
                prof.step()
        print(f"  gittins staged refresh x10 under torch.profiler: {copies} "
              f"memcpy events, {GITTINS_KERNEL.launches - n0} counted "
              f"launches")
        if GITTINS_KERNEL.launches - n0 != 10:
            raise SystemExit("FAIL gittins: the staged refresh did not "
                             "count one launch a call")
        if any(copies.values()):
            break
    if copies != {"HtoD": 10, "DtoH": 10}:
        raise SystemExit(f"FAIL gittins: 10 staged refreshes traced {copies} "
                         f"memcpy events, not one copy each way a call")
    refresh = {}
    for name, b in (("numpy", "numpy"), ("staged", staged),
                    ("parent", parent_op)):
        refresh[name], bshape = refresh_backlog_ms(b)
    print(f"  Scheduler(sagesched).refresh() over a 1024-deep backlog "
          f"(BatchState {bshape}), every row dirty, host clock: "
          + ", ".join(f"{k} backend {v:.4f} ms" for k, v in refresh.items()))
    main = instances[f"n={n_main} k={k_main} warm"]
    return {"name": "gittins_attained", "route": "cuda",
            "source": "src/repro_torch/csrc/gittins.cu",
            "replaces": "src/repro/kernels/gittins/kernel.py:39",
            "max_abs_err": err, "ms": main["ms"], "plain_ms": plain_ms,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "instances": instances, "op_ms": op_ms,
            "refresh_ms": refresh, "staged_copies": copies}


def phase_trace(cfg, dev) -> None:
    """Device busy share of a graphed and an eager fused serve drive, each
    from a torch.profiler trace of the card's activity, and the largest
    device-time entries of each."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    for graphs in (True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine, reqs, secs, _ = serve(cfg, params, dev, "fused",
                                          graphs=graphs)
        report = graph_report(engine)
        del engine
        torch.cuda.empty_cache()
        events = sorted(prof.key_averages(), key=device_us, reverse=True)
        busy_s = sum(device_us(e) for e in events) / 1e6
        print(f"  traced fused drive of {cfg.name} "
              f"({'graphs' if graphs else 'eager'}): wall {secs:.3f} s "
              f"(profiler on), device busy {busy_s:.3f} s = "
              f"{100 * busy_s / secs:.1f}% of wall, "
              f"{sum(r.generated for r in reqs)} tokens; {report}")
        for e in events[:12]:
            print(f"    {device_us(e) / 1e3:10.3f} ms  {e.count:7d} x  "
                  f"{e.key[:90]}")
    del params
    torch.cuda.empty_cache()


def main() -> int:
    trace = sys.argv[1:] == ["--trace"]
    kernels_only = sys.argv[1:] == ["--kernels"]
    if sys.argv[1:] and not (trace or kernels_only):
        print(f"usage: {sys.argv[0]} [--trace | --kernels]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])

    t0 = time.perf_counter()
    parent_builds = [BuildThread(target=f) for f in
                     (build_parent_ssd, build_parent_gittins)]
    for t in parent_builds:
        t.start()          # their nvcc beside the package's
    built = build_all()
    print(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.2f} "
          f"s wall (nvcc per source: "
          f"{ {k: round(v[0], 2) for k, v in built.items()} })")
    for _, log in built.values():
        print_ptxas(log)
    for t in parent_builds:
        t.join()
    if "log" in PARENT_SSD:
        print("  the parent's SSD kernel (tools/ssd_variants/scalar.cu):")
        print_ptxas(PARENT_SSD["log"])
    if "log" in PARENT_GITTINS:
        print("  the parent's Gittins kernel "
              "(tools/gittins_variants/warp_row.cu):")
        print_ptxas(PARENT_GITTINS["log"])

    if trace:
        for arch in SERVED:
            print(f"trace: a graphed and an eager fused serve drive of "
                  f"{arch} under torch.profiler")
            phase_trace(get_config(arch), dev)
        return 0
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device=dev).manual_seed(1234)
    print("phase 3: attention and SSD scan kernels vs plain versions")
    attn = [cfg, get_config("zamba2-1.2b")]
    rows = [phase_decode(attn, dev, gen), phase_flash(attn, dev, gen),
            phase_dense_decode(dev, gen), phase_ssd(dev, gen)]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 phase_flash_noncausal(dev, gen))
    # this PR's checks draw after the earlier ones, which keep their inputs
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 phase_flash_dh128(dev, gen))
    rows.append(phase_lse(dev, gen))
    phase_wide_heads(dev, gen, {r["name"]: r for r in rows}, kernels_only)
    if kernels_only:
        print("phase 6: gittins kernel (no serve drive: main-path shape "
              "taken as (8, 8))")
        phase_gittins(dev, (8, 8))
        return 0

    launches, shape = {}, (0, 0)
    for arch in SERVED:
        cfg = get_config(arch)
        print(f"phase 4: serving {cfg.name} at full width "
              f"({cfg.n_layers} layers, d {cfg.d_model}, vocab "
              f"{cfg.vocab_size})")
        got, shp = phase_serve(cfg, dev)
        for sym, n in got.items():
            launches[sym] = launches.get(sym, 0) + n
        if shp[0] * shp[1] > shape[0] * shape[1]:
            shape = shp
    shared = {}   # nemotron's weights, for its phase-5 drive too
    for arch, cut in WIDE:
        cfg = get_config(arch).with_overrides(**cut)
        print(f"phase 4: serving {cfg.name} at full width cut to "
              f"{cfg.n_layers} layers (d {cfg.d_model}, H{cfg.n_heads}/"
              f"KV{cfg.n_kv_heads}, dh {cfg.head_dim}, vocab "
              f"{cfg.vocab_size}), fused")
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
        for sym, n in phase_serve_wide(cfg, params, dev).items():
            launches[sym] = launches.get(sym, 0) + n
        if any(arch == a for a, c, _ in GENERATE_DRIVES if c == cut):
            shared[arch] = params
        del params
        torch.cuda.empty_cache()
    cfg = get_config(TP_ARCH)
    print(f"phase 4b: serving {cfg.name} at full width tensor-parallel "
          f"({cfg.n_layers} layers, d {cfg.d_model}, H{cfg.n_heads}/"
          f"KV{cfg.n_kv_heads}, vocab {cfg.vocab_size}), every shard on "
          f"{torch.cuda.get_device_name(0)}")
    for sym, n in phase_serve_tp(dev).items():
        launches[sym] = launches.get(sym, 0) + n
    for arch, cut, kw in GENERATE_DRIVES:
        cfg = get_config(arch).with_overrides(**cut)
        layers = (f"{cfg.n_encoder_layers} + {cfg.n_layers}"
                  if cfg.family == "encdec" else f"{cfg.n_layers}")
        print(f"phase 5: generating with {cfg.name} at full width ({layers} "
              f"layers{f', cut by {cut}' if cut else ''}, d {cfg.d_model}, "
              f"vocab {cfg.vocab_size}) through Model.prefill -> "
              f"Model.decode_step")
        for sym, n in phase_generate(cfg, dev, params=shared.pop(arch, None),
                                     **kw).items():
            launches[sym] = launches.get(sym, 0) + n
        torch.cuda.empty_cache()
    print(f"phase 6: gittins kernel (largest main-path refresh {shape})")
    rows.insert(0, phase_gittins(dev, shape))
    symbols = {"gittins_attained": GITTINS_KERNEL.symbol,
               "decode_attention_paged": PAGED_DECODE_KERNEL.symbol,
               "flash_attention_prefill": FLASH_PREFILL_KERNEL.symbol,
               "decode_attention_dense": DENSE_DECODE_KERNEL.symbol,
               "ssd_scan": SSD_SCAN_KERNEL.symbol,
               "decode_attention_paged_lse": PAGED_LSE_KERNEL.symbol}
    for row in rows:
        row["launches"] = launches[symbols[row["name"]]]
    # the flash kernel's two entry points: one launch a call each
    flash = next(r for r in rows if r["name"] == "flash_attention_prefill")
    flash["split_launches"] = launches.get(FLASH_SPLIT_KERNEL.symbol, 0)
    flash["launches"] += flash["split_launches"]
    flash["instances"] = {
        "Sq > 16, causal or windowed": "flash_attention_prefill (1 consumer "
        "warpgroup a 64-row query tile)",
        "Sq <= 16, bidirectional": "attention_short_queries in "
        "src/repro_torch/csrc/decode_attention.cu (split-KV decode template "
        "with key positions, 256-row sub-splits) + merge_kernel"}
    if flash["split_launches"] == 0:
        raise SystemExit("FAIL: the flash key split never launched on a "
                         "main path")
    idle = [r["name"] for r in rows if r["launches"] == 0]
    if idle:
        raise SystemExit(f"FAIL: kernels never launched on a main path: "
                         f"{idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "split_launches", "instances", "op_ms", "refresh_ms",
            "staged_copies")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
