"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one H100; exits non-zero on any failure
    python3 chip_smoke.py --trace    # phases 1-2, then one fused drive under
                                     # torch.profiler: device busy share and
                                     # the largest device-time entries

Phases:
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
  3. hold the paged-decode and flash-prefill kernels against their plain
     PyTorch versions in bf16 at the serving path's shapes, and time
     kernel, plain version and the library yardstick (SDPA);
  4. serve at the full width of llama3.2-1b (random weights from a
     seed): SageSched with the CUDA Gittins backend, 8 slots x 2048
     tokens, 16 greedy requests in two waves so that the scheduler
     preempts and swaps; once fused, once orchestrated.  Every request
     must finish in both, the streams must agree under the tolerance
     contract, and every kernel must have launched during the runs;
  5. hold the Gittins kernel against its plain version at the largest
     refresh shape the run gave it, and time it beside the numpy float64
     oracle at n = 4096, k = 64;
  6. print one JSON line of per-kernel results, then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CudaPriorityBackend, Scheduler,  # noqa: E402
                              gittins_index_batch, make_policy)
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    PAGED_DECODE_KERNEL, decode_attention_paged_op)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_paged_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_PREFILL_KERNEL, flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference)
from repro_torch.kernels.gittins.ops import (  # noqa: E402
    GITTINS_KERNEL, gittins_attained)
from repro_torch.kernels.gittins.ref import (  # noqa: E402
    gittins_attained_reference)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (RequestState, ServeRequest,  # noqa: E402
                                 ServingEngine)
from repro_torch.testing import assert_tokens_close  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
BF16_TOL = 2e-2          # bf16 kernel vs plain version (tests/test_kernels.py)
GITTINS_RTOL = 1e-4      # f32 kernel vs plain version


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float,
          rel: bool = False) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise SystemExit(f"FAIL {name}: non-finite kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    limit = tol * want.abs() + (0.0 if rel else tol)
    bad = int((err > limit).sum())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol={tol:g}{' rel' if rel else ' abs+rel'} "
          f"{'OK' if bad == 0 else f'{bad} elements out of tolerance'}")
    if bad:
        raise SystemExit(f"FAIL {name}: kernel disagrees with plain version")
    return max_abs


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


def phase_decode(cfg, dev, gen) -> dict:
    q, kp, vp, tables, cl = decode_case(cfg, dev, gen)
    got = decode_attention_paged_op(q, kp, vp, tables, cl)
    want = decode_attention_paged_reference(q, kp, vp, tables, cl)
    torch.cuda.synchronize()
    err = check("paged decode (bf16, 8 lanes, cache_len 32..1280)", got, want,
                BF16_TOL)
    # windowed variant: same kernel, logical sliding window of 256
    got_w = decode_attention_paged_op(q, kp, vp, tables, cl, window=256)
    want_w = decode_attention_paged_reference(q, kp, vp, tables, cl,
                                              window=256)
    err = max(err, check("paged decode, window 256", got_w, want_w, BF16_TOL))
    ms = cuda_ms(lambda: decode_attention_paged_op(q, kp, vp, tables, cl))
    plain_ms = cuda_ms(lambda: decode_attention_paged_reference(
        q, kp, vp, tables, cl), iters=5)
    # yardstick: SDPA over the already gathered dense cache
    b, h, dh = q.shape
    page, kvh = kp.shape[1], kp.shape[2]
    s = tables.shape[1] * page
    tok = (tables.long() * page)[:, :, None] + torch.arange(page, device=dev)
    tok = tok.reshape(b, s)
    kd = kp.reshape(-1, kvh, dh)[tok].transpose(1, 2).contiguous()
    vd = vp.reshape(-1, kvh, dh)[tok].transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=dev)[None, :] < cl[:, None].long()
            )[:, None, None, :]
    qd = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))
    valid = float(cl.long().sum())
    n_bytes = (q.numel() * 2 + 2 * valid * kvh * dh * 2 + tables.numel() * 4
               + cl.numel() * 4 + q.numel() * 2)
    flops = 4.0 * valid * h * dh
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  paged decode: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA on gathered cache {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
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


def phase_flash(cfg, dev, gen) -> dict:
    err = 0.0
    # (S_past, start, C): a first chunk (no past), the second 512-token
    # chunk of a 1024-token prompt, and a chunk whose gathered prefix
    # carries masked rows past its start
    for s_past, start, c in ((0, 0, 512), (512, 512, 512), (512, 448, 256)):
        q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, s_past, start, c)
        got = flash_attention(q, k, v, pos, kv_pos)
        want = attention_reference(q, k, v, pos, kv_pos)
        torch.cuda.synchronize()
        err = max(err, check(f"flash prefill (bf16, C={c}, S_past={s_past}, "
                             f"start={start})", got, want, BF16_TOL))
    q, k, v, pos, kv_pos = flash_case(cfg, dev, gen, 512, 512, 512)
    ms = cuda_ms(lambda: flash_attention(q, k, v, pos, kv_pos))
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v, pos, kv_pos),
                       iters=5)
    mask = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    h, dh = q.shape[2], q.shape[3]
    pairs = float(mask.sum())
    n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + (pos.numel() + kv_pos.numel()) * 4
    flops = 4.0 * pairs * h * dh
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  flash prefill (C=512, S_past=512): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return {"name": "flash_attention_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


# --------------------------------------------------------------- phase 4

class ShapeRecordingBackend(CudaPriorityBackend):
    """The CUDA Gittins backend, noting the (n, k) of every refresh."""

    def __init__(self, device):
        super().__init__(device=device)
        self.shapes = []

    def gittins(self, support, probs, attained):
        self.shapes.append(np.shape(support))
        return super().gittins(support, probs, attained)


def make_requests(cfg, seed: int):
    """Two waves of 8 greedy requests: long prompts (512-1024 tokens,
    128-256 new) first, then short ones (32-256 tokens, 32-128 new)."""
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
                temperature=0.0, eos_token=-1))
        waves.append(wave)
    return waves


def serve(cfg, params, dev, step_mode: str, *, n_slots=8, max_seq_len=2048,
          capacity_tokens=8192, prefill_chunk=512, first_wave_steps=24,
          seed=0):
    """Serve the two waves; returns (engine, requests, seconds, backend)."""
    backend = ShapeRecordingBackend(dev)
    engine = ServingEngine(
        model=build_model(cfg),
        scheduler=Scheduler(policy=make_policy("sagesched"),
                            priority_backend=backend, bucket_size=50),
        n_slots=n_slots, max_seq_len=max_seq_len,
        capacity_tokens=capacity_tokens, prefill_chunk=prefill_chunk,
        params=params, step_mode=step_mode, seed=seed, device=dev)
    waves = make_requests(cfg, seed)
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
    return engine, reqs, seconds, backend


def phase_serve(cfg, dev) -> tuple[dict, tuple]:
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg).init(gen)
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, FLASH_PREFILL_KERNEL)
    streams, launches, max_shape = {}, {}, (0, 0)
    for mode in ("fused", "orchestrated"):
        for kern in kernels:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        engine, reqs, secs, backend = serve(cfg, params, dev, mode)
        launches[mode] = {k.symbol: k.launches for k in kernels}
        streams[mode] = [r.output_tokens for r in reqs]
        m = engine.metrics.summary(reqs)
        gen_tokens = sum(r.generated for r in reqs)
        ttft = np.array([r.ttft for r in reqs])
        ttlt = np.array([r.ttlt for r in reqs])
        print(f"  serve[{mode}] {torch.cuda.get_device_name(0)}: "
              f"{len(reqs)}/{len(reqs)} finished, {gen_tokens} tokens in "
              f"{secs:.3f} s = {gen_tokens / secs:.1f} tok/s, TTFT p50 "
              f"{np.median(ttft):.4f} s, TTLT p50 {np.median(ttlt):.4f} s, "
              f"preemptions {m['preemptions']}, swap outs {m['swap_outs']}, "
              f"swap ins {m['swap_ins']}, prefill chunks "
              f"{m['prefill_chunks']}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches {launches[mode]}")
        for shape in backend.shapes:
            if shape[0] * shape[1] > max_shape[0] * max_shape[1]:
                max_shape = shape
        missing = [s for s, n in launches[mode].items() if n == 0]
        if missing:
            raise SystemExit(f"FAIL serve[{mode}]: kernels never launched "
                             f"on the main path: {missing}")
        del engine
        torch.cuda.empty_cache()
    assert_tokens_close(streams["fused"], streams["orchestrated"])
    same = sum(a == b for a, b in zip(streams["fused"],
                                      streams["orchestrated"]))
    print(f"  fused vs orchestrated: assert_tokens_close OK, {same}/"
          f"{len(streams['fused'])} streams identical")
    total = {s: launches["fused"][s] + launches["orchestrated"][s]
             for s in launches["fused"]}
    return total, max_shape


# --------------------------------------------------------------- phase 5

def gittins_case(n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    sup = np.sort(rng.uniform(1, 1e5, (n, k)), axis=1)
    probs = rng.dirichlet(np.ones(k), n)
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)
    return sup, probs, att


def phase_gittins(dev, shape) -> dict:
    err = 0.0
    n_main, k_main = shape
    for n, k in ((max(8, n_main), max(1, k_main)), (4096, 64), (1000, 256)):
        sup, probs, att = gittins_case(n, k, seed=n + k)
        s, p, a = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                   for x in (sup, probs, att))
        got = gittins_attained(s, p, a)
        want = gittins_attained_reference(s, p, a)
        torch.cuda.synchronize()
        c = check(f"gittins (n={n}, k={k})", got, want, GITTINS_RTOL,
                  rel=True)
        err = max(err, c)
    n, k = max(8, n_main), max(1, k_main)
    sup, probs, att = gittins_case(n, k, seed=1)
    s, p, a = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
               for x in (sup, probs, att))
    ms = cuda_ms(lambda: gittins_attained(s, p, a), iters=100)
    plain_ms = cuda_ms(lambda: gittins_attained_reference(s, p, a), iters=20)
    n_bytes = (2 * n * k + 2 * n) * 4
    flops = 12.0 * n * k
    bnd, by = bound_ms(n_bytes, flops, F32_FLOPS)
    sup4, probs4, att4 = gittins_case(4096, 64, seed=2)
    s4, p4, a4 = (torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                  for x in (sup4, probs4, att4))
    ms4 = cuda_ms(lambda: gittins_attained(s4, p4, a4), iters=100)
    t0 = time.perf_counter()
    for _ in range(5):
        gittins_index_batch(sup4, probs4, att4)
    np_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  gittins (n={n}, k={k}, main path): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bnd:.6f} ms ({by}); at n=4096, k=64: "
          f"kernel {ms4:.4f} ms, numpy float64 oracle on the host "
          f"{np_ms:.3f} ms")
    return {"name": "gittins_attained", "route": "cuda",
            "source": "src/repro_torch/csrc/gittins.cu",
            "replaces": "src/repro/kernels/gittins/kernel.py:39",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def phase_trace(cfg, dev) -> None:
    """Device busy share of one fused serve drive, from a torch.profiler
    trace of the card's activity, and the largest device-time entries."""
    from torch.profiler import ProfilerActivity, profile

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, reqs, secs, _ = serve(cfg, params, dev, "fused")

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    busy_s = sum(device_us(e) for e in events) / 1e6
    print(f"  traced fused drive: wall {secs:.3f} s (profiler on), device "
          f"busy {busy_s:.3f} s = {100 * busy_s / secs:.1f}% of wall, "
          f"{sum(r.generated for r in reqs)} tokens")
    for e in events[:12]:
        print(f"    {device_us(e) / 1e3:10.3f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")


def main() -> int:
    trace = sys.argv[1:] == ["--trace"]
    if sys.argv[1:] and not trace:
        print(f"usage: {sys.argv[0]} [--trace]", file=sys.stderr)
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
    built = build_all()
    print(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.2f} "
          f"s wall (nvcc per source: "
          f"{ {k: round(v[0], 2) for k, v in built.items()} })")
    for _, log in built.values():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    cfg = get_config("llama3.2-1b")
    if trace:
        print("trace: one fused serve drive under torch.profiler")
        phase_trace(cfg, dev)
        return 0
    gen = torch.Generator(device=dev).manual_seed(1234)
    print("phase 3: attention kernels vs plain versions")
    rows = [phase_decode(cfg, dev, gen), phase_flash(cfg, dev, gen)]

    print(f"phase 4: serving {cfg.name} at full width "
          f"({cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size})")
    launches, shape = phase_serve(cfg, dev)
    print(f"phase 5: gittins kernel (largest main-path refresh {shape})")
    rows.insert(0, phase_gittins(dev, shape))
    symbols = {"gittins_attained": GITTINS_KERNEL.symbol,
               "decode_attention_paged": PAGED_DECODE_KERNEL.symbol,
               "flash_attention_prefill": FLASH_PREFILL_KERNEL.symbol}
    for row in rows:
        row["launches"] = launches[symbols[row["name"]]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
