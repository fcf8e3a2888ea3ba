"""CUDA kernels and the engine on the card: each hand-written kernel
against its plain PyTorch version(s) in bf16, and the engine's fused path
against its orchestrated path under the tolerance contract, for the dense,
SSM and hybrid families.

Every test here carries the ``gpu`` marker and skips without a card; the
check runs when the test runs, never at import or collection.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch.core as port_core
import repro_torch.serving as port_serving
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.ops import (
    PAGED_DECODE_KERNEL, decode_attention_paged_op)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_reference)
from repro_torch.kernels.flash_attention.ops import (FLASH_PREFILL_KERNEL,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.gittins.ops import (GITTINS_KERNEL,
                                             gittins_attained)
from repro_torch.kernels.gittins.ref import gittins_attained_reference
from repro_torch.kernels.ssd_scan.ops import SSD_SCAN_KERNEL, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_reference,
                                              ssd_sequential_reference)
from repro_torch.models import build_model
from repro_torch.testing import assert_tokens_close

ARCH = "llama3.2-1b"
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import/collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("s_past,start,c,window", [
    (0, 0, 200, 0), (128, 77, 64, 0), (512, 512, 512, 0), (256, 256, 128, 96),
])
def test_cuda_flash_vs_plain(cuda, s_past, start, c, window):
    g = torch.Generator(device=cuda).manual_seed(s_past + c)
    q = torch.randn(2, c, 8, 64, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, s_past + c, 2, 64, generator=g, device=cuda).bfloat16()
    v = torch.randn(2, s_past + c, 2, 64, generator=g, device=cuda).bfloat16()
    pos = (start + torch.arange(c, device=cuda)).int()
    past = torch.arange(s_past, device=cuda)
    kv_pos = torch.cat([torch.where(past < start, past, -10 ** 9),
                        pos.long()]).int()
    n0 = FLASH_PREFILL_KERNEL.launches
    got = flash_attention(q, k, v, pos, kv_pos, window=window)
    torch.cuda.synchronize()
    assert FLASH_PREFILL_KERNEL.launches == n0 + 1
    want = attention_reference(q, k, v, pos, kv_pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,window", [(64, 0), (64, 100), (128, 0)])
def test_cuda_paged_decode_vs_plain(cuda, dh, window):
    g = torch.Generator(device=cuda).manual_seed(dh + window)
    b, h, kvh, page, n_pages, p = 8, 32, 8, 16, 300, 32
    q = torch.randn(b, h, dh, generator=g, device=cuda).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    tables = torch.randint(1, n_pages, (b, p), generator=g, device=cuda,
                           dtype=torch.int32)
    cl = torch.randint(1, p * page + 1, (b,), generator=g, device=cuda,
                       dtype=torch.int32)
    n0 = PAGED_DECODE_KERNEL.launches
    got = decode_attention_paged_op(q, kp, vp, tables, cl, window=window)
    torch.cuda.synchronize()
    assert PAGED_DECODE_KERNEL.launches == n0 + 1
    want = decode_attention_paged_reference(q, kp, vp, tables, cl,
                                            window=window)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(8, 8), (100, 12), (4096, 64), (33, 256)])
def test_cuda_gittins_vs_plain(cuda, n, k):
    rng = np.random.default_rng(n + k)
    sup = np.sort(rng.uniform(1, 1e5, (n, k)), axis=1)
    probs = rng.dirichlet(np.ones(k), n)
    probs[:, k // 2:] *= rng.random(n)[:, None] > 0.5     # ragged rows
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)  # some exhausted
    args = [torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
            for x in (sup, probs, att)]
    n0 = GITTINS_KERNEL.launches
    got = gittins_attained(*args)
    torch.cuda.synchronize()
    assert GITTINS_KERNEL.launches == n0 + 1
    want = gittins_attained_reference(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,p,n,chunk,init", [
    (777, 80, 64, 128, 256, False),   # mamba2-2.7b, ragged
    (300, 64, 64, 64, 256, True),     # zamba2-1.2b, initial state
    (45, 16, 32, 16, 16, True),       # the reduced configs
])
def test_cuda_ssd_scan_vs_plain(cuda, s, h, p, n, chunk, init):
    g = torch.Generator(device=cuda).manual_seed(s + h)
    x = torch.randn(1, s, h, p, generator=g, device=cuda).bfloat16()
    dt = torch.rand(1, s, h, generator=g, device=cuda) * 0.99 + 0.01
    a = torch.rand(1, s, h, generator=g, device=cuda) * 0.499 + 0.5
    bm = (torch.randn(1, s, n, generator=g, device=cuda) * 0.5).bfloat16()
    cm = (torch.randn(1, s, n, generator=g, device=cuda) * 0.5).bfloat16()
    st = torch.randn(1, h, p, n, generator=g, device=cuda) if init else None
    n0 = SSD_SCAN_KERNEL.launches
    y, fin = ssd_scan(x, dt, a, bm, cm, st, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD_SCAN_KERNEL.launches == n0 + 1
    for ry, rst in (ssd_chunked_reference(x, dt, a, bm, cm, st, chunk=chunk),
                    ssd_sequential_reference(x, dt, a, bm, cm, st)):
        torch.testing.assert_close(y.float(), ry.float(), **BF16_TOL)
        torch.testing.assert_close(fin, rst, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_cuda_ssd_scan_long_memory_vs_plain(cuda, arch):
    """Decays near 1 (a in [0.99, 1]), as trained Mamba2 dt gives, so the
    initial state and the chunk-to-chunk carry reach the final state."""
    cfg = get_config(arch)
    s, h, p, n = 1024, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = torch.Generator(device=cuda).manual_seed(h + n)
    x = torch.randn(1, s, h, p, generator=g, device=cuda).bfloat16()
    dt = torch.rand(1, s, h, generator=g, device=cuda) * 0.99 + 0.01
    a = torch.rand(1, s, h, generator=g, device=cuda) * 0.01 + 0.99
    bm = (torch.randn(1, s, n, generator=g, device=cuda) * 0.5).bfloat16()
    cm = (torch.randn(1, s, n, generator=g, device=cuda) * 0.5).bfloat16()
    st = torch.randn(1, h, p, n, generator=g, device=cuda)
    y, fin = ssd_scan(x, dt, a, bm, cm, st, chunk=cfg.ssm_chunk)
    for ry, rst in (ssd_chunked_reference(x, dt, a, bm, cm, st,
                                          chunk=cfg.ssm_chunk),
                    ssd_sequential_reference(x, dt, a, bm, cm, st)):
        torch.testing.assert_close(y.float(), ry.float(), **BF16_TOL)
        torch.testing.assert_close(fin, rst, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_cuda_attention_kernels_at_zamba2_shapes(cuda):
    """zamba2-1.2b's shared attention block: 32 heads over 32 kv heads
    (rep = 1), dh 64; paged decode over the 2048-token table, and the
    atomic prefill's whole-prompt flash call (S_past = 0, C = 1024)."""
    cfg = get_config("zamba2-1.2b")
    h, kvh, dh, page = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    g = torch.Generator(device=cuda).manual_seed(32)
    b, p, n_pages = 8, 2048 // page, 8 * 2048 // page + 1
    q = torch.randn(b, h, dh, generator=g, device=cuda).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    tables = (torch.randperm(n_pages - 1, generator=g, device=cuda)[:b * p]
              + 1).reshape(b, p).to(torch.int32).contiguous()
    cl = torch.randint(1, p * page + 1, (b,), generator=g, device=cuda,
                       dtype=torch.int32)
    got = decode_attention_paged_op(q, kp, vp, tables, cl)
    want = decode_attention_paged_reference(q, kp, vp, tables, cl)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    c = 1024
    q = torch.randn(1, c, h, dh, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, c, kvh, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, c, kvh, dh, generator=g, device=cuda).bfloat16()
    pos = torch.arange(c, device=cuda, dtype=torch.int32)
    got = flash_attention(q, k, v, pos, pos)
    want = attention_reference(q, k, v, pos, pos)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_cuda_recurrent_engine_fused_close_to_orchestrated(cuda, arch):
    """Reduced SSM / hybrid on the card: the SSD kernel on the prefill
    path, every request finishing in both step modes, streams within the
    tolerance contract."""
    cfg = get_config(arch, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    out = {}
    for mode in ("fused", "orchestrated"):
        eng = port_serving.ServingEngine(
            model=build_model(cfg),
            scheduler=port_core.Scheduler(policy="sagesched",
                                          priority_backend="cuda",
                                          bucket_size=8),
            n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
            step_mode=mode, params=params, device=cuda)
        rng = np.random.default_rng(7)
        reqs = [port_serving.ServeRequest(
            f"r{i}", f"p{i}", [int(t) for t in rng.integers(3, 500, 12)],
            max_new_tokens=6 + 3 * i, temperature=0.0, eos_token=1)
            for i in range(4)]
        n0 = SSD_SCAN_KERNEL.launches
        eng.submit_batch(reqs)
        eng.run_until_done(max_steps=4000)
        assert SSD_SCAN_KERNEL.launches > n0
        assert all(r.state == port_serving.RequestState.FINISHED
                   for r in reqs)
        out[mode] = [r.output_tokens for r in reqs]
    assert_tokens_close(out["fused"], out["orchestrated"])


@pytest.mark.gpu
def test_cuda_engine_fused_close_to_orchestrated(cuda):
    """On the card (bf16, the three CUDA kernels): every request finishes
    in both step modes and the streams meet the tolerance contract."""
    cfg = get_config(ARCH, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    out = {}
    for mode in ("fused", "orchestrated"):
        eng = port_serving.ServingEngine(
            model=build_model(cfg),
            scheduler=port_core.Scheduler(policy="sagesched",
                                          priority_backend="cuda",
                                          bucket_size=8),
            n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
            prefill_chunk=8, max_tokens_per_step=12, step_mode=mode,
            params=params, device=cuda)
        rng = np.random.default_rng(7)
        reqs = [port_serving.ServeRequest(
            f"r{i}", f"p{i}", [int(t) for t in rng.integers(3, 500, 12)],
            max_new_tokens=6 + 3 * i, temperature=0.0, eos_token=1)
            for i in range(4)]
        eng.submit_batch(reqs)
        eng.run_until_done(max_steps=4000)
        assert all(r.state == port_serving.RequestState.FINISHED
                   for r in reqs)
        out[mode] = [r.output_tokens for r in reqs]
    assert_tokens_close(out["fused"], out["orchestrated"])
