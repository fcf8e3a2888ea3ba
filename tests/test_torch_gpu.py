"""CUDA kernels and the engine on the card: each hand-written kernel
against its plain PyTorch version(s) in bf16, the engine's fused path
against its orchestrated path under the tolerance contract, for the dense,
SSM and hybrid families, the dense-cache Model.decode_step (the
encoder-decoder, mamba2 and zamba2 held to a teacher-forced forward, and
llama3.2-1b against its paged decode), and tensor-parallel serving with
every shard on the one card (the partial (out, lse) kernel stripe by
stripe and across its sub-splits, the LSE split merged against the
unsplit kernel, exact tp = 2 token-identical to no mesh).  The flash
kernel is held at ragged query and key counts, GQA ratios 1 to 6, head
dims 64, 128 and 192, causal and not, masked prefix tiles and a
straddling window; the paged, partial and dense decode kernels at
granite-34b's 48 query heads a kv head and nemotron-4-340b's head dim
192, and across their sub-split counts.  The Gittins kernel is held at
every column instance (k2 = 8 ... 256) with n on block boundaries and past
the grid's resident rows, a row alone bit-identical to the row in its
batch; the scheduler's staged refresh bit-identical to the kernel on the
same padded inputs, with one counted launch a refresh and a staging
buffer reused across shapes.

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
    DENSE_DECODE_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
    MMA_MIN_REP, SPLIT_UNIT, SPLIT_UNITS, decode_attention_op,
    decode_attention_paged_lse_op, split_kv_sub_splits,
    decode_attention_paged_op, split_kv_head_groups, uses_tensor_cores)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_dense_reference, decode_attention_paged_lse_reference,
    decode_attention_paged_reference)
from repro_torch.kernels.flash_attention.ops import (FLASH_PREFILL_KERNEL,
                                                     FLASH_SPLIT_KERNEL,
                                                     flash_attention,
                                                     flash_key_ranges)
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.gittins.ops import (GITTINS_KERNEL, GittinsRefresh,
                                             gittins_attained, padded_rows)
from repro_torch.kernels.gittins.ref import gittins_attained_reference
from repro_torch.kernels.ssd_scan.ops import SSD_SCAN_KERNEL, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_reference,
                                              ssd_passes_reference,
                                              ssd_sequential_reference)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.attention import decode_attention_paged
from repro_torch.testing import assert_tokens_close
from repro_torch.testing.generate import (dense_cache_from_prefill,
                                          greedy_generate,
                                          teacher_forced_check)

ARCH = "llama3.2-1b"
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# q scale of a peaked draw: scores of std 3, O(1) attention outputs
PEAKED_Q = 3.0


def _attn_close(got, want):
    """An attention kernel against its plain version: BF16_TOL, with the
    absolute part capped at a tenth of want's RMS (a wide softmax over n
    keys gives outputs of about sqrt(e / n), the size of BF16_TOL)."""
    got, want = got.float(), want.float()
    rms = float(want.pow(2).mean().sqrt())
    torch.testing.assert_close(got, want, rtol=BF16_TOL["rtol"],
                               atol=min(BF16_TOL["atol"], 0.1 * rms))


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
    _attn_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("s_past,start,c", [(0, 0, 512), (512, 448, 256)])
def test_cuda_flash_head_dim_128_vs_plain(cuda, s_past, start, c):
    """qwen2-1.5b's chunked prefill shape: H12/KV2, dh 128."""
    g = torch.Generator(device=cuda).manual_seed(s_past + c + 128)
    q = torch.randn(1, c, 12, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, s_past + c, 2, 128, generator=g,
                    device=cuda).bfloat16()
    v = torch.randn(1, s_past + c, 2, 128, generator=g,
                    device=cuda).bfloat16()
    pos = (start + torch.arange(c, device=cuda)).int()
    past = torch.arange(s_past, device=cuda)
    kv_pos = torch.cat([torch.where(past < start, past, -10 ** 9),
                        pos.long()]).int()
    n0 = FLASH_PREFILL_KERNEL.launches
    got = flash_attention(q, k, v, pos, kv_pos)
    torch.cuda.synchronize()
    assert FLASH_PREFILL_KERNEL.launches == n0 + 1
    _attn_close(got, attention_reference(q, k, v, pos, kv_pos))


def _flash_case(cuda, seed, b, sq, sk, h, kvh, dh, q_scale, *, start=None,
                s_past=None):
    """q, k, v and positions: the queries at the end of the key range
    (each sees its own key), or, with s_past, a chunk of sq queries at
    ``start`` over s_past gathered prefix rows (rows >= start masked at
    -1e9) plus the chunk."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (torch.randn(b, sq, h, dh, generator=g, device=cuda)
         * q_scale).bfloat16()
    k = torch.randn(b, sk, kvh, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, sk, kvh, dh, generator=g, device=cuda).bfloat16()
    if s_past is None:
        pos = (sk - sq + torch.arange(sq, device=cuda)).int()
        kv_pos = torch.arange(sk, device=cuda, dtype=torch.int32)
    else:
        pos = (start + torch.arange(sq, device=cuda)).int()
        past = torch.arange(s_past, device=cuda)
        kv_pos = torch.cat([torch.where(past < start, past, -10 ** 9),
                            pos.long()]).int()
    return q, k, v, pos, kv_pos


@pytest.mark.gpu
@pytest.mark.parametrize("sq,rep", [(1, 1), (63, 4), (65, 6), (200, 4)])
@pytest.mark.parametrize("dh", [64, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_scale", [1.0, PEAKED_Q])
def test_cuda_flash_ragged_edges_vs_plain(cuda, sq, rep, dh, causal,
                                          q_scale):
    """The wgmma flash kernel against attention_reference: query counts
    below, at and past its 64-row tiles, 333 keys (not a multiple of the
    64-key tile: the last tile's rows are zero-filled and masked), GQA
    with rep 1, 4 and 6, every head dim, causal and not, a flat and a
    peaked draw."""
    kvh = 2
    q, k, v, pos, kv_pos = _flash_case(cuda, sq * rep + dh, 2, sq, 333,
                                       kvh * rep, kvh, dh, q_scale)
    # one launch a call: the key split for one bidirectional query
    kern = FLASH_SPLIT_KERNEL if flash_key_ranges(sq, 333, causal=causal) \
        else FLASH_PREFILL_KERNEL
    n0 = kern.launches
    got = flash_attention(q, k, v, pos, kv_pos, causal=causal)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    _attn_close(got, attention_reference(q, k, v, pos, kv_pos,
                                         causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 192])
@pytest.mark.parametrize("rep", [1, 6])
def test_cuda_flash_masked_prefix_and_window_vs_plain(cuda, dh, rep):
    """Tiles the kernel skips or masks by position: a chunk at 128 over a
    512-row prefix whose rows past 128 (six whole tiles) are masked, and
    a sliding window of 96 that straddles the key tiles."""
    q, k, v, pos, kv_pos = _flash_case(cuda, dh + rep, 1, 128, 640, 2 * rep,
                                       2, dh, 1.0, start=128, s_past=512)
    _attn_close(flash_attention(q, k, v, pos, kv_pos),
                attention_reference(q, k, v, pos, kv_pos))
    q, k, v, pos, kv_pos = _flash_case(cuda, dh * rep, 2, 300, 300, 2 * rep,
                                       2, dh, PEAKED_Q)
    _attn_close(flash_attention(q, k, v, pos, kv_pos, window=96),
                attention_reference(q, k, v, pos, kv_pos, window=96))


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 2, 8, 16])
@pytest.mark.parametrize("dh", [64, 128, 192])
@pytest.mark.parametrize("rep", [1, 6, 12])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_key_split_vs_plain(cuda, sq, dh, rep, causal):
    """Short queries: Sq 1, 2, 8 and 16 over 1500 keys (five 256-row
    sub-splits and a ragged sixth) whose first 300 rows are masked (a
    negative position, as the chunked prefill's prefix rows), so the first
    sub-split is wholly masked and the second partly; GQA ratios 1, 6 and
    12 (Sq x ratio query rows a kv head: the f32 and the tensor-core
    instances), every head dim, a flat and a peaked draw.  Bidirectional
    calls take the key split, causal ones (queries at the end of the keys)
    the prefill kernel; one launch a call."""
    kvh, sk = 2, 1500
    split = flash_key_ranges(sq, sk, causal=causal)
    assert split == (0 if causal else 6)
    for q_scale in (1.0, PEAKED_Q):
        q, k, v, pos, kv_pos = _flash_case(cuda, 7 * sq + dh + rep, 2, sq, sk,
                                           kvh * rep, kvh, dh, q_scale)
        kv_pos = torch.where(torch.arange(sk, device=cuda) < 300,
                             torch.full_like(kv_pos, -10 ** 9), kv_pos)
        n0, p0 = FLASH_SPLIT_KERNEL.launches, FLASH_PREFILL_KERNEL.launches
        got = flash_attention(q, k, v, pos, kv_pos, causal=causal)
        torch.cuda.synchronize()
        assert FLASH_SPLIT_KERNEL.launches == n0 + bool(split)
        assert FLASH_PREFILL_KERNEL.launches == p0 + (not split)
        _attn_close(got, attention_reference(q, k, v, pos, kv_pos,
                                             causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 192])
def test_cuda_flash_key_split_same_for_any_batch(cuda, dh):
    """A row's key-split result is bit-identical whether it is called
    alone (B 1) or among 8 rows: the ranges come from Sk alone (seamless's
    decode-step cross-attention, one query over 4096 frames)."""
    q, k, v, pos, kv_pos = _flash_case(cuda, 5 * dh, 8, 1, 4096, 16, 16, dh,
                                       1.0)
    assert flash_key_ranges(1, 4096) == 16
    whole = flash_attention(q, k, v, pos, kv_pos, causal=False)
    for r in (0, 5):
        one = flash_attention(q[r:r + 1].contiguous(), k[r:r + 1].contiguous(),
                              v[r:r + 1].contiguous(), pos, kv_pos,
                              causal=False)
        assert torch.equal(one, whole[r:r + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(65, 333), (200, 200), (130, 1000),
                                   (300, 77), (1000, 1000)])
@pytest.mark.parametrize("dh", [64, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_ragged_queries_and_keys_vs_plain(cuda, sq, sk, dh,
                                                     causal):
    """The prefill kernel at query and key counts that are not multiples
    of 128: a half-used second query tile, a last key tile of a few rows,
    fewer keys than queries (causal: queries at the end see every key);
    GQA 4, a peaked draw; one launch a call."""
    q, k, v, pos, kv_pos = _flash_case(cuda, sq + sk + dh, 2, sq,
                                       max(sk, sq) if causal else sk, 8, 2,
                                       dh, PEAKED_Q)
    n0 = FLASH_PREFILL_KERNEL.launches
    _attn_close(flash_attention(q, k, v, pos, kv_pos, causal=causal),
                attention_reference(q, k, v, pos, kv_pos, causal=causal))
    assert FLASH_PREFILL_KERNEL.launches == n0 + 1


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
    _attn_close(got, want)


def _paged_case(cuda, seed, h, kvh, dh, *, b=8, p=32, n_pages=300):
    """b rows of 1 .. p * 16 tokens over (b, p) tables of distinct pages
    (page 16; n_pages > b * p), row 0 at the full table."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    page = 16
    q = torch.randn(b, h, dh, generator=g, device=cuda).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    tables = (torch.randperm(n_pages - 1, generator=g, device=cuda)[:b * p]
              + 1).reshape(b, p).to(torch.int32)
    cl = torch.randint(1, p * page + 1, (b,), generator=g, device=cuda,
                       dtype=torch.int32)
    cl[0] = p * page
    return q, kp, vp, tables, cl


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,dh", [(48, 1, 128), (96, 8, 192)])
@pytest.mark.parametrize("window", [0, 100])
def test_cuda_paged_decode_large_gqa_vs_plain(cuda, h, kvh, dh, window):
    """granite-34b's MQA (48 query heads of 128 over one kv head: six head
    groups) and nemotron-4-340b's head dim 192 (12 query heads a kv head:
    three groups), with and without a window; one launch a call."""
    q, kp, vp, tables, cl = _paged_case(cuda, h + dh + window, h, kvh, dh)
    n0 = PAGED_DECODE_KERNEL.launches
    got = decode_attention_paged_op(q, kp, vp, tables, cl, window=window)
    torch.cuda.synchronize()
    assert PAGED_DECODE_KERNEL.launches == n0 + 1
    _attn_close(got, decode_attention_paged_reference(q, kp, vp, tables, cl,
                                                      window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,h,kvh,dh,window", [
    ("paged", 32, 8, 64, 0), ("paged", 32, 8, 64, 100),
    ("paged", 48, 1, 128, 0), ("paged", 96, 8, 192, 0),
    ("dense", 32, 8, 64, 0), ("dense", 48, 1, 128, 0),
    ("dense", 96, 8, 192, 0), ("dense", 16, 16, 64, 0)])
def test_cuda_split_decode_sub_splits_agree(cuda, kind, h, kvh, dh, window):
    """The split-KV paged and dense kernels through their bindings at
    every sub-split size they take (the whole table in one sub-split, 1,
    2 and 3 64-row units, the op's) against one sub-split: the same out
    up to the merge's rounding.  Rows of 1 .. 512 tokens leave sub-splits
    partly masked, fully masked, or cut by the window."""
    q, kp, vp, tables, cl = _paged_case(cuda, 5 * h + dh + window, h, kvh,
                                        dh)
    b, p = tables.shape
    stream = torch.cuda.current_stream(cuda).cuda_stream
    if kind == "paged":
        n_units = -(-p * 16 // SPLIT_UNIT)
    else:
        s_max = 300          # not a multiple of the 64- and 32-row tiles
        kp, vp = (x.reshape(-1, kvh, dh)[:b * s_max].reshape(b, s_max, kvh,
                                                              dh)
                  for x in (kp, vp))
        cl = torch.clamp(cl, max=s_max + 50)     # row 0 wraps the ring
        n_units = -(-s_max // SPLIT_UNIT)
    outs = {}
    for units in sorted({n_units, 1, 2, 3, SPLIT_UNITS}):
        n_sub = split_kv_sub_splits(n_units * SPLIT_UNIT, units)
        out = torch.empty_like(q)
        part = torch.empty(n_sub * b * h * (dh + 2), device=cuda)
        if kind == "paged":
            PAGED_DECODE_KERNEL(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                tables.data_ptr(), cl.data_ptr(),
                                out.data_ptr(), part.data_ptr(), b, h, kvh,
                                dh, 16, p, units, window, dh ** -0.5, stream)
        else:
            DENSE_DECODE_KERNEL(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                cl.data_ptr(), out.data_ptr(),
                                part.data_ptr(), b, h, kvh, dh, s_max, units,
                                dh ** -0.5, stream)
        torch.cuda.synchronize()
        outs[units] = out
    for units, out in outs.items():
        torch.testing.assert_close(out.float(), outs[n_units].float(),
                                   rtol=2e-2, atol=1e-2)
    want = (decode_attention_paged_reference(q, kp, vp, tables, cl,
                                             window=window)
            if kind == "paged" else
            decode_attention_dense_reference(q, kp, vp, cl, window=1))
    _attn_close(outs[n_units], want)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,dh", [(32, 8, 64), (48, 1, 128),
                                      (96, 8, 192)])
def test_cuda_split_decode_same_for_any_table_width_and_batch(cuda, h, kvh,
                                                             dh):
    """A row's paged decode is bit-identical whatever the table's padded
    width (the engine's fused step pads to a pow2 of the pages in use,
    its orchestrated step passes whole tables) and whichever other rows
    share the call; the dense decode's whatever the batch."""
    q, kp, vp, tables, cl = _paged_case(cuda, 7 * h + dh, h, kvh, dh)
    want = decode_attention_paged_op(q, kp, vp, tables, cl)
    for extra in (32, 96, 480):      # scratch page 0 past every cache_len
        wide = torch.nn.functional.pad(tables, (0, extra))
        assert torch.equal(decode_attention_paged_op(q, kp, vp, wide, cl),
                           want)
    assert torch.equal(decode_attention_paged_op(
        q[2:5].contiguous(), kp, vp, tables[2:5].contiguous(),
        cl[2:5].contiguous()), want[2:5])
    b = q.shape[0]
    kd, vd = (x.reshape(-1, kvh, dh)[:b * 400].reshape(b, 400, kvh, dh)
              for x in (kp, vp))
    dense = decode_attention_op(q, kd, vd, cl)
    assert torch.equal(decode_attention_op(
        q[3:].contiguous(), kd[3:], vd[3:], cl[3:].contiguous()), dense[3:])


@pytest.mark.gpu
def test_cuda_split_decode_one_launch_a_call(cuda):
    """Each decode op adds exactly 1 to its kernel's launch count per
    call, whether its kernel splits the keys (two launches: split and
    merge) or not, and nothing to the other decode kernels' counts."""
    kernels = (PAGED_DECODE_KERNEL, DENSE_DECODE_KERNEL, PAGED_LSE_KERNEL)
    for h, kvh, dh in [(32, 8, 64), (48, 1, 128), (96, 8, 192),
                       (32, 32, 64), (16, 2, 64)]:
        q, kp, vp, tables, cl = _paged_case(cuda, h * dh, h, kvh, dh, b=16,
                                            n_pages=600)
        b = q.shape[0]
        dense = kp.reshape(-1, kvh, dh)[:b * 256].reshape(b, 256, kvh, dh)
        for op, args, kern in (
                (decode_attention_paged_op, (q, kp, vp, tables, cl),
                 PAGED_DECODE_KERNEL),
                (decode_attention_paged_lse_op, (q, kp, vp, tables, cl),
                 PAGED_LSE_KERNEL),
                (decode_attention_op, (q, dense, dense, cl),
                 DENSE_DECODE_KERNEL)):
            before = [k.launches for k in kernels]
            op(*args)
            torch.cuda.synchronize()
            after = [k.launches for k in kernels]
            assert [a - b0 for a, b0 in zip(after, before)] == \
                [int(k is kern) for k in kernels]


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


def _gittins_rows(n, k, seed):
    """Sorted supports, Dirichlet probs with ragged rows, some rows
    exhausted, one all-dead conditioned row (tail 1) and one all-dead
    unconditioned row (inf)."""
    rng = np.random.default_rng(seed)
    sup = np.sort(rng.uniform(1, 1e5, (n, k)), axis=1)
    probs = rng.dirichlet(np.ones(k), n)
    probs[:, k // 2:] *= rng.random(n)[:, None] > 0.5
    att = rng.uniform(0, 2e5, n) * (rng.random(n) > 0.3)
    probs[n // 3] = 0.0
    att[n // 3] = 5.0
    if n > 1:
        probs[n - 1], att[n - 1] = 0.0, 0.0
    return sup, probs, att


def _gittins_rows_per_block(k2):
    """Rows one 256-thread block of the kernel carries: 8 warps of
    128 / min(k2, 128) rows (four columns a lane)."""
    return 8 * 128 // min(k2, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("k2", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("where", ["one", "block-1", "block", "block+1",
                                   "waves"])
def test_cuda_gittins_every_k2_vs_plain(cuda, k2, where):
    """Every kernel instance at n on block boundaries, and at n past the
    rows the card's resident blocks carry (several waves of blocks)."""
    per = _gittins_rows_per_block(k2)
    n = {"one": 1, "block-1": per - 1, "block": per, "block+1": per + 1,
         "waves": 132 * 8 * per + 77}[where]
    args = [torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
            for x in _gittins_rows(n, k2, n + k2)]
    got = gittins_attained(*args)
    want = gittins_attained_reference(*args)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("k2", [8, 16, 32, 64, 128, 256])
def test_cuda_gittins_row_alone_bit_identical_to_batch(cuda, k2):
    """A row's arithmetic depends on k2 alone: alone, it gives the bits it
    gives inside a batch of the same k2, wherever it sits in its warp."""
    n = 1000
    args = [torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
            for x in _gittins_rows(n, k2, k2)]
    batch = gittins_attained(*args)
    for r in (0, 1, 5, 17, n // 3, 517, n - 1):
        alone = gittins_attained(*(a[r:r + 1] for a in args))
        assert torch.equal(alone, batch[r:r + 1]), r


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1, 1), (8, 8), (13, 12), (1000, 20),
                                 (1024, 32), (77, 256)])
def test_cuda_staged_refresh_bit_identical_to_kernel(cuda, n, k):
    """The backend's staged refresh (one copy each way, a side stream)
    gives the bits of gittins_attained on the same padded inputs, as
    float64, with one counted launch a refresh."""
    sup, probs, att = _gittins_rows(n, k, n * k)
    backend = port_core.CudaPriorityBackend(device="cuda")
    n0 = GITTINS_KERNEL.launches
    got = backend.gittins(sup, probs, att)
    assert GITTINS_KERNEL.launches == n0 + 1
    assert got.dtype == np.float64 and got.shape == (n,)
    want = gittins_attained(*(torch.from_numpy(x).to(cuda)
                              for x in padded_rows(sup, probs, att)))[:n]
    assert np.array_equal(got, want.cpu().numpy().astype(np.float64))


@pytest.mark.gpu
def test_cuda_staged_refresh_buffer_reuse(cuda):
    """One staging pair on the card through (5, 12) -> (40, 64) -> (5, 12)
    -> (7, 16): every result has the bits of a fresh refresh's."""
    reused = GittinsRefresh(cuda)
    for i, (n, k) in enumerate([(5, 12), (40, 64), (5, 12), (7, 16)]):
        sup, probs, att = _gittins_rows(n, k, i)
        got = reused(sup, probs, att)
        assert np.array_equal(got, GittinsRefresh(cuda)(sup, probs, att))
        assert np.isfinite(got[:-1]).all()


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


def _ssd_case(dev, seed, b, s, h, p, n, init=False, a_range=(0.5, 0.999)):
    """One scan's inputs in the model path's types (x, B, C bf16; dt, a
    and the state f32)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = a_range
    x = torch.randn(b, s, h, p, generator=g, device=dev).bfloat16()
    dt = torch.rand(b, s, h, generator=g, device=dev) * 0.99 + 0.01
    a = torch.rand(b, s, h, generator=g, device=dev) * (hi - lo) + lo
    bm = (torch.randn(b, s, n, generator=g, device=dev) * 0.5).bfloat16()
    cm = (torch.randn(b, s, n, generator=g, device=dev) * 0.5).bfloat16()
    st = torch.randn(b, h, p, n, generator=g, device=dev) if init else None
    return x, dt, a, bm, cm, st


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,p,n,chunk,init,a_range", [
    (1024, 80, 64, 128, 256, True, (0.99, 1.0)),   # mamba2-2.7b
    (777, 64, 64, 64, 256, False, (0.5, 0.999)),   # zamba2-1.2b, ragged
    (45, 16, 32, 16, 16, True, (0.5, 0.999)),      # the reduced configs
])
def test_cuda_ssd_scan_vs_passes(cuda, s, h, p, n, chunk, init, a_range):
    """The kernel against the plain version of its own decomposition
    (``ssd_passes_reference``: the same passes, tiles and bf16 hi/lo
    factors) at each of its three instances."""
    x, dt, a, bm, cm, st = _ssd_case(cuda, s + n, 1, s, h, p, n, init,
                                     a_range)
    y, fin = ssd_scan(x, dt, a, bm, cm, st, chunk=chunk)
    ry, rst = ssd_passes_reference(x, dt, a, bm, cm, st, chunk=chunk)
    torch.testing.assert_close(y.float(), ry.float(), **BF16_TOL)
    torch.testing.assert_close(fin, rst, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_cuda_ssd_scan_row_independent_of_batch(cuda, arch):
    """A row's y and final state are bit-identical alone and inside a
    batch of 4 (ragged S, an initial state, long memory)."""
    cfg = get_config(arch)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dt, a, bm, cm, st = _ssd_case(cuda, 4, 4, 700, h, p, n, True,
                                     (0.99, 1.0))
    y, fin = ssd_scan(x, dt, a, bm, cm, st)
    for r in range(4):
        rows = slice(r, r + 1)
        y1, fin1 = ssd_scan(x[rows].contiguous(), dt[rows].contiguous(),
                            a[rows].contiguous(), bm[rows].contiguous(),
                            cm[rows].contiguous(), st[rows].contiguous())
        assert torch.equal(y[rows], y1) and torch.equal(fin[rows], fin1)


@pytest.mark.gpu
def test_cuda_ssd_scan_bit_identical_across_calls(cuda):
    cfg = get_config("mamba2-2.7b")
    x, dt, a, bm, cm, st = _ssd_case(cuda, 9, 1, 1024, cfg.ssm_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state, True)
    y0, fin0 = ssd_scan(x, dt, a, bm, cm, st)
    y1, fin1 = ssd_scan(x, dt, a, bm, cm, st)
    assert torch.equal(y0, y1) and torch.equal(fin0, fin1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_cuda_ssd_scan_pads_bit_unchanged(cuda, arch):
    """S = 777 against the same rows padded to 1024 as the model pads
    (dt = 0, a = 1, real x, B and C): y and the final state bit-equal."""
    cfg = get_config(arch)
    x, dt, a, bm, cm, st = _ssd_case(cuda, 777, 1, 1024, cfg.ssm_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state, True)
    dt[:, 777:], a[:, 777:] = 0.0, 1.0
    y0, s0 = ssd_scan(x[:, :777].contiguous(), dt[:, :777].contiguous(),
                      a[:, :777].contiguous(), bm[:, :777].contiguous(),
                      cm[:, :777].contiguous(), st)
    y1, s1 = ssd_scan(x, dt, a, bm, cm, st)
    assert torch.equal(y0, y1[:, :777]) and torch.equal(s0, s1)


@pytest.mark.gpu
def test_cuda_ssd_scan_counts_one_launch_per_call(cuda):
    """The kernel's four launches count as one call, padded or not."""
    x, dt, a, bm, cm, st = _ssd_case(cuda, 3, 2, 300, 16, 32, 16, True)
    n0 = SSD_SCAN_KERNEL.launches
    ssd_scan(x, dt, a, bm, cm, st, chunk=16)        # whole chunks (q 16)
    ssd_scan(x, dt, a, bm, cm, chunk=256)           # one padded chunk
    torch.cuda.synchronize()
    assert SSD_SCAN_KERNEL.launches == n0 + 2


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
    _attn_close(got, want)
    c = 1024
    q = torch.randn(1, c, h, dh, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, c, kvh, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, c, kvh, dh, generator=g, device=cuda).bfloat16()
    pos = torch.arange(c, device=cuda, dtype=torch.int32)
    got = flash_attention(q, k, v, pos, pos)
    want = attention_reference(q, k, v, pos, pos)
    _attn_close(got, want)


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


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,dh", [(32, 8, 64), (16, 16, 64),
                                      (12, 2, 128), (48, 1, 128),
                                      (96, 8, 192)])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("q_scale", [1.0, PEAKED_Q])
def test_cuda_dense_decode_vs_plain(cuda, h, kvh, dh, window, q_scale):
    """The dense-cache decode kernel: GQA, MHA, dh 128, granite's MQA
    (48 heads of 128 over one kv head, split over blocks) and nemotron's
    dh 192 (12 heads a kv head, three groups); with a ring of
    300 slots some rows have wrapped (cache_len up to S_max + 200), and
    S_max is not a multiple of the kernel's 64-row tile.  A flat draw (a
    wide softmax) and a peaked one (O(1) outputs)."""
    g = torch.Generator(device=cuda).manual_seed(h + dh + window)
    b, s_max = 8, 300
    q = (torch.randn(b, h, dh, generator=g, device=cuda)
         * q_scale).bfloat16()
    k = torch.randn(b, s_max, kvh, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, s_max, kvh, dh, generator=g, device=cuda).bfloat16()
    hi = s_max + 200 if window else s_max
    cl = torch.randint(1, hi + 1, (b,), generator=g, device=cuda,
                       dtype=torch.int32)
    cl[0], cl[1] = hi, 1
    n0 = DENSE_DECODE_KERNEL.launches
    got = decode_attention_op(q, k, v, cl, window=window)
    torch.cuda.synchronize()
    assert DENSE_DECODE_KERNEL.launches == n0 + 1
    want = decode_attention_dense_reference(q, k, v, cl, window=window)
    _attn_close(got, want)
    # a per-layer view of a stacked (L, B, S_max, KV, dh) cache, no copy
    stacked = torch.stack([k, k])
    got = decode_attention_op(q, stacked[1], torch.stack([v, v])[1], cl,
                              window=window)
    _attn_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq", [(1, 4096), (8, 128), (8, 1)])
@pytest.mark.parametrize("q_scale", [1.0, PEAKED_Q])
def test_cuda_flash_noncausal_at_seamless_shapes(cuda, b, sq, q_scale):
    """Bidirectional flash at seamless-m4t-medium's shapes (H16/KV16, dh
    64, 4096 encoder frames): encoder self-attention, a prompt's
    cross-attention and one decode step's; a flat and a peaked draw."""
    cfg = get_config("seamless-m4t-medium")
    h, kvh, dh, sk = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4096
    g = torch.Generator(device=cuda).manual_seed(b + sq)
    q = (torch.randn(b, sq, h, dh, generator=g, device=cuda)
         * q_scale).bfloat16()
    k = torch.randn(b, sk, kvh, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, sk, kvh, dh, generator=g, device=cuda).bfloat16()
    pos = torch.arange(sq, device=cuda, dtype=torch.int32)
    kv_pos = torch.arange(sk, device=cuda, dtype=torch.int32)
    # one launch a call, of the key split for the decode step (Sq 1)
    kern = FLASH_SPLIT_KERNEL if flash_key_ranges(sq, sk) \
        else FLASH_PREFILL_KERNEL
    assert (kern is FLASH_SPLIT_KERNEL) == (sq == 1)
    n0 = (FLASH_PREFILL_KERNEL.launches, FLASH_SPLIT_KERNEL.launches)
    got = flash_attention(q, k, v, pos, kv_pos, causal=False)
    torch.cuda.synchronize()
    assert FLASH_PREFILL_KERNEL.launches + FLASH_SPLIT_KERNEL.launches \
        == sum(n0) + 1
    assert kern.launches == n0[kern is FLASH_SPLIT_KERNEL] + 1
    want = attention_reference(q, k, v, pos, kv_pos, causal=False)
    _attn_close(got, want)


@pytest.mark.gpu
def test_cuda_encdec_decode_matches_forward(cuda):
    """seamless-m4t-medium at full width, cut to 2 encoder and 2 decoder
    layers: 1024 frames, 64-token prompts, 32 greedy decode steps over a
    dense cache, held to a teacher-forced forward under the tolerance
    contract, through the dense-decode and flash kernels."""
    cfg = get_config("seamless-m4t-medium").with_overrides(
        n_layers=2, n_encoder_layers=2)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = build_model(cfg)
    params = model.init(g)
    b, prompt, steps = 4, 64, 32
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (b, prompt),
                                     generator=g, device=cuda),
             "frames": (torch.randn(b, 1024, cfg.d_model, generator=g,
                                    device=cuda) * 0.02).bfloat16()}
    n_dense, n_flash, n_split = DENSE_DECODE_KERNEL.launches, \
        FLASH_PREFILL_KERNEL.launches, FLASH_SPLIT_KERNEL.launches
    run = greedy_generate(model, params, batch, 128, steps)
    assert run["finite"]
    assert DENSE_DECODE_KERNEL.launches - n_dense == steps * 2
    # encoder 2, decoder self 2, prefill cross 2; one cross per step-layer
    # (one query over 1024 frames: the key split)
    assert FLASH_PREFILL_KERNEL.launches - n_flash == 6
    assert FLASH_SPLIT_KERNEL.launches - n_split == steps * 2
    stats = teacher_forced_check(model, params, batch, run, "encdec")
    assert stats["positions"] == b * (steps + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cut", [
    ("mamba2-2.7b", dict(n_layers=2)),
    ("zamba2-1.2b", dict(n_layers=2, hybrid_attn_every=1))])
def test_cuda_recurrent_dense_decode_matches_forward(cuda, arch, cut):
    """The SSM and hybrid families at full width, cut to 2 layers (zamba2
    with the shared attention after each: two group layers, two KV views
    through the dense-decode kernel; at random weights bf16 rounding
    differences grow with Mamba2 depth, so deeper cuts stop being
    comparable, see chip_smoke.py): 64-token prompts, 32 greedy steps
    over the dense cache, the recurrent state updated in place, held to
    a teacher-forced forward under the tolerance contract."""
    cfg = get_config(arch).with_overrides(**cut)
    g = torch.Generator(device=cuda).manual_seed(2)
    model = build_model(cfg)
    params = model.init(g)
    b, prompt, steps = 4, 64, 32
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (b, prompt),
                                     generator=g, device=cuda)}
    groups = -(-cfg.n_layers // cfg.hybrid_attn_every) \
        if cfg.family == "hybrid" else 0
    n0 = (DENSE_DECODE_KERNEL.launches, FLASH_PREFILL_KERNEL.launches,
          SSD_SCAN_KERNEL.launches)
    run = greedy_generate(model, params, batch, 128, steps)
    assert run["finite"]
    assert DENSE_DECODE_KERNEL.launches - n0[0] == steps * groups
    assert FLASH_PREFILL_KERNEL.launches - n0[1] == groups
    assert SSD_SCAN_KERNEL.launches - n0[2] == cfg.n_layers
    stats = teacher_forced_check(model, params, batch, run, arch)
    assert stats["positions"] == b * (steps + 1)


@pytest.mark.gpu
def test_cuda_dense_cache_decode_matches_paged(cuda):
    """llama3.2-1b at full width, cut to 4 layers: from one prefill, 16
    steps over the dense cache and over the paged pool (block tables of
    16-token pages), both fed the dense path's greedy tokens, give logits
    within the tolerance contract's max_logit_diff (5e-2)."""
    cfg = get_config(ARCH).with_overrides(n_layers=4)
    g = torch.Generator(device=cuda).manual_seed(1)
    model = build_model(cfg)
    params = model.init(g)
    b, prompt, page, steps = 4, 100, 16, 16
    tokens = torch.randint(3, cfg.vocab_size, (b, prompt), generator=g,
                           device=cuda)
    last, pre = model.prefill(params, {"tokens": tokens})
    dense = dense_cache_from_prefill(model, pre, b, 128)
    p_max = 128 // page
    paged = model.init_paged_cache(b * p_max + 1, page, b, device=cuda)
    tables = (torch.arange(b * p_max, device=cuda, dtype=torch.int32)
              .reshape(b, p_max) + 1).contiguous()
    for name in ("k", "v"):
        flat = paged[name].view(cfg.n_layers, -1, cfg.n_kv_heads,
                                cfg.head_dim)
        for r in range(b):
            pos = torch.arange(prompt, device=cuda)
            slot = tables[r, pos // page].long() * page + pos % page
            flat[:, slot] = pre[name][:, r]
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    n0 = DENSE_DECODE_KERNEL.launches
    for i in range(steps):
        cl = torch.full((b,), prompt + i, dtype=torch.int32, device=cuda)
        ld, dense = model.decode_step(params, tok, dense, cl)
        lp, paged = model.decode_step_paged(params, tok, paged, cl, tables,
                                            page_size=page)
        torch.testing.assert_close(ld.float(), lp.float(), rtol=0,
                                   atol=5e-2)
        tok = torch.argmax(ld, dim=-1).to(torch.int32)[:, None]
    assert DENSE_DECODE_KERNEL.launches - n0 == steps * cfg.n_layers


def _lse_case(cuda, h, kvh, dh, seed):
    """8 rows of 1..512 tokens over 32-page tables (page 16)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, page, p, n_pages = 8, 16, 32, 300
    q = torch.randn(b, h, dh, generator=g, device=cuda).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    tables = (torch.randperm(n_pages - 1, generator=g, device=cuda)[:b * p]
              + 1).reshape(b, p).to(torch.int32)
    cl = torch.tensor([1, 17, 100, 128, 129, 300, 480, 512],
                      dtype=torch.int32, device=cuda)
    return q, kp, vp, tables, cl


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,dh", [(12, 2, 128), (32, 8, 64),
                                      (48, 1, 128), (96, 8, 192)])
@pytest.mark.parametrize("window", [0, 150])
def test_cuda_paged_lse_vs_plain(cuda, h, kvh, dh, window):
    """Each of 4 stripes: out (BF16 bar) and lse (1e-4) against the plain
    version; a fully masked stripe gives out 0 and lse <= -1e29, never
    NaN; one launch a call."""
    q, kp, vp, tables, cl = _lse_case(cuda, h, kvh, dh, h + window)
    for s in range(4):
        bt = tables[:, s * 8:(s + 1) * 8]
        cls = torch.clamp(cl - s * 128, min=0)
        n0 = PAGED_LSE_KERNEL.launches
        out, lse = decode_attention_paged_lse_op(q, kp, vp, bt, cls,
                                                 window=window)
        torch.cuda.synchronize()
        assert PAGED_LSE_KERNEL.launches == n0 + 1
        want_o, want_l = decode_attention_paged_lse_reference(
            q, kp, vp, bt, cls, window=window)
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
        # a row sees positions [cls - window, cls) of the stripe's 128
        lo = torch.clamp(cls - window, min=0) if window else 0 * cls
        live = torch.clamp(cls, max=128) > lo
        _attn_close(out[live], want_o[live])
        torch.testing.assert_close(lse[live], want_l[live], rtol=1e-4,
                                   atol=1e-4)
        if bool((~live).any()):
            assert float(out[~live].float().abs().max()) == 0.0
            assert float(lse[~live].max()) <= -1e29


@pytest.mark.gpu
@pytest.mark.parametrize("n_splits", [2, 4])
def test_cuda_paged_split_merged_equals_unsplit(cuda, n_splits):
    """decode_attention_paged(n_splits): one partial launch per stripe,
    merged by combine_lse_partials, against the unsplit paged kernel and
    the plain version."""
    q, kp, vp, tables, cl = _lse_case(cuda, 12, 2, 128, n_splits)
    n0, p0 = PAGED_LSE_KERNEL.launches, PAGED_DECODE_KERNEL.launches
    merged = decode_attention_paged(q[:, None], kp, vp, tables, cl,
                                    n_splits=n_splits)[:, 0]
    whole = decode_attention_paged(q[:, None], kp, vp, tables, cl)[:, 0]
    torch.cuda.synchronize()
    assert PAGED_LSE_KERNEL.launches == n0 + n_splits
    assert PAGED_DECODE_KERNEL.launches == p0 + 1
    _attn_close(merged, whole)
    _attn_close(merged, decode_attention_paged_reference(q, kp, vp, tables,
                                                         cl))


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,dh", [(12, 2, 128), (32, 8, 64),
                                      (48, 1, 128)])
@pytest.mark.parametrize("window", [0, 150])
def test_cuda_paged_lse_sub_splits_agree(cuda, h, kvh, dh, window):
    """The split across blocks: the op's sub-split size (SPLIT_UNITS
    64-row units: two sub-splits of the 32-page tables) and every other
    size the kernel takes (the whole table in one, one and three units),
    through the binding, give the same out and lse up to the merge's
    rounding.  The 8 rows of 1 to 512 tokens over 32 pages leave
    sub-splits partly masked, fully masked, or cut by the window."""
    q, kp, vp, tables, cl = _lse_case(cuda, h, kvh, dh, 3 * h + window)
    b, p = tables.shape
    assert split_kv_sub_splits(p * 16) > 1
    want_o, want_l = decode_attention_paged_lse_op(q, kp, vp, tables, cl,
                                                   window=window)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for units in (p * 16 // SPLIT_UNIT, 3, 1):
        n_sub = split_kv_sub_splits(p * 16, units)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, device=cuda)
        part = torch.empty(n_sub * b * h * (dh + 2), device=cuda)
        PAGED_LSE_KERNEL(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         tables.data_ptr(), cl.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), part.data_ptr(), b, h, kvh, dh, 16,
                         p, units, window, dh ** -0.5, stream)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want_o.float(), rtol=2e-2,
                                   atol=1e-2)
        torch.testing.assert_close(lse, want_l, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,dh", [(12, 2, 128), (32, 8, 64),
                                      (48, 1, 128), (96, 8, 192)])
@pytest.mark.parametrize("page", [16, 24])
def test_cuda_paged_lse_same_for_any_table_width_and_batch(cuda, h, kvh, dh,
                                                          page):
    """A row's partial (out, lse) is bit-identical whatever the stripe
    table's padded width (the fused step pads tables to a pow2 of the
    pages in use, the orchestrated step passes them whole) and whichever
    other rows share the call: the kernel cuts fixed 64-row units from
    the row's first, never a count from the batch, the width or the
    card.  A page of 24 rows straddles the 256-row boundaries; the rows
    of the other sub-split are masked there."""
    g = torch.Generator(device=cuda).manual_seed(11 * h + dh + page)
    b, p, n_pages = 8, 24, 300
    q = torch.randn(b, h, dh, generator=g, device=cuda).bfloat16()
    kp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn(n_pages, page, kvh, dh, generator=g,
                     device=cuda).bfloat16()
    tables = (torch.randperm(n_pages - 1, generator=g, device=cuda)[:b * p]
              + 1).reshape(b, p).to(torch.int32)
    cl = torch.tensor([0, 1, 100, 255, 256, 257, 300, p * page],
                      dtype=torch.int32, device=cuda)
    want_o, want_l = decode_attention_paged_lse_op(q, kp, vp, tables, cl)
    for extra in (8, 40, 104):       # scratch page 0 past every cache_len
        wide = torch.nn.functional.pad(tables, (0, extra))
        got_o, got_l = decode_attention_paged_lse_op(q, kp, vp, wide, cl)
        assert torch.equal(got_o, want_o) and torch.equal(got_l, want_l)
    got_o, got_l = decode_attention_paged_lse_op(
        q[3:6].contiguous(), kp, vp, tables[3:6].contiguous(),
        cl[3:6].contiguous())
    assert torch.equal(got_o, want_o[3:6]) and torch.equal(got_l, want_l[3:6])
    ref_o, ref_l = decode_attention_paged_lse_reference(q, kp, vp, tables, cl)
    live = cl > 0
    _attn_close(want_o[live], ref_o[live])
    torch.testing.assert_close(want_l[live], ref_l[live], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("rep,kvh", [(8, 2), (12, 8), (48, 1)])
@pytest.mark.parametrize("dh", [64, 128, 192])
@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("q_scale", [1.0, PEAKED_Q])
def test_cuda_decode_tensor_cores_vs_plain(cuda, rep, kvh, dh, kind,
                                           q_scale):
    """The split-KV decode at H / KV >= 8 (the tensor-core instance, one
    block a kv head): 8, 12 and 48 query heads a kv head at every head
    dim, paged (rows of 1 .. 512 over 32-page tables, a window of 100) and
    dense (300 slots, row 0 wrapping the ring), a flat and a peaked draw,
    against the plain version; one launch a call."""
    h = rep * kvh
    assert uses_tensor_cores(rep) and split_kv_head_groups(rep, dh) == (1, rep)
    q, kp, vp, tables, cl = _paged_case(cuda, 13 * h + dh + int(q_scale), h,
                                        kvh, dh)
    q = (q.float() * q_scale).bfloat16()
    if kind == "paged":
        kern = PAGED_DECODE_KERNEL
        n0 = kern.launches
        for window in (0, 100):
            got = decode_attention_paged_op(q, kp, vp, tables, cl,
                                            window=window)
            _attn_close(got, decode_attention_paged_reference(
                q, kp, vp, tables, cl, window=window))
        want_calls = 2
    else:
        b = q.shape[0]
        kd, vd = (x.reshape(-1, kvh, dh)[:b * 300].reshape(b, 300, kvh, dh)
                  for x in (kp, vp))
        cl = torch.clamp(cl, max=350)
        kern = DENSE_DECODE_KERNEL
        n0 = kern.launches
        got = decode_attention_op(q, kd, vd, cl)
        _attn_close(got, decode_attention_dense_reference(q, kd, vd, cl,
                                                          window=1))
        want_calls = 1
    torch.cuda.synchronize()
    assert kern.launches == n0 + want_calls


def _tp_engine_run(cuda, cfg, params, tp=None, parallel="exact",
                   step_mode="fused"):
    eng = port_serving.ServingEngine(
        model=build_model(cfg),
        scheduler=port_core.Scheduler(policy="sagesched",
                                      priority_backend="cuda",
                                      bucket_size=8),
        n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
        prefill_chunk=8, max_tokens_per_step=12, step_mode=step_mode,
        params=params, device=cuda, parallel=parallel,
        mesh=None if tp is None else make_local_mesh(
            tp=tp, devices=[cuda] * tp))
    rng = np.random.default_rng(7)
    reqs = [port_serving.ServeRequest(
        f"r{i}", f"p{i}", [int(t) for t in rng.integers(3, 500, 12)],
        max_new_tokens=6 + 3 * i, temperature=0.0, eos_token=1)
        for i in range(4)]
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=4000)
    assert all(r.state == port_serving.RequestState.FINISHED for r in reqs)
    return eng, [r.output_tokens for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_cuda_engine_tp2_exact_token_identical(cuda, step_mode):
    """A reduced qwen2-1.5b, exact tp = 2 with both shards on the card:
    the pool's kv-head slices, one paged launch per layer and shard, and
    streams token-identical to the engine without a mesh."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    _, want = _tp_engine_run(cuda, cfg, params, step_mode=step_mode)
    n0 = PAGED_DECODE_KERNEL.launches
    eng, got = _tp_engine_run(cuda, cfg, params, tp=2, step_mode=step_mode)
    assert got == want
    assert eng.metrics.preemptions > 0
    assert PAGED_DECODE_KERNEL.launches - n0 \
        == cfg.n_layers * 2 * eng.metrics.decode_iterations


@pytest.mark.gpu
def test_cuda_engine_lse_split_launches(cuda):
    """Efficient tp = 4 over 6 kv heads on the card: the LSE split, one
    partial launch per layer and stripe each decode call, no paged
    launch, every request finishing."""
    cfg = get_config("qwen2-1.5b", reduced=True).with_overrides(
        n_heads=6, n_kv_heads=6)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    n0, p0 = PAGED_LSE_KERNEL.launches, PAGED_DECODE_KERNEL.launches
    eng, _ = _tp_engine_run(cuda, cfg, params, tp=4, parallel="efficient")
    assert eng.sharding_report()["attention"] == "lse-split"
    assert PAGED_LSE_KERNEL.launches - n0 \
        == cfg.n_layers * 4 * eng.metrics.decode_iterations
    assert PAGED_DECODE_KERNEL.launches == p0


# ------------------------------------------- decode steps as CUDA graphs

ENGINE_KERNELS = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
                  FLASH_PREFILL_KERNEL, SSD_SCAN_KERNEL)


def _graph_drive(cuda, cfg, params, *, graphs, step_mode, temperature,
                 decode_steps=1, tp=None, parallel="exact"):
    """The reduced engine drive of ``_tp_engine_run`` (sampled at
    ``temperature``), with the launches of every engine kernel."""
    before = [k.launches for k in ENGINE_KERNELS]
    dense = cfg.family == "dense"
    eng = port_serving.ServingEngine(
        model=build_model(cfg),
        scheduler=port_core.Scheduler(policy="sagesched",
                                      priority_backend="cuda",
                                      bucket_size=8),
        n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
        prefill_chunk=8 if dense else None,
        max_tokens_per_step=12 if dense else None, step_mode=step_mode,
        decode_steps=decode_steps, params=params, device=cuda,
        parallel=parallel, graphs=graphs,
        mesh=None if tp is None else make_local_mesh(
            tp=tp, devices=[cuda] * tp))
    rng = np.random.default_rng(7)
    reqs = [port_serving.ServeRequest(
        f"r{i}", f"p{i}", [int(t) for t in rng.integers(3, 500, 12)],
        max_new_tokens=6 + 3 * i, temperature=temperature, eos_token=1)
        for i in range(4)]
    eng.submit_batch(reqs)
    eng.run_until_done(max_steps=4000)
    torch.cuda.synchronize()
    assert all(r.state == port_serving.RequestState.FINISHED for r in reqs)
    launches = {k.symbol: k.launches - n
                for k, n in zip(ENGINE_KERNELS, before)}
    return eng, [r.output_tokens for r in reqs], launches


def _hold_graphed_to_eager(cuda, cfg, params, **kw):
    """Graphed and eager drives of the same mix: token-identical streams,
    the same launches of every kernel (replays add what their captures
    counted), one graph a key, each replayed, within the compile bound."""
    eager, want, want_launches = _graph_drive(cuda, cfg, params,
                                              graphs=False, **kw)
    eng, got, launches = _graph_drive(cuda, cfg, params, graphs=True, **kw)
    assert got == want
    assert launches == want_launches
    assert eager.graphs_captured == 0
    runners = list(eng._fused_runners.values())
    if eng._orchestrated_runner is not None:
        runners.append(eng._orchestrated_runner)
    assert all(r.captured for r in runners)
    assert eng.graphs_captured == len(runners) > 0
    assert sum(r.calls for r in runners) > len(runners)     # replays ran
    assert eng.fused_compile_count == eager.fused_compile_count \
        <= eng.max_fused_compiles()
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("step_mode,decode_steps", [
    ("fused", 1), ("fused", 4), ("orchestrated", 1)])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_graphed_decode_equals_eager(cuda, arch, step_mode,
                                          decode_steps, temperature):
    """Reduced dense, SSM and hybrid engines: the decode steps replayed
    from CUDA graphs give the eager (graphs=False) streams token for
    token, greedy and sampled, with the eager launch counts."""
    cfg = get_config(arch, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    _hold_graphed_to_eager(cuda, cfg, params, step_mode=step_mode,
                           decode_steps=decode_steps,
                           temperature=temperature)


@pytest.mark.gpu
@pytest.mark.parametrize("tp,parallel", [(2, "exact"), (2, "efficient"),
                                         (4, "efficient")])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_graphed_decode_equals_eager_under_plans(cuda, tp, parallel,
                                                      step_mode,
                                                      temperature):
    """A reduced qwen2-1.5b with every shard on the card: each plan's
    per-shard loops, psums and vocab-sharded sampling captured whole
    (tp 4 efficient over 6 kv heads: the LSE split) give the eager
    streams and launch counts."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    if tp == 4:
        cfg = cfg.with_overrides(n_heads=6, n_kv_heads=6)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    eng = _hold_graphed_to_eager(cuda, cfg, params, step_mode=step_mode,
                                 temperature=temperature, tp=tp,
                                 parallel=parallel)
    assert eng.sharding_report()["attention"] == (
        "lse-split" if tp == 4 else "sharded")


@pytest.mark.gpu
def test_cuda_compile_bound_under_churn(cuda):
    """tests/test_torch_graphs.py's wide churn workload on the card: one
    graph a fused key, within ``max_fused_compiles()``, and a second wave
    of the same shapes captures nothing."""
    cfg = get_config(ARCH, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    o = port_core.OraclePredictor()
    eng = port_serving.ServingEngine(
        model=build_model(cfg),
        scheduler=port_core.Scheduler(policy="sagesched", predictor=o,
                                      priority_backend="cuda"),
        n_slots=12, max_seq_len=96, capacity_tokens=480, block_size=8,
        seed=0, params=params, device=cuda)
    counts = []
    for tag in ("a", "b"):
        rng = np.random.default_rng(11)
        reqs = []
        for i in range(12):
            new = 3 + (i * 5 % 30)
            o.register(f"{tag}{i}", port_core.LengthDistribution(
                np.array([new]), np.array([1.0])))
            reqs.append(port_serving.ServeRequest(
                f"{tag}{i}", f"{tag}{i}", [int(t) for t in rng.integers(
                    3, cfg.vocab_size, int(rng.integers(4, 60)))],
                max_new_tokens=new, temperature=0.8 if i % 3 == 0 else 0.0,
                eos_token=-1, arrival=float(i) * 1e-3))
        eng.submit_batch(reqs)
        eng.run_until_done(max_steps=8000)
        counts.append((eng.fused_compile_count, eng.graphs_captured))
    assert counts[0] == counts[1]
    assert 1 < counts[0][0] == counts[0][1] <= eng.max_fused_compiles()


@pytest.mark.gpu
def test_cuda_graphed_engines_leave_no_memory_behind(cuda):
    """Engines that captured graphs free everything when dropped: their
    graph pools, static buffers and runners (the first calls and captures
    of every engine share one side stream a card, so cuBLAS keeps one
    workspace for it, not one per engine)."""
    import gc
    cfg = get_config(ARCH, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))

    def drive():
        eng, _, _ = _graph_drive(cuda, cfg, params, graphs=True,
                                 step_mode="fused", temperature=0.8)
        assert eng.graphs_captured > 0
        del eng
        gc.collect()
        torch.cuda.synchronize()

    drive()
    base = torch.cuda.memory_allocated(cuda)
    for _ in range(3):
        drive()
    assert torch.cuda.memory_allocated(cuda) - base < 1 << 20


@pytest.mark.gpu
def test_cuda_capture_failure_raises(cuda):
    """A step that fails in its capture raises from the call; nothing
    falls back to the eager step, and the launches counted in the failed
    capture are withheld."""
    from repro_torch.serving.step_graphs import StepGraphs, StepRunner
    runner = StepRunner(StepGraphs(cuda, True), {"a": ((4,), torch.int64)})
    n0 = PAGED_DECODE_KERNEL.launches

    def step(x):
        PAGED_DECODE_KERNEL.launches += 1
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("this step cannot be captured")
        return x["a"] * 2

    with pytest.raises(RuntimeError, match="cannot be captured"):
        runner(step, a=np.arange(4))
    assert not runner.captured
    # the eager first call counted its launch; the capture's is withheld
    assert PAGED_DECODE_KERNEL.launches == n0 + 1
