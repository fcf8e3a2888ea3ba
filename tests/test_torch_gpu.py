"""CUDA kernels and the engine on the card: each hand-written kernel
against its plain PyTorch version(s) in bf16, the engine's fused path
against its orchestrated path under the tolerance contract, for the dense,
SSM and hybrid families, the MoE FFN against its CPU run, the dense-cache
Model.decode_step (the
encoder-decoder, mamba2 and zamba2 held to a teacher-forced forward, and
llama3.2-1b against its paged decode), and tensor-parallel serving with
every shard on the one card (the partial (out, lse) kernel stripe by
stripe and across its sub-splits, the LSE split merged against the
unsplit kernel, exact tp = 2 token-identical to no mesh, for the MoE
family with its experts sharded too).  The flash
kernel is held at ragged query and key counts, GQA ratios 1 to 6, head
dims 64, 128 and 192, causal and not, masked prefix tiles and a
straddling window; the paged, partial and dense decode kernels at
granite-34b's 48 query heads a kv head and nemotron-4-340b's head dim
192, and across their sub-split counts.  The Gittins kernel is held at
every column instance (k2 = 8 ... 256) with n on block boundaries and past
the grid's resident rows, a row alone bit-identical to the row in its
batch; the scheduler's staged refresh bit-identical to the kernel on the
same padded inputs, with one counted launch a refresh and a staging
buffer reused across shapes.  Prefix sharing is held ON == OFF under the
decode steps' CUDA graphs (multi-turn sessions, a cached-tier
re-adoption, preemption of requests holding adopted blocks), and a
Gateway deadline abort leaves a graphed engine quiesced.  The decode
steps of the dense, MoE, VLM, SSM and hybrid engines are held graphed
against eager (the MoE FFN captures: it reads nothing back to the host),
with and without a plan.  The SSD scan's backward kernel is held to its
plain version, and reduced-depth mamba2 and zamba2 gradients on the card
to the CPU's, a check shown failing with the scan's gradient zeroed.

The sampling kernel (the fused step's threefry categorical) is held to
its plain version on the card, with a vocab shard's offset, on hand-made
rows (NaN, -inf, +inf, ties), at 256 lanes in bf16 and f32 and on
unaligned rows; one call is one kernel node of a CUDA graph, graphed as
eager; its division and noise are the library's bit for bit over every
input; and a graphed sampled drive at the paper's temperature is held to
its eager twin.

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
import repro_torch.testing as port_testing
from repro_torch.configs import get_config
from repro_torch.kernels.categorical.ops import (CATEGORICAL_KERNEL,
                                                 categorical, prng_key)
from repro_torch.kernels.categorical.ref import \
    categorical as categorical_reference
from repro_torch.kernels.categorical.ref import gumbel, lane_keys
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
from repro_torch.models.layers import init_from_template
from repro_torch.models.moe import moe_ffn, moe_template
from repro_torch.testing import assert_tokens_close
from repro_torch.testing.sampling import edge_rows
from repro_torch.testing.generate import (dense_cache_from_prefill,
                                          greedy_generate,
                                          teacher_forced_check)
from torch_sessions import session_drive

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
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_cuda_engine_moe_tp2_exact_token_identical(cuda, step_mode):
    """A reduced olmoe-1b-7b, exact tp = 2 with both shards on the card:
    each shard runs its two experts in GEMM calls of the unsharded path's
    shape, and the streams are token-identical to the engine without a
    mesh."""
    cfg = get_config("olmoe-1b-7b", reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    _, want = _tp_engine_run(cuda, cfg, params, step_mode=step_mode)
    n0 = PAGED_DECODE_KERNEL.launches
    eng, got = _tp_engine_run(cuda, cfg, params, tp=2, step_mode=step_mode)
    assert got == want
    assert eng.metrics.preemptions > 0
    assert eng.sharding_report()["experts"] == "sharded"
    assert eng.params[1]["layers"]["moe"]["w_in"].shape[1] \
        == cfg.n_experts // 2
    assert PAGED_DECODE_KERNEL.launches - n0 \
        == cfg.n_layers * 2 * eng.metrics.decode_iterations


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("n,decode", [(8, True), (256, False)])
def test_cuda_moe_ffn_vs_cpu(cuda, arch, n, decode):
    """One MoE layer at full width on the card against the same call on
    a CPU copy of its weights and input: the same experts (the f32 router
    product), outputs within BF16_TOL."""
    cfg = get_config(arch)
    params = init_from_template(moe_template(cfg),
                                torch.Generator(device=cuda).manual_seed(3))
    x = torch.randn((1, n, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda).bfloat16()
    got, aux = moe_ffn(params, x, cfg, decode=decode)
    cpu = {k: (v.cpu() if torch.is_tensor(v)
               else {kk: vv.cpu() for kk, vv in v.items()})
           for k, v in params.items()}
    want, want_aux = moe_ffn(cpu, x.cpu(), cfg, decode=decode)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-6)


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


# ------------------------------------------------ the categorical draw

# the card's IEEE logf and torch's log on the card: expected bit-equal; a
# token may differ only where the plain version's two best scores lie
# within this fraction of max(1, |best|)
NEAR_TIE = 4e-6


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,vocab,offset,dtype", [
    (3, 1000, 0, torch.float32), (16, 50304, 0, torch.bfloat16),
    (8, 32064, 3 * 32064, torch.bfloat16)])
def test_cuda_categorical_vs_plain(cuda, lanes, vocab, offset, dtype):
    """The kernel against its plain version on the same card tensors:
    mixed greedy and sampled lanes, request seeds up to 2**32 - 1, one
    vocab shard at its offset; the values bit-equal where the tokens
    are."""
    gen = torch.Generator(device=cuda).manual_seed(lanes)
    logits = (torch.randn(lanes, vocab, generator=gen, device=cuda)
              * 3).to(dtype)
    temps = torch.tensor([0.6, 1.0, 0.3] * lanes, device=cuda)[:lanes]
    greedy = torch.arange(lanes, device=cuda) % 4 == 1
    safe_t = torch.where(greedy, torch.ones_like(temps), temps)
    seeds = torch.tensor([0, 2**32 - 1, 12345, 2**31] * lanes,
                         device=cuda)[:lanes]
    counters = torch.arange(lanes, device=cuda) * 97
    args = (logits, safe_t, greedy, prng_key(5), seeds, counters)
    before = CATEGORICAL_KERNEL.launches
    v, i = categorical(*args, offset=offset)
    torch.cuda.synchronize()
    assert CATEGORICAL_KERNEL.launches == before + 1
    want_v, want_i = categorical_reference(*args, offset=offset)
    same = i == want_i
    assert torch.equal(v[same], want_v[same])
    for lane in torch.nonzero(~same).flatten().tolist():
        score = logits[lane].float()
        if not greedy[lane]:
            keys = lane_keys(prng_key(5), seeds[lane:lane + 1],
                             counters[lane:lane + 1])
            score = score / safe_t[lane] + gumbel(keys, vocab, offset)[0]
        top2 = score.topk(2).values
        assert float(top2[0] - top2[1]) <= NEAR_TIE * max(
            1.0, abs(float(top2[0])))
    v2, i2 = categorical(*args, offset=offset)
    assert torch.equal(v, v2) and torch.equal(i, i2)       # deterministic


def _hold_draw_to_plain(args, offset=0):
    """The kernel's draw against the plain version's on the same card
    tensors, with one counted launch: tokens equal but on a near tie of the
    plain scores, values bit-equal (NaN where the plain value is NaN) where
    the tokens are.  Returns the kernel's (value, index)."""
    before = CATEGORICAL_KERNEL.launches
    v, i = categorical(*args, offset=offset)
    torch.cuda.synchronize()
    assert CATEGORICAL_KERNEL.launches == before + 1
    want_v, want_i = categorical_reference(*args, offset=offset)
    same = i == want_i
    torch.testing.assert_close(v[same], want_v[same], rtol=0, atol=0,
                               equal_nan=True)
    logits, safe_t, greedy, base, seeds, counters = args
    for lane in torch.nonzero(~same).flatten().tolist():
        score = logits[lane].float()
        if not greedy[lane]:
            keys = lane_keys(base, seeds[lane:lane + 1],
                             counters[lane:lane + 1])
            score = score / safe_t[lane] + gumbel(
                keys, logits.shape[1], offset)[0]
        top2 = score.topk(2).values
        assert float(top2[0] - top2[1]) <= NEAR_TIE * max(
            1.0, abs(float(top2[0])))
    return v, i


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_categorical_hand_made_rows(cuda, dtype):
    """The hand-made rows (``repro_torch.testing.sampling``): a clear
    winner, NaN columns on sampled and greedy lanes, all -inf rows, ties of
    raw logits and of exact scores, +inf columns: the kernel picks what the
    plain version picks on the card, and the columns the rows were made
    for (lane 5's exact tie is the CPU's noise, so it is held to the plain
    version only)."""
    rows = edge_rows(cuda, dtype)
    _, index = _hold_draw_to_plain(rows.args)
    for lane, col in rows.want.items():
        if lane != 5:
            assert int(index[lane]) == col, (lane, int(index[lane]), col)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,vocab,dtype,std", [
    (256, 128256, torch.bfloat16, 3.0), (256, 50304, torch.float32, 3.0),
    (256, 128256, torch.bfloat16, 0.9), (5, 77, torch.float32, 3.0)])
def test_cuda_categorical_batches(cuda, lanes, vocab, dtype, std):
    """A large sampled batch (256 lanes) in bf16 and f32, at a std-3 and a
    flat std-0.9 draw, and rows of fewer columns than the kernel's column
    blocks (some blocks empty): the kernel against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(lanes + vocab)
    logits = (torch.randn(lanes, vocab, generator=gen, device=cuda)
              * std).to(dtype)
    temps = torch.tensor([0.6, 1.0, 0.3] * lanes, device=cuda)[:lanes]
    greedy = torch.arange(lanes, device=cuda) % 8 == 5
    safe_t = torch.where(greedy, torch.ones_like(temps), temps)
    seeds = torch.randint(0, 2**32, (lanes,), generator=gen, device=cuda)
    counters = torch.randint(0, 4097, (lanes,), generator=gen, device=cuda)
    _hold_draw_to_plain((logits, safe_t, greedy, prng_key(9), seeds,
                         counters))


@pytest.mark.gpu
def test_cuda_categorical_unaligned_rows(cuda):
    """Rows whose start is not 16-byte aligned (a column slice of a wider
    table, at its offset): the same picks as the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    wide = (torch.randn(6, 3001, generator=gen, device=cuda) * 3).bfloat16()
    logits = wide[:, 3:]
    lanes = logits.shape[0]
    args = (logits, torch.full((lanes,), 0.6, device=cuda),
            torch.zeros(lanes, dtype=torch.bool, device=cuda), prng_key(1),
            torch.arange(lanes, device=cuda) * 7,
            torch.arange(lanes, device=cuda))
    _hold_draw_to_plain(args, offset=3)


def _graph_node_types(graph) -> list:
    """The node types of a captured, kept graph (``keep_graph=True``),
    through the driver API (CU_GRAPH_NODE_TYPE_KERNEL is 0)."""
    import ctypes
    driver = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert driver.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert driver.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert driver.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.gpu
def test_cuda_categorical_one_kernel_a_call_and_graphed(cuda):
    """One call captured in a CUDA graph is one node, a kernel (no merge
    kernel, no memset), and the graph replayed gives the eager call's
    (value, index) on new logits written into the same tensor."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    lanes, vocab = 8, 128256
    logits = (torch.randn(lanes, vocab, generator=gen, device=cuda)
              * 3).bfloat16()
    args = (logits, torch.full((lanes,), 0.6, device=cuda),
            torch.zeros(lanes, dtype=torch.bool, device=cuda), prng_key(0),
            torch.arange(lanes, device=cuda) * 11,
            torch.arange(lanes, device=cuda))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        categorical(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        got = categorical(*args)
    assert _graph_node_types(graph) == [0]
    graph.instantiate()
    for k in range(3):
        logits.copy_((torch.randn(lanes, vocab, generator=gen, device=cuda)
                      * (1 + k)).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        want = categorical(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_categorical_arithmetic_is_the_librarys(cuda):
    """The kernel's own arithmetic, built from its source
    (``tools/categorical_variants/exact_check.cu`` includes
    ``csrc/categorical.cu``): its division (t's reciprocal taken once) is
    ``__fdiv_rn`` bit for bit wherever it takes its fast path, over every
    f32 x at 64 temperatures, and its noise (``neg_log`` twice) is
    ``-logf(-logf(u))`` bit for bit over all 2**23 uniforms."""
    from tools import categorical_variants
    check = categorical_variants.build(["exact_check"])["exact_check"][0]
    fast, bad, bad_noise = check()
    assert fast > 0 and bad == 0 and bad_noise == 0


@pytest.mark.gpu
def test_cuda_graphed_sampled_drive_equals_eager_at_paper_temperature(
        cuda):
    """A reduced llama3.2-1b drive with every request at temperature 0.6,
    fused over 4 tokens a call: graphed == eager token for token and
    launch for launch, each drive drawing through the sampling kernel
    once a fused decode iteration."""
    cfg = get_config(ARCH, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    before = CATEGORICAL_KERNEL.launches
    eng = _hold_graphed_to_eager(cuda, cfg, params, step_mode="fused",
                                 decode_steps=4, temperature=0.6)
    assert eng.metrics.decode_iterations > 0
    assert CATEGORICAL_KERNEL.launches - before \
        == 2 * eng.metrics.decode_iterations


# ------------------------------------------- decode steps as CUDA graphs

ENGINE_KERNELS = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, PAGED_LSE_KERNEL,
                  FLASH_PREFILL_KERNEL, SSD_SCAN_KERNEL, CATEGORICAL_KERNEL)


def _graph_drive(cuda, cfg, params, *, graphs, step_mode, temperature,
                 decode_steps=1, tp=None, parallel="exact"):
    """The reduced engine drive of ``_tp_engine_run`` (sampled at
    ``temperature``), with the launches of every engine kernel."""
    before = [k.launches for k in ENGINE_KERNELS]
    model = build_model(cfg)
    chunked = model.supports_chunked_prefill
    eng = port_serving.ServingEngine(
        model=model,
        scheduler=port_core.Scheduler(policy="sagesched",
                                      priority_backend="cuda",
                                      bucket_size=8),
        n_slots=2, max_seq_len=96, capacity_tokens=48, block_size=8,
        prefill_chunk=8 if chunked else None,
        max_tokens_per_step=12 if chunked else None, step_mode=step_mode,
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
    runners = list(eng._fused_runners.values()) \
        + list(eng._prefill_runners.values())
    if eng._orchestrated_runner is not None:
        runners.append(eng._orchestrated_runner)
    assert all(r.captured for r in runners)
    assert eng.graphs_captured == len(runners) > 0
    assert sum(r.calls for r in runners) > len(runners)     # replays ran
    assert eng.fused_compile_count == eager.fused_compile_count \
        <= eng.max_fused_compiles()
    assert sorted(eng._prefill_runners) == sorted(eager._prefill_runners)
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "zamba2-1.2b", "olmoe-1b-7b",
                                  "deepseek-moe-16b", "internvl2-76b"])
@pytest.mark.parametrize("step_mode,decode_steps", [
    ("fused", 1), ("fused", 4), ("orchestrated", 1)])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_graphed_decode_equals_eager(cuda, arch, step_mode,
                                          decode_steps, temperature):
    """Reduced dense, SSM, hybrid, MoE and VLM engines: the decode steps
    replayed from CUDA graphs (the MoE FFN's routing and dispatch
    captured) give the eager (graphs=False) streams token for token,
    greedy and sampled, with the eager launch counts, one graph a key."""
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
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
@pytest.mark.parametrize("parallel", ["exact", "efficient"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_graphed_decode_equals_eager_under_ssm_plans(cuda, arch,
                                                          parallel,
                                                          step_mode,
                                                          temperature):
    """Reduced mamba2 and zamba2 at tp 2 with both shards on the card: the
    exact plan's replicated Mamba2 layers and the efficient plan's per-head
    shards (each stepping its heads' state in place, frozen lanes and
    all) captured whole give the eager streams and launch counts, greedy
    and sampled."""
    cfg = get_config(arch, reduced=True).with_overrides(n_heads=8,
                                                        n_kv_heads=8)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    eng = _hold_graphed_to_eager(cuda, cfg, params, step_mode=step_mode,
                                 temperature=temperature, tp=2,
                                 parallel=parallel)
    assert eng.sharding_report()["ssm"] == (
        "sharded" if parallel == "efficient" else "replicated")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "zamba2-1.2b", "olmoe-1b-7b"])
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_cuda_prefill_graphs_equal_eager_and_replay(cuda, arch, step_mode):
    """The prefill chunks (the flash kernel, the MoE FFN, the pool
    scatter) and the recurrent families' whole prefills (the SSD scan,
    the slot's state write) replayed from CUDA graphs give the eager
    streams and launch counts; a second wave of the same prompts captures
    no new prefill graph and replays the first wave's tokens."""
    cfg = get_config(arch, reduced=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    chunked = build_model(cfg).supports_chunked_prefill
    out = {}
    for graphs in (False, True):
        before = [k.launches for k in ENGINE_KERNELS]
        eng = port_serving.ServingEngine(
            model=build_model(cfg),
            scheduler=port_core.Scheduler(policy="fcfs",
                                          priority_backend="cuda"),
            n_slots=3, max_seq_len=128, block_size=8,
            prefill_chunk=16 if chunked else None, step_mode=step_mode,
            params=params, device=cuda, graphs=graphs)
        rng = np.random.default_rng(9)
        prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, n)]
                   for n in (9, 40, 70, 23)]
        waves, graphs_after = [], []
        for tag in ("a", "b"):
            reqs = [port_serving.ServeRequest(
                f"{tag}{i}", f"{tag}{i}", list(p), max_new_tokens=5,
                temperature=0.0, eos_token=-1) for i, p in enumerate(prompts)]
            eng.submit_batch(reqs)
            eng.run_until_done(max_steps=2000)
            waves.append([r.output_tokens for r in reqs])
            graphs_after.append(eng.prefill_report()["graphs"])
        torch.cuda.synchronize()
        out[graphs] = (eng, waves, graphs_after,
                       [k.launches - n for k, n in zip(ENGINE_KERNELS,
                                                       before)])
    eager, want, _, want_launches = out[False]
    eng, got, graphs_after, launches = out[True]
    assert got == want
    assert got[1] == got[0]
    assert launches == want_launches
    assert eng.prefill_compile_count == eager.prefill_compile_count > 1
    assert graphs_after[0] == graphs_after[1] == eng.prefill_compile_count
    assert all(r.captured and r.calls > 1
               for r in eng._prefill_runners.values())


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
        counts.append((eng.fused_compile_count, eng.prefill_compile_count,
                       eng.graphs_captured))
    assert counts[0] == counts[1]
    fused, prefill, graphs = counts[0]
    assert 1 < fused <= eng.max_fused_compiles()
    assert fused + prefill == graphs


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


# ---------------------------- prefix sharing and the Gateway on the card

def _session_drive(cuda, params, *, sharing, pmode="swap",
                   step_mode="fused"):
    """``torch_sessions.session_drive`` on the card (SageSched with the
    CUDA Gittins backend, decode steps as CUDA graphs), with a budget
    that preempts requests holding adopted blocks.  Returns (engine,
    streams, counts)."""
    cfg = get_config(ARCH, reduced=True)
    eng = port_serving.ServingEngine(
        model=build_model(cfg),
        scheduler=port_core.Scheduler(policy="sagesched",
                                      priority_backend="cuda"),
        n_slots=2, max_seq_len=160, capacity_tokens=128, block_size=8,
        prefill_chunk=16, seed=0, preemption_mode=pmode,
        step_mode=step_mode, prefix_sharing=sharing, params=params,
        device=cuda)
    streams, counts = session_drive(eng, port_serving, cfg.vocab_size)
    torch.cuda.synchronize()
    port_testing.assert_engine_quiesced(eng)
    return eng, streams, counts


@pytest.fixture
def llama_params(cuda):
    cfg = get_config(ARCH, reduced=True)
    return build_model(cfg).init(torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.gpu
@pytest.mark.parametrize("step_mode", ["fused", "orchestrated"])
def test_cuda_prefix_sharing_on_equals_off_graphed(cuda, llama_params,
                                                    step_mode):
    """Sharing ON gives the OFF streams token for token with the decode
    steps as CUDA graphs (the resumed chunks keep the from-scratch
    shapes, so flash and the scatter give the same bits), skips prefill
    work, and fused equals orchestrated."""
    _, off, _ = _session_drive(cuda, llama_params, sharing=False,
                               step_mode=step_mode)
    on, got, counts = _session_drive(cuda, llama_params, sharing=True,
                                     step_mode=step_mode)
    assert got == off
    assert on.metrics.prefill_tokens_reused > 0
    assert on.graphs_captured > 0
    _, other, _ = _session_drive(
        cuda, llama_params, sharing=True,
        step_mode="orchestrated" if step_mode == "fused" else "fused")
    assert other == got


@pytest.mark.gpu
def test_cuda_cached_tier_readoption_on_equals_off(cuda, llama_params):
    """A finished request's prompt blocks stay in the pool at refcount 0;
    a later prompt with the same prefix adopts them after other requests
    ran their graphed decode steps (pad lanes and not-ready slots write
    only to the scratch page).  The later stream is the OFF stream."""
    cfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(8)
    prefix = [int(t) for t in rng.integers(3, cfg.vocab_size, 40)]

    def drive(sharing):
        eng = port_serving.ServingEngine(
            model=build_model(cfg),
            scheduler=port_core.Scheduler(policy="fcfs"),
            n_slots=4, max_seq_len=128, capacity_tokens=256, block_size=8,
            prefill_chunk=16, seed=0, prefix_sharing=sharing,
            params=llama_params, device=cuda)
        cached = []
        adopt = eng.kv.allocate_shared

        def counted_adopt(rid, ctx_len, blocks, hashes):
            cached.extend(b for b in blocks if eng.kv.refcount_of(b) == 0)
            return adopt(rid, ctx_len, blocks, hashes)

        eng.kv.allocate_shared = counted_adopt
        frng = np.random.default_rng(9)
        waves = [[prefix + [5, 6, 7]],
                 [[int(t) for t in frng.integers(3, cfg.vocab_size, n)]
                  for n in (9, 23, 30)],
                 [prefix + [11, 12, 13, 14]]]
        streams = []
        for w, prompts in enumerate(waves):
            reqs = [port_serving.ServeRequest(
                f"w{w}r{i}", "p", p, max_new_tokens=10, temperature=0.0,
                eos_token=-1) for i, p in enumerate(prompts)]
            eng.submit_batch(reqs)
            eng.run_until_done(max_steps=2000)
            streams.append([r.output_tokens for r in reqs])
        port_testing.assert_engine_quiesced(eng)
        return eng, streams, cached

    _, off, _ = drive(False)
    on, got, cached = drive(True)
    assert got == off
    assert len(cached) >= 4          # the 32 grid-capped tokens' blocks
    assert on.metrics.prefill_tokens_reused >= 32


@pytest.mark.gpu
@pytest.mark.parametrize("pmode", ["swap", "recompute"])
def test_cuda_preempting_requests_that_hold_adopted_blocks(cuda,
                                                           llama_params,
                                                           pmode):
    """Requests holding adopted blocks are preempted (swap: the payload
    gathers the whole table, swap-in re-adopts the leading blocks and
    restores only the rest); the streams are the OFF ones."""
    _, off, _ = _session_drive(cuda, llama_params, sharing=False,
                               pmode=pmode)
    on, got, counts = _session_drive(cuda, llama_params, sharing=True,
                                     pmode=pmode)
    assert got == off
    assert counts["adopted_preempts"] > 0
    if pmode == "swap":
        assert counts["adopted_swaps"] > 0
        assert on.metrics.swap_ins > 0


@pytest.mark.gpu
def test_cuda_gateway_deadline_abort_under_graphs(cuda, llama_params):
    """A TTLT deadline on a virtual clock aborts a running request of a
    graphed engine through the Gateway: every block comes back, the
    engine is quiesced, and a request offered afterwards streams what it
    streams on a fresh engine."""
    cfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, n)]
               for n in (20, 14, 17)]

    def gateway():
        clock = port_testing.VirtualClock()
        eng = port_serving.ServingEngine(
            model=build_model(cfg),
            scheduler=port_core.Scheduler(policy="fcfs"),
            n_slots=2, max_seq_len=96, prefill_chunk=16, seed=0,
            params=llama_params, device=cuda, clock=clock,
            prefix_sharing=True)
        return clock, eng, port_serving.Gateway(
            eng, port_serving.GatewayConfig(max_inflight=2))

    def req(i, **kw):
        return port_serving.ServeRequest(
            f"g{i}", "p", prompts[i], max_new_tokens=24, temperature=0.0,
            eos_token=-1, **kw)

    clock, eng, gw = gateway()
    r0, r1 = req(0, ttlt_deadline_s=0.5), req(1)
    gw.offer_batch([r0, r1])
    for _ in range(4):
        gw.step()
        clock.advance(0.05)
    assert r0.state == port_serving.RequestState.RUNNING \
        and r0.generated > 0
    clock.advance(1.0)
    gw.tick()
    assert r0.state == port_serving.RequestState.ABORTED
    assert r0.finish_reason == "ttlt_deadline"
    assert eng.metrics.timeout_aborts == 1 and eng.graphs_captured > 0
    r2 = req(2)
    gw.offer(r2)
    gw.run_until_drained(max_steps=2000)
    gw.assert_all_terminal()
    gw.check_invariants()
    port_testing.assert_engine_quiesced(eng)
    assert eng.kv.used_tokens == 0 and eng.kv.free_slots == 2
    _, fresh, fresh_gw = gateway()
    alone = req(2)
    fresh_gw.offer(alone)
    fresh_gw.run_until_drained(max_steps=2000)
    assert r2.output_tokens == alone.output_tokens
    assert len(r2.output_tokens) == 24


@pytest.mark.gpu
def test_cuda_collecting_dead_graphs_inside_a_capture_invalidates_it(
        cuda, llama_params):
    """Why captures pause the collector: a dead engine held in a
    reference cycle (a caller's wrapper around one of its methods) keeps
    its captured graphs until the collector runs, and destroying a graph
    inside another capture is a CUDA call the capture forbids."""
    import functools
    import gc
    gc.collect()                       # nothing else left to collect
    cfg = get_config(ARCH, reduced=True)
    eng, _, _ = _graph_drive(cuda, cfg, llama_params, graphs=True,
                             step_mode="fused", temperature=0.0)
    assert eng.graphs_captured > 0
    # eng -> partial -> eng: only the collector frees it
    eng.step = functools.partial(type(eng).step, eng)
    holder = [eng]
    del eng
    x = torch.zeros(8, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):  # torch.AcceleratorError included
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(cuda)):
            y = x * 2
            holder.clear()
            gc.collect()
            y.add_(1)
    gc.collect()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_captures_pause_the_collector(cuda, llama_params):
    """The engine's decode steps are captured with the collector paused
    (so no dead engine's graphs are destroyed inside a capture), and the
    collector runs again afterwards."""
    import gc
    cfg = get_config(ARCH, reduced=True)
    eng = port_serving.ServingEngine(
        model=build_model(cfg), scheduler=port_core.Scheduler(policy="fcfs"),
        n_slots=2, max_seq_len=96, prefill_chunk=16, seed=0,
        params=llama_params, device=cuda)
    seen = []

    def watch(body):
        def watched(x, **kw):
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
            return body(x, **kw)
        return watched

    eng._fused_body = watch(eng._fused_body)
    eng._chunk_body = watch(eng._chunk_body)
    rng = np.random.default_rng(3)
    eng.submit_batch([port_serving.ServeRequest(
        f"r{i}", "p", [int(t) for t in rng.integers(3, cfg.vocab_size, 12)],
        max_new_tokens=8, temperature=0.0, eos_token=-1) for i in range(3)])
    eng.run_until_done(max_steps=500)
    assert eng.graphs_captured > 0 and len(seen) == eng.graphs_captured
    assert not any(seen)
    assert gc.isenabled()


# ------------------------------------------------------------- training

def _bwd_inputs(cuda, b, sq, h, kvh, dh, seed, s_past=0, start=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    sk = s_past + sq
    q = torch.randn(b, sq, h, dh, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, sk, kvh, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, sk, kvh, dh, generator=g, device=cuda).bfloat16()
    dout = torch.randn(b, sq, h, dh, generator=g, device=cuda).bfloat16()
    pos = (start + torch.arange(sq, device=cuda)).int()
    past = torch.arange(s_past, device=cuda)
    kv_pos = torch.cat([torch.where(past < start, past, -10 ** 9),
                        pos.long()]).int()
    return q, k, v, dout, pos, kv_pos


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 192])
@pytest.mark.parametrize("sq,h,kvh,causal,window,s_past,start", [
    (96, 6, 2, True, 0, 0, 0),        # GQA, a ragged tile
    (64, 4, 1, True, 32, 128, 77),    # MQA, masked prefix rows, window
    (8, 4, 4, False, 0, 40, 40),      # bidirectional, few queries
    (100, 12, 1, True, 0, 0, 0),      # GQA 12 (nemotron's), Sq = Sk ragged
    (70, 8, 2, True, 0, 45, 30),      # GQA 4, Sq and Sk = 115 ragged,
                                      # masked prefix rows
    (130, 4, 4, True, 64, 0, 0),      # MHA, a window, three query tiles
])
def test_cuda_flash_backward_vs_plain(cuda, dh, sq, h, kvh, causal, window,
                                      s_past, start):
    """The backward kernel against its plain version on the LSE
    instance's own O and LSE; the LSE instance's O bit-identical to the
    serving instance's, its LSE within 1e-4 of the plain version's; two
    backward calls bit-identical (no atomics)."""
    from repro_torch.kernels.flash_attention.ops import (
        FLASH_BACKWARD_KERNEL, FLASH_PREFILL_LSE_KERNEL,
        flash_attention_backward, flash_attention_lse)
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)
    q, k, v, dout, pos, kv_pos = _bwd_inputs(cuda, 2, sq, h, kvh, dh,
                                             sq + dh, s_past, start)
    kw = dict(causal=causal, window=window)
    n_fwd, n_bwd = FLASH_PREFILL_LSE_KERNEL.launches, \
        FLASH_BACKWARD_KERNEL.launches
    out, lse = flash_attention_lse(q, k, v, pos, kv_pos, **kw)
    got = flash_attention_backward(q, k, v, pos, kv_pos, out, lse, dout, **kw)
    again = flash_attention_backward(q, k, v, pos, kv_pos, out, lse, dout,
                                     **kw)
    torch.cuda.synchronize()
    assert FLASH_PREFILL_LSE_KERNEL.launches == n_fwd + 1
    assert FLASH_BACKWARD_KERNEL.launches == n_bwd + 2
    _, want_lse = attention_reference(q, k, v, pos, kv_pos, return_lse=True,
                                      **kw)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    if not flash_key_ranges(sq, kv_pos.numel(), **kw):
        assert torch.equal(out, flash_attention(q, k, v, pos, kv_pos, **kw))
    want = attention_backward_reference(q, k, v, pos, kv_pos, out, lse, dout,
                                        **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _attn_close(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,h,kvh", [(64, 32, 8), (128, 12, 2),
                                      (192, 24, 2)])
def test_cuda_flash_backward_bit_identical(cuda, dh, h, kvh):
    """Two backward calls at a training shape (B 2 x S 512, causal) give
    the same bits, with other work on the card between them: no atomics,
    every sum in one fixed order."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward, flash_attention_lse)
    q, k, v, dout, pos, kv_pos = _bwd_inputs(cuda, 2, 512, h, kvh, dh, dh)
    out, lse = flash_attention_lse(q, k, v, pos, kv_pos)
    first = flash_attention_backward(q, k, v, pos, kv_pos, out, lse, dout)
    torch.randn(4096, 4096, device=cuda).sum()   # other work between
    again = flash_attention_backward(q, k, v, pos, kv_pos, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_cuda_serving_flash_path_unchanged_without_grad(cuda):
    """With grad disabled (or nothing requiring it) the flash op launches
    the serving instance only: no LSE or backward launch."""
    from repro_torch.kernels.flash_attention.ops import (
        FLASH_BACKWARD_KERNEL, FLASH_PREFILL_LSE_KERNEL)
    q, k, v, _, pos, kv_pos = _bwd_inputs(cuda, 1, 128, 8, 2, 64, 3)
    q.requires_grad_()
    n = (FLASH_PREFILL_KERNEL.launches, FLASH_PREFILL_LSE_KERNEL.launches,
         FLASH_BACKWARD_KERNEL.launches)
    with torch.no_grad():
        flash_attention(q, k, v, pos, kv_pos)
    flash_attention(q.detach(), k, v, pos, kv_pos)
    torch.cuda.synchronize()
    assert (FLASH_PREFILL_KERNEL.launches, FLASH_PREFILL_LSE_KERNEL.launches,
            FLASH_BACKWARD_KERNEL.launches) == (n[0] + 2, n[1], n[2])


def _card_vs_cpu_grads(cuda, arch):
    """The loss and gradients of a reduced ``arch`` on the card and on the
    CPU on the same bf16 weights and batch: (model, params on the card,
    the batch on the card, names of the leaves, card loss, CPU loss,
    ``grad_rel_errors`` of each leaf)."""
    from repro_torch.data import lm_batches
    from repro_torch.testing import grad_rel_errors
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_items, tree_leaves, tree_unflatten
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v)
         for k, v in next(lm_batches(cfg.vocab_size, 4, 128, seed=0)).items()}
    pg = tree_unflatten(params, [t.to(cuda) for t in tree_leaves(params)])
    bg = {k: v.to(cuda) for k, v in b.items()}
    lg, _, gg = loss_and_grads(model, pg, bg)
    lc, _, gc = loss_and_grads(model, params, b)
    names = ["/".join(p) for p, _ in tree_items(params)]
    return model, pg, bg, names, float(lg), float(lc), \
        grad_rel_errors(gg, gc)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [ARCH, "olmoe-1b-7b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """A reduced llama3.2-1b or olmoe-1b-7b (the MoE dispatch under
    autograd): the gradients of its loss on the card (the flash kernels
    forward and backward) against the CPU's (the plain versions) on the
    same bf16 weights and batch, the loss within 1e-3 relative and every
    leaf within GRAD_REL_BAR (GRAD_REL_BAR_MOE for olmoe) in relative
    norm.  Then one train step on the
    card: its launches (two LSE forwards a layer under remat, one
    backward) and finite parameters."""
    from repro_torch.kernels.flash_attention.ops import (
        FLASH_BACKWARD_KERNEL, FLASH_PREFILL_LSE_KERNEL)
    from repro_torch.testing import GRAD_REL_BAR, GRAD_REL_BAR_MOE
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.tree import tree_leaves
    model, pg, bg, names, lg, lc, errs = _card_vs_cpu_grads(cuda, arch)
    bar = GRAD_REL_BAR_MOE if model.cfg.family == "moe" else GRAD_REL_BAR
    assert abs(lg - lc) <= 1e-3 * abs(lc)
    bad = {n: e for n, e in zip(names, errs) if not e <= bar}
    assert not bad, bad
    opt = AdamW(learning_rate=1e-3)
    n = (FLASH_PREFILL_LSE_KERNEL.launches, FLASH_BACKWARD_KERNEL.launches)
    p1, _, mt = make_train_step(model, opt)(pg, opt.init(pg), bg)
    torch.cuda.synchronize()
    assert (FLASH_PREFILL_LSE_KERNEL.launches - n[0],
            FLASH_BACKWARD_KERNEL.launches - n[1]) == (
                2 * model.cfg.n_layers, model.cfg.n_layers)
    assert torch.isfinite(mt["loss"])
    assert all(torch.isfinite(t).all() for t in tree_leaves(p1))


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["missing", "flipped"])
def test_cuda_gradient_check_catches_a_wrong_attention_backward(
        cuda, fault, monkeypatch):
    """The check above fails on the fault a loss on the card was open to:
    attention's gradients missing (the Function's backward giving zeros
    on the card, as a detached output would) or of the wrong sign.  Every
    leaf of q, k and v projections is then off by about 1 or 2."""
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFunction
    from repro_torch.testing import GRAD_REL_BAR_MOE
    right = FlashAttentionFunction.backward

    def wrong(ctx, dout):
        grads = right(ctx, dout)
        if not dout.is_cuda:
            return grads
        return tuple(None if g is None else
                     (torch.zeros_like(g) if fault == "missing" else -g)
                     for g in grads)
    monkeypatch.setattr(FlashAttentionFunction, "backward",
                        staticmethod(wrong))
    *_, names, _, _, errs = _card_vs_cpu_grads(cuda, ARCH)
    qkv = [e for n, e in zip(names, errs) if n.split("/")[-1] in
           ("wq", "wk", "wv")]
    assert len(qkv) == 3 and min(qkv) > 0.5 > GRAD_REL_BAR_MOE


def _card_vs_cpu_recurrent(cuda, arch, monkeypatch=None, zero_ssd=False):
    """``arch`` at full width cut to 2 layers: the loss and gradients on
    the card (the SSD scan kernel forward and backward, for zamba2 the
    flash kernels too) against the CPU's (the plain versions) on the same
    bf16 weights and a B 2 x S 512 batch (two chunks a row).  With
    ``zero_ssd`` the SSD op's gradients are zeroed on the card, as a
    detached scan would leave them.  Returns (names, card loss, CPU loss,
    ``grad_rel_errors``)."""
    from repro_torch.data import lm_batches
    from repro_torch.kernels.ssd_scan.ops import SSDScanFunction
    from repro_torch.testing import grad_rel_errors
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_items, tree_leaves, tree_unflatten
    if zero_ssd:
        right = SSDScanFunction.backward

        def zeroed(ctx, dy, dstate):
            grads = right(ctx, dy, dstate)
            if dy is None or not dy.is_cuda:
                return grads
            return tuple(None if g is None else torch.zeros_like(g)
                         for g in grads)
        monkeypatch.setattr(SSDScanFunction, "backward",
                            staticmethod(zeroed))
    cfg = get_config(arch).with_overrides(n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v)
         for k, v in next(lm_batches(cfg.vocab_size, 2, 512, seed=0)).items()}
    pg = tree_unflatten(params, [t.to(cuda) for t in tree_leaves(params)])
    lg, _, gg = loss_and_grads(model, pg, {k: v.to(cuda)
                                           for k, v in b.items()})
    lc, _, gc = loss_and_grads(model, params, b)
    names = ["/".join(p) for p, _ in tree_items(params)]
    return names, float(lg), float(lc), grad_rel_errors(gg, gc)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_cuda_recurrent_gradients_match_cpu(cuda, arch):
    """mamba2-2.7b and zamba2-1.2b at full width, 2 layers: every
    gradient leaf on the card within GRAD_REL_BAR_SSM of the CPU's (bf16
    rounding at random weights moves these leaves more than attention's:
    testing/tolerance.py), the loss within 1e-3 relative; the SSD
    backward kernel launched once a Mamba2 layer."""
    from repro_torch.kernels.ssd_scan.ops import SSD_BACKWARD_KERNEL
    from repro_torch.testing import GRAD_REL_BAR_SSM
    n0 = SSD_BACKWARD_KERNEL.launches
    names, lg, lc, errs = _card_vs_cpu_recurrent(cuda, arch)
    assert SSD_BACKWARD_KERNEL.launches - n0 == 2
    assert abs(lg - lc) <= 1e-3 * abs(lc)
    bad = {n: e for n, e in zip(names, errs) if not e <= GRAD_REL_BAR_SSM}
    assert not bad, bad


@pytest.mark.gpu
def test_cuda_gradient_check_catches_a_missing_ssd_backward(cuda,
                                                            monkeypatch):
    """The check above fails with the SSD op's gradients zeroed on the
    card: B and C reach the loss through the scan alone, so bc_proj is
    off by about 1."""
    from repro_torch.testing import GRAD_REL_BAR_SSM
    names, _, _, errs = _card_vs_cpu_recurrent(cuda, "mamba2-2.7b",
                                               monkeypatch, zero_ssd=True)
    bc = [e for n, e in zip(names, errs) if n.endswith("bc_proj")]
    assert len(bc) == 1 and bc[0] > 0.5 > GRAD_REL_BAR_SSM


def _rel_norm(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


SSD_BWD_CASES = [
    # (b, s, h, p, n, chunk, init, dstate): the reduced configs (ragged);
    # zamba2-1.2b (ragged, no initial state); mamba2-2.7b's shape
    (2, 45, 16, 32, 16, 16, True, True),
    (1, 777, 64, 64, 64, 256, False, True),
    (2, 1024, 80, 64, 128, 256, True, True),
    (2, 1024, 80, 64, 128, 256, False, False),
    # the reduced configs without either state; mamba2's (P, N) with S
    # ragged and no initial state; zamba2's with an initial state and no
    # final-state gradient; a chunk of 150 rows (S under the chunk: tiles
    # past the chunk's rows within its last 64-row tile)
    (1, 50, 16, 32, 16, 16, False, False),
    (1, 300, 80, 64, 128, 256, False, True),
    (2, 512, 64, 64, 64, 256, True, False),
    (1, 150, 16, 64, 64, 256, True, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk,init,dstate", SSD_BWD_CASES)
def test_cuda_ssd_backward_vs_plain(cuda, b, s, h, p, n, chunk, init,
                                    dstate):
    """The backward kernel against ``ssd_backward_reference`` on the same
    inputs (long memory): the bf16 gradients (dx, dB, dC) within 1e-2 in
    relative norm, the f32 ones (ddt, da, dinit) within 1e-3; one counted
    launch a call; two calls bit-identical."""
    from repro_torch.kernels.ssd_scan.ops import (SSD_BACKWARD_KERNEL,
                                                  ssd_scan_backward)
    from repro_torch.kernels.ssd_scan.ref import ssd_backward_reference
    x, dt, a, bm, cm, st = _ssd_case(cuda, s + h, b, s, h, p, n, init,
                                     (0.99, 1.0))
    g = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn(b, s, h, p, generator=g, device=cuda).bfloat16()
    ds = torch.randn(b, h, p, n, generator=g, device=cuda) if dstate \
        else None
    n0 = SSD_BACKWARD_KERNEL.launches
    got = ssd_scan_backward(x, dt, a, bm, cm, st, dy, ds, chunk=chunk)
    again = ssd_scan_backward(x, dt, a, bm, cm, st, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD_BACKWARD_KERNEL.launches == n0 + 2
    want = ssd_backward_reference(x, dt, a, bm, cm, st, dy, ds, chunk=chunk)
    for name, gt, ag, w in zip(("dx", "ddt", "da", "dB", "dC", "dinit"),
                               got, again, want):
        if w is None:
            assert gt is None and ag is None
            continue
        assert gt.dtype == w.dtype and gt.shape == w.shape, name
        assert torch.equal(gt, ag), name
        assert torch.isfinite(gt).all(), name
        bar = 1e-2 if gt.dtype == torch.bfloat16 else 1e-3
        assert _rel_norm(gt, w) <= bar, (name, _rel_norm(gt, w))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_cuda_ssd_backward_bit_identical(cuda, arch):
    """Two backward calls at the training shape's length (B 2 x S 1024,
    an initial state and a final-state gradient) give the same bits, with
    other work on the card between them: no atomics, the heads' sums of dG
    and the row terms in head order."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_backward
    cfg = get_config(arch)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dt, a, bm, cm, st = _ssd_case(cuda, 17, 2, 1024, h, p, n, True,
                                     (0.99, 1.0))
    g = torch.Generator(device=cuda).manual_seed(18)
    dy = torch.randn(2, 1024, h, p, generator=g, device=cuda).bfloat16()
    ds = torch.randn(2, h, p, n, generator=g, device=cuda)
    first = ssd_scan_backward(x, dt, a, bm, cm, st, dy, ds)
    torch.randn(4096, 4096, device=cuda).sum()   # other work between
    again = ssd_scan_backward(x, dt, a, bm, cm, st, dy, ds)
    torch.cuda.synchronize()
    for name, u, w in zip(("dx", "ddt", "da", "dB", "dC", "dinit"), first,
                          again):
        assert torch.equal(u, w), name


@pytest.mark.gpu
def test_cuda_ssd_backward_padded_rows_are_zero(cuda):
    """Rows as the op pads them (x, B, C = 0, dt = 0, a = 1) with no
    output gradient: the kernel's dx, ddt, dB and dC there are exactly 0,
    and ssd_scan under autograd at S = 777 gives the gradients of the
    padded call's first 777 rows."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_backward
    cfg = get_config("zamba2-1.2b")
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dt, a, bm, cm, st = _ssd_case(cuda, 5, 1, 1024, h, p, n, True)
    g = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(1, 1024, h, p, generator=g, device=cuda).bfloat16()
    ds = torch.randn(1, h, p, n, generator=g, device=cuda)
    for t in (x, dt, bm, cm, dy):
        t[:, 777:] = 0
    a[:, 777:] = 1.0
    got = ssd_scan_backward(x, dt, a, bm, cm, st, dy, ds)
    for t in (got[0], got[1], got[3], got[4]):
        assert torch.equal(t[:, 777:], torch.zeros_like(t[:, 777:]))
    ins = [t[:, :777].contiguous().requires_grad_() for t in
           (x.float(), dt, a, bm.float(), cm.float())]
    xs, dts, as_, bs, cs = ins
    y, fin = ssd_scan(xs.bfloat16(), dts, as_, bs.bfloat16(), cs.bfloat16(),
                      st)
    grads = torch.autograd.grad((y.float() * dy[:, :777].float()).sum()
                                + (fin * ds).sum(), ins)
    for name, gt, w in zip(("dx", "ddt", "da", "dB", "dC"), grads, got):
        assert torch.equal(gt, w[:, :777].to(gt.dtype)), name
