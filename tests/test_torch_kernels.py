"""Port kernels (repro_torch.kernels) against the JAX package's Pallas
kernels, run in interpret mode, and against its jnp twins.

On the CPU each op takes its plain PyTorch version, so these tests hold
the plain versions to the reference (tests/test_torch_gpu.py holds the
CUDA kernels to the plain versions on the card).  Inputs are made with numpy
from a seed and handed to both sides.  Tolerances: 1e-5 in f32 and 2e-2
in bf16 (the JAX package's own kernel bar, tests/test_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_op \
    as jax_dense_op
from repro.kernels.decode_attention.ops import decode_attention_paged_op \
    as jax_paged_op
from repro.kernels.decode_attention.ops import \
    decode_attention_paged_lse_op as jax_paged_lse_op
from repro.kernels.decode_attention.ref import \
    decode_attention_paged_lse_reference as jax_paged_lse_oracle
from repro.kernels.decode_attention.ref import decode_attention_reference \
    as jax_dense_oracle
from repro.kernels.flash_attention.ops import flash_attention \
    as jax_flash
from repro.models.attention import decode_attention as jax_decode_dense
from repro.models.attention import decode_attention_paged \
    as jax_decode_paged
from repro.models.attention import encoder_attention as jax_encoder_attn
from repro.models.attention import gqa_attention as jax_gqa
from repro_torch.kernels.categorical import (CATEGORICAL_KERNEL, categorical,
                                             prng_key)
from repro_torch.kernels.decode_attention.ops import (
    DENSE_DECODE_KERNEL, LSE_SPLIT_UNITS, MMA_MAX_HEADS, MMA_MIN_REP,
    PAGED_DECODE_KERNEL,
    PAGED_LSE_KERNEL, SPLIT_UNIT, SPLIT_UNITS, _check, _check_dense,
    decode_attention_op, decode_attention_paged_lse_op,
    decode_attention_paged_op, head_groups, split_kv_head_groups,
    split_kv_sub_splits, uses_tensor_cores)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_dense_reference, decode_attention_paged_lse_reference,
    decode_attention_reference)
from repro_torch.kernels.flash_attention.ops import (FLASH_PREFILL_KERNEL,
                                                     FLASH_SPLIT_KERNEL,
                                                     SPLIT_MAX_SQ,
                                                     flash_attention,
                                                     flash_key_ranges)
from repro_torch.kernels.flash_attention.ops import _check as _check_flash
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_passes_reference, attention_backward_reference,
    attention_reference)
from repro_torch.kernels.gittins.ops import (GITTINS_KERNEL,
                                             gittins_attained)
from repro_torch.models.attention import (combine_lse_partials,
                                          decode_attention,
                                          decode_attention_paged,
                                          encoder_attention, gqa_attention)

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# tests/test_kernels.py::_tol, the bar of its dense decode kernel test
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": BF16_TOL}


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """Round to the nearest bf16 and return as f32, so both frameworks
    see exactly the same values."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


# ------------------------------------------------------------ flash prefill

@pytest.mark.parametrize("B,S,H,KV,dh,window", [
    (2, 256, 4, 2, 64, 0),       # GQA
    (1, 200, 4, 1, 64, 0),       # MQA + ragged seq (kernel padding path)
    (1, 256, 4, 4, 128, 0),      # MHA, wide head
    (1, 384, 4, 2, 64, 128),     # sliding window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas(B, S, H, KV, dh, window, dtype):
    rng = np.random.default_rng(S + H + window)
    q, k, v = (_bf16_values(rng.normal(0, 1, shape)) for shape in
               ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                force_pallas=True), np.float32)
    tdt = getattr(torch, dtype)
    pos = torch.arange(S, dtype=torch.int32)
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          pos, pos, causal=True, window=window)
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("s_past,start,c,window", [
    (0, 0, 64, 0),               # first chunk: zero-length past
    (64, 64, 64, 0),             # exact prefix
    (128, 77, 64, 0),            # padded prefix: rows >= start at -1e9
    (128, 77, 64, 48),           # and a sliding window
])
def test_flash_plain_vs_gqa_attention_chunk(s_past, start, c, window):
    """The chunked-prefill call (transformer.py:629-650): a query offset
    and masked prefix rows, which the Pallas kernel cannot express."""
    rng = np.random.default_rng(s_past + start + window)
    b, h, kvh, dh = 1, 4, 2, 64
    q = rng.normal(0, 1, (b, c, h, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, s_past + c, kvh, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, s_past + c, kvh, dh)).astype(np.float32)
    pos = start + np.arange(c)
    past = np.arange(s_past)
    kv_pos = np.concatenate([np.where(past < start, past, -(10 ** 9)), pos])
    want = np.asarray(jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window,
                              positions=jnp.asarray(pos),
                              kv_positions=jnp.asarray(kv_pos)))
    got = gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window,
                        positions=torch.from_numpy(pos),
                        kv_positions=torch.from_numpy(kv_pos))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# ------------------------------------------------------------- paged decode

def _paged_case(rng, b, h, kvh, dh, page, n_pages, p_used):
    q = rng.normal(0, 1, (b, h, dh)).astype(np.float32)
    kp = _bf16_values(rng.normal(0, 1, (n_pages, page, kvh, dh)))
    vp = _bf16_values(rng.normal(0, 1, (n_pages, page, kvh, dh)))
    tables = np.stack([rng.permutation(np.arange(1, n_pages))[:p_used]
                       for _ in range(b)]).astype(np.int32)
    cache_len = rng.integers(1, p_used * page + 1, b).astype(np.int32)
    return q, kp, vp, tables, cache_len


@pytest.mark.parametrize("b,h,kvh,dh,page,p_used,window", [
    (3, 8, 2, 64, 16, 5, 0),     # table width 5 -> padded to 8
    (2, 4, 1, 64, 8, 4, 0),      # MQA, pow2 table
    (4, 8, 8, 128, 16, 3, 0),    # MHA, wide head
    (3, 8, 2, 64, 16, 6, 20),    # logical sliding window
])
def test_paged_decode_plain_vs_pallas(b, h, kvh, dh, page, p_used, window):
    """f32 q against a bf16 pool (the engine's test-time dtypes); the
    Pallas kernel reads the same values from an f32 pool."""
    rng = np.random.default_rng(b * 100 + p_used + window)
    q, kp, vp, tables, cl = _paged_case(rng, b, h, kvh, dh, page, 32, p_used)
    want = np.asarray(jax_paged_op(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(cl), window=window, force_pallas=True))
    got = decode_attention_paged_op(
        torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(tables),
        torch.from_numpy(cl), window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_model_vs_jnp_twin(window):
    """models.attention.decode_attention_paged, port vs reference, with
    bf16 pools on both sides."""
    rng = np.random.default_rng(7 + window)
    q, kp, vp, tables, cl = _paged_case(rng, 3, 8, 2, 64, 16, 32, 4)
    want = np.asarray(jax_decode_paged(
        jnp.asarray(q)[:, None], jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(cl),
        window=window))
    got = decode_attention_paged(
        torch.from_numpy(q)[:, None], torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(tables),
        torch.from_numpy(cl), window=window)
    assert got.shape == (3, 1, 8, 64)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("h,kvh,dh", [(24, 2, 192), (48, 1, 128),
                                      (48, 1, 192)])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_model_vs_jnp_twin_large_gqa(h, kvh, dh, window):
    """The port's paged decode at the shapes whose kernels split the query
    heads of a kv head over blocks: nemotron-4-340b's head dim 192 with 12
    query heads a kv head, granite-34b's 48 (MQA), and both at once;
    port vs reference, f32 q over bf16 pools on both sides."""
    rng = np.random.default_rng(h + dh + window)
    q, kp, vp, tables, cl = _paged_case(rng, 2, h, kvh, dh, 16, 16, 4)
    want = np.asarray(jax_decode_paged(
        jnp.asarray(q)[:, None], jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(cl),
        window=window))
    got = decode_attention_paged(
        torch.from_numpy(q)[:, None], torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(tables),
        torch.from_numpy(cl), window=window)
    assert got.shape == (2, 1, h, dh)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_paged_decode_table_padding_is_inert():
    """Scratch-page columns past every cache_len change nothing."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables, cl = _paged_case(rng, 2, 8, 2, 64, 16, 32, 4)
    args = [torch.from_numpy(x) for x in (q, kp, vp)]
    narrow = decode_attention_paged_op(*args, torch.from_numpy(tables),
                                       torch.from_numpy(cl))
    wide = decode_attention_paged_op(
        *args, torch.from_numpy(np.pad(tables, ((0, 0), (0, 4)))),
        torch.from_numpy(cl))
    assert torch.equal(narrow, wide)


# The partial (out, lse) paged decode and the LSE page split.  f32 inputs:
# the reference's Pallas kernel in interpret mode cannot run a bf16 x bf16
# -> f32 dot on this CPU (ROADMAP Queue C R1).  Rows: one inside the first
# stripe (the later stripes fully masked), one ending mid-table, one
# filling the table.
LSE_CASES = [(8, 2, 0), (8, 4, 0), (8, 2, 40), (8, 4, 40), (7, 2, 0),
             (7, 4, 20)]


def _lse_case(p_used: int, seed: int):
    rng = np.random.default_rng(seed)
    b, h, kvh, dh, page, n_pages = 3, 8, 2, 64, 16, 40
    q = rng.normal(0, 1, (b, h, dh)).astype(np.float32)
    kp = rng.normal(0, 1, (n_pages, page, kvh, dh)).astype(np.float32)
    vp = rng.normal(0, 1, (n_pages, page, kvh, dh)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, n_pages))[:p_used]
                       for _ in range(b)]).astype(np.int32)
    cl = np.array([page - 3, p_used * page // 2 + 5, p_used * page],
                  np.int32)
    return q, kp, vp, tables, cl, page


def _stripes(p_used: int, n_splits: int) -> int:
    """Pages per stripe of models.attention's split (P padded to
    n_splits times a power of two)."""
    per = 1
    while per * n_splits < p_used:
        per *= 2
    return per


@pytest.mark.parametrize("p_used,n_splits,window", LSE_CASES)
def test_paged_lse_plain_vs_reference(p_used, n_splits, window):
    """Each stripe of the split, the port's plain partial against the
    reference's (out, lse) oracle and its Pallas kernel in interpret mode:
    out at 1e-5 (fully masked stripes included: every version averages
    their values uniformly), lse at 1e-5 relative (-1e30 where masked)."""
    q, kp, vp, tables, cl, page = _lse_case(p_used, 30 + p_used + window)
    per = _stripes(p_used, n_splits)
    tables = np.pad(tables, ((0, 0), (0, per * n_splits - p_used)))
    masked = 0
    for s in range(n_splits):
        bt = np.ascontiguousarray(tables[:, s * per:(s + 1) * per])
        cls = np.maximum(cl - s * per * page, 0).astype(np.int32)
        masked += int((cls == 0).sum())
        jargs = [jnp.asarray(x) for x in (q, kp, vp, bt, cls)]
        got_o, got_l = decode_attention_paged_lse_op(
            *(torch.from_numpy(x) for x in (q, kp, vp, bt, cls)),
            window=window)
        for want_o, want_l in (
                jax_paged_lse_oracle(*jargs, window=window),
                jax_paged_lse_op(*jargs, window=window, force_pallas=True)):
            np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                                       **F32_TOL)
            np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                       rtol=1e-5, atol=1e-5)
        assert (got_l.numpy()[cls == 0] <= -1e29).all()
    assert masked > 0          # the case has fully masked stripes


@pytest.mark.parametrize("p_used,n_splits,window", LSE_CASES)
def test_paged_decode_split_vs_jnp_twin(p_used, n_splits, window):
    """models.attention.decode_attention_paged(n_splits=k), port vs the
    reference's jnp split twin (which merges unnormalised partials) and
    vs the unsplit port at 1e-5 in f32."""
    q, kp, vp, tables, cl, _ = _lse_case(p_used, 50 + p_used + window)
    want = np.asarray(jax_decode_paged(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(cl), window=window,
        n_splits=n_splits))
    args = [torch.from_numpy(x) for x in (q[:, None], kp, vp, tables, cl)]
    got = decode_attention_paged(*args, window=window, n_splits=n_splits)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    whole = decode_attention_paged(*args, window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **F32_TOL)


def test_paged_decode_split_runs_each_stripe_on_its_pools():
    """``stripe_pools``: stripe s reads the pools it is given (here copies,
    one per stripe), and a wrong count is refused."""
    q, kp, vp, tables, cl, _ = _lse_case(8, 1)
    args = [torch.from_numpy(x) for x in (q[:, None], kp, vp, tables, cl)]
    pools = [(args[1].clone(), args[2].clone()) for _ in range(4)]
    got = decode_attention_paged(*args, n_splits=4, stripe_pools=pools)
    assert torch.equal(got, decode_attention_paged(*args, n_splits=4))
    pools[3][0].zero_()        # stripe 3 holds row 2's last positions
    assert not torch.equal(
        got, decode_attention_paged(*args, n_splits=4, stripe_pools=pools))
    with pytest.raises(ValueError, match="stripe pools"):
        decode_attention_paged(*args, n_splits=4, stripe_pools=pools[:2])


def _lse_sub_split_rows(length: int, window: int, page: int, n_pages: int,
                        units: int = LSE_SPLIT_UNITS):
    """The rows and pages each sub-split of the partial kernel takes for
    one row (csrc/decode_attention.cu paged_lse_split_kernel): sub-split
    z the live rows [max(lo, z per), min(len, P page, (z + 1) per)), per
    = units 64-row units, over the pages those rows touch.  Returns
    (n_sub, [(rows, pages)] per sub-split)."""
    per = units * SPLIT_UNIT
    n_sub = split_kv_sub_splits(n_pages * page, units)
    lo = max(0, length - window) if window > 0 else 0
    out = []
    for z in range(n_sub):
        r0 = max(lo, z * per)
        r1 = min(length, n_pages * page, (z + 1) * per)
        rows = list(range(r0, r1))
        pages = list(range(r0 // page, -(-r1 // page))) if r1 > r0 else []
        out.append((rows, pages))
    return n_sub, out


@pytest.mark.parametrize("page", [8, 16, 24, 48, 64])
@pytest.mark.parametrize("n_pages", [1, 2, 7, 8, 32, 33, 128])
@pytest.mark.parametrize("window", [0, 100])
def test_lse_sub_splits_cut_fixed_units(page, n_pages, window):
    """The partial kernel's sub-splits cut every row at fixed 64-row unit
    boundaries from its first row: each live row of a row in exactly one
    sub-split, every page a sub-split visits holding one of its rows (so
    its running max is a real score after the first page), and the same
    sub-split for a row at any padded table width (the fused step's pow2
    tables, the orchestrated step's whole ones); a page of 24 or 48 rows
    straddles a boundary and is visited by both sub-splits (at the op's
    64-row units, and at 3 and 4 units)."""
    for units in (LSE_SPLIT_UNITS, 3, 4):
        per = units * SPLIT_UNIT
        for length in sorted({0, 1, page - 1, page, 63, 64, 65, 255, 256,
                              257, n_pages * page // 2, n_pages * page}):
            length = min(length, n_pages * page)
            lo = max(0, length - window) if window > 0 else 0
            where = {}
            for width in (n_pages, 2 * n_pages, 4 * n_pages + 3):
                n_sub, subs = _lse_sub_split_rows(length, window, page,
                                                  width, units)
                assert n_sub == -(-width * page // per)
                rows = [r for rs, _ in subs for r in rs]
                assert rows == list(range(lo, length))
                for z, (rs, pages) in enumerate(subs):
                    assert all(z * per <= r < (z + 1) * per for r in rs)
                    for pg in pages:
                        assert any(pg * page <= r < (pg + 1) * page
                                   for r in rs)
                    for r in rs:
                        assert where.setdefault(r, z) == z
                    if not rs:
                        assert not pages   # adds exact zeros in the merge


def test_lse_sub_splits_follow_the_rows_alone():
    """The partial op's sub-split count is a function of the stripe's
    rows alone: ``split_kv_sub_splits`` of P * page in LSE_SPLIT_UNITS
    64-row units (no batch, kv-head count, query-head ratio, head dim or
    SM count enters it); at qwen2-1.5b's tp-4 stripe (32 pages of 16)
    that is 8 sub-splits of 64 rows.  The split-KV ops cut SPLIT_UNITS
    units: llama3.2-1b's paged shape (2048-token tables) and 8192-slot
    ring, seamless's 512-slot cache."""
    import inspect
    from repro_torch.kernels.decode_attention import ops
    src = inspect.getsource(ops.decode_attention_paged_lse_op)
    assert "split_kv_sub_splits(p * page, LSE_SPLIT_UNITS)" in src
    assert "multi_processor_count" not in inspect.getsource(ops)
    assert not hasattr(ops, "decode_sub_splits")
    assert (SPLIT_UNITS, LSE_SPLIT_UNITS) == (4, 1)
    assert split_kv_sub_splits(32 * 16, LSE_SPLIT_UNITS) == 8
    assert split_kv_sub_splits(32 * 16) == 2
    assert split_kv_sub_splits(2048) == 8
    assert split_kv_sub_splits(8192) == 32
    assert split_kv_sub_splits(512) == 2
    assert split_kv_sub_splits(300) == split_kv_sub_splits(257) == 2
    n_sub, subs = _lse_sub_split_rows(300, 0, 16, 32)
    assert n_sub == 8 and [len(r) for r, _ in subs] == [64] * 4 + [44] + [0] * 3


@pytest.mark.parametrize("rep,dh,want", [
    (4, 64, (1, 4)),        # llama3.2-1b
    (16, 64, (1, 16)),      # 1024 / 64 heads: one block
    (6, 128, (1, 6)),       # qwen2-1.5b
    (48, 128, (6, 8)),      # granite-34b's MQA
    (12, 192, (3, 4)),      # nemotron-4-340b
    (5, 192, (1, 5)),       # 5 * 192 = 960 <= 1024
    (9, 128, (2, 5)),       # unequal: groups of 5 and 4
    (1, 192, (1, 1)),
])
def test_head_groups_split_the_query_heads(rep, dh, want):
    """The kernels' head groups: the fewest groups of at most 1024 / dh
    heads, as equal as the count allows, covering every head once."""
    n, hpb = head_groups(rep, dh)
    assert (n, hpb) == want
    assert hpb * dh <= 1024 and n * hpb >= rep > (n - 1) * hpb
    assert n == -(-rep // (1024 // dh))


@pytest.mark.parametrize("rep,dh,want", [
    (1, 64, (False, (1, 1))),     # zamba2, seamless: MHA
    (4, 64, (False, (1, 4))),     # llama3.2-1b
    (6, 128, (False, (1, 6))),    # qwen2-1.5b
    (7, 192, (False, (2, 4))),    # below the threshold: f32 head groups
    (8, 64, (True, (1, 8))),      # from 8 heads a kv head: tensor cores
    (8, 192, (True, (1, 8))),
    (12, 192, (True, (1, 12))),   # nemotron-4-340b: one block a kv head
    (16, 128, (True, (1, 16))),
    (48, 128, (True, (1, 48))),   # granite-34b's MQA: one block, not six
    (64, 192, (True, (1, 64))),
    (65, 64, (True, (2, 33))),    # past 64 heads: two equal groups
    (96, 128, (True, (2, 48))),
])
def test_decode_dispatch_ratio_threshold_and_head_grouping(rep, dh, want):
    """The paged and dense kernels take the tensor-core instance from
    MMA_MIN_REP = 8 query heads a kv head, one block for all of a kv
    head's heads up to MMA_MAX_HEADS = 64 (so a K/V tile is read once per
    (kv head, row, sub-split)); below 8, the f32 instance with its 1024 /
    dh head groups.  Every head lies in exactly one group."""
    mma, (n, hpb) = want
    assert uses_tensor_cores(rep) is mma
    assert split_kv_head_groups(rep, dh) == (n, hpb)
    assert n * hpb >= rep > (n - 1) * hpb
    if mma:
        assert rep >= MMA_MIN_REP and hpb <= MMA_MAX_HEADS
    else:
        assert split_kv_head_groups(rep, dh) == head_groups(rep, dh)


@pytest.mark.parametrize("s_rows", [1, 63, 64, 300, 2048, 8192, 8392])
def test_split_decode_rows_partition_into_whole_units(s_rows):
    """The split-KV kernels' sub-split z covers the rows [z * per, (z + 1)
    * per), per = units * SPLIT_UNIT: together exactly the S rows, each a
    whole number of the kernels' 64- and 32-row tiles, and every row in
    the same sub-split whatever the table's padded width (the engine's
    fused step pads to a pow2 of the pages in use, its orchestrated step
    passes whole tables)."""
    n_units = -(-s_rows // SPLIT_UNIT)
    for units in (SPLIT_UNITS, 3, 1):
        per = units * SPLIT_UNIT
        which = {}
        for width in (n_units, 2 * n_units, 4 * n_units + 3):
            n_sub = split_kv_sub_splits(width * SPLIT_UNIT, units)
            rows = [(r, z) for z in range(n_sub)
                    for r in range(z * per, min(width * SPLIT_UNIT,
                                                (z + 1) * per))]
            assert [r for r, _ in rows] == list(range(width * SPLIT_UNIT))
            for r, z in rows[:s_rows]:
                assert which.setdefault(r, z) == z
        assert per % 64 == 0


@pytest.mark.parametrize("p_used,window", [(8, 0), (7, 20), (5, 0)])
def test_paged_lse_cpu_path_is_the_plain_version(p_used, window):
    """On the CPU the partial op returns exactly what it returned before
    the kernel was split across blocks: the plain version over the
    tables padded to a pow2 width with scratch page 0, bit for bit."""
    q, kp, vp, tables, cl, _ = _lse_case(p_used, 70 + p_used + window)
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, cl)]
    got_o, got_l = decode_attention_paged_lse_op(*args, window=window)
    pb = 1 << (p_used - 1).bit_length()
    padded = torch.nn.functional.pad(args[3], (0, pb - p_used))
    want_o, want_l = decode_attention_paged_lse_reference(
        args[0], args[1], args[2], padded, args[4], window=window)
    assert torch.equal(got_o, want_o) and torch.equal(got_l, want_l)


def test_combine_lse_partials_matches_full_softmax():
    """Two stripes merged by LSE == one softmax over both; an all-masked
    stripe weighs nothing."""
    rng = np.random.default_rng(11)
    s = torch.from_numpy(rng.normal(0, 1, (2, 3, 10))).float()
    v = torch.from_numpy(rng.normal(0, 1, (2, 10, 5))).float()
    full = torch.einsum("bhs,bsd->bhd", torch.softmax(s, -1), v)
    outs, lses = [], []
    for lo, hi in ((0, 4), (4, 10)):
        ss = s[..., lo:hi]
        outs.append(torch.einsum("bhs,bsd->bhd", torch.softmax(ss, -1),
                                 v[:, lo:hi]))
        lses.append(torch.logsumexp(ss, -1))
    outs.append(torch.full_like(outs[0], 7.0))        # empty stripe
    lses.append(torch.full_like(lses[0], -1e30))
    out, lse = combine_lse_partials(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(out, full, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- dense decode

def _dense_case(rng, b, s, h, kvh, dh, window):
    """q, caches and cache_len as tests/test_kernels.py draws them: ragged
    lengths in [1, S), and up to S + 200 for a ring (some rows wrapped)."""
    q = rng.normal(0, 1, (b, h, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kvh, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kvh, dh)).astype(np.float32)
    hi = s + 200 if window else s
    cl = rng.integers(1, hi, (b,)).astype(np.int32)
    return q, k, v, cl


# the four cases of tests/test_kernels.py::test_decode_attention_vs_oracle
DENSE_CASES = [
    (2, 512, 8, 2, 64, 0, 128),      # GQA
    (3, 1024, 4, 1, 128, 0, 256),    # MQA (granite-style)
    (2, 512, 8, 8, 64, 512, 128),    # ring buffer (sliding window)
    (1, 640, 4, 4, 64, 0, 128),      # S not a power of two
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,dh,window,blk", DENSE_CASES)
def test_dense_decode_plain_vs_pallas(b, s, h, kvh, dh, window, blk, dtype):
    """The op's plain version against the Pallas kernel in interpret
    mode, on the same values in the same dtype."""
    rng = np.random.default_rng(b * 1000 + s + window)
    q, k, v, cl = _dense_case(rng, b, s, h, kvh, dh, window)
    if dtype == "bfloat16":
        q, k, v = (_bf16_values(x) for x in (q, k, v))
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_dense_op(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(cl), window=window, block_s=blk, force_pallas=True),
        np.float32)
    tdt = getattr(torch, dtype)
    got = decode_attention_op(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)),
                              torch.from_numpy(cl), window=window)
    assert got.dtype == tdt and got.shape == (b, h, dh)
    np.testing.assert_allclose(got.float().numpy(), want, **KERNEL_TOL[dtype])


@pytest.mark.parametrize("b,s,h,kvh,dh,window,blk", DENSE_CASES)
def test_dense_decode_oracle_twin(b, s, h, kvh, dh, window, blk):
    """The port's counterpart of the JAX oracle (normalise before the
    value sum) against it, and against the model-numerics plain version."""
    rng = np.random.default_rng(s + h + window)
    q, k, v, cl = _dense_case(rng, b, s, h, kvh, dh, window)
    want = np.asarray(jax_dense_oracle(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(cl),
                                       window=window))
    args = [torch.from_numpy(x) for x in (q, k, v, cl)]
    got = decode_attention_reference(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    late = decode_attention_dense_reference(*args, window=window)
    np.testing.assert_allclose(late.numpy(), got.numpy(), **F32_TOL)


@pytest.mark.parametrize("window,hi", [(0, 300), (64, 300), (300, 500)])
def test_dense_decode_model_vs_jnp_twin(window, hi):
    """models.attention.decode_attention, port vs reference, f32 q over
    bf16 caches; a ring of 256 slots with cache_len up to S_max + 200
    (``hi`` - 1 = 299, and 499 for the last case) wraps some rows."""
    rng = np.random.default_rng(17 + window)
    b, s, h, kvh, dh = 4, 256, 8, 2, 64
    q = rng.normal(0, 1, (b, 1, h, dh)).astype(np.float32)
    k = _bf16_values(rng.normal(0, 1, (b, s, kvh, dh)))
    v = _bf16_values(rng.normal(0, 1, (b, s, kvh, dh)))
    cl = rng.integers(1, hi, (b,)).astype(np.int32)
    cl[0] = s + 199 if window else s - 1        # one row wrapped (ring)
    want = np.asarray(jax_decode_dense(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(cl), window=window))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                           torch.from_numpy(v).bfloat16(),
                           torch.from_numpy(cl), window=window)
    assert got.shape == (b, 1, h, dh)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("h,kvh,dh", [(24, 2, 192), (48, 1, 128),
                                      (48, 1, 192)])
@pytest.mark.parametrize("window", [0, 96])
def test_dense_decode_model_vs_jnp_twin_large_gqa(h, kvh, dh, window):
    """models.attention.decode_attention at nemotron-4-340b's head dim 192
    with 12 query heads a kv head, granite-34b's 48, and both; a ring of
    96 slots with one row wrapped; port vs reference, f32 q over bf16
    caches."""
    rng = np.random.default_rng(31 + h + dh + window)
    b, s = 3, 96
    q = rng.normal(0, 1, (b, 1, h, dh)).astype(np.float32)
    k = _bf16_values(rng.normal(0, 1, (b, s, kvh, dh)))
    v = _bf16_values(rng.normal(0, 1, (b, s, kvh, dh)))
    cl = rng.integers(1, s, (b,)).astype(np.int32)
    cl[0] = s + 40 if window else s
    want = np.asarray(jax_decode_dense(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(cl), window=window))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                           torch.from_numpy(v).bfloat16(),
                           torch.from_numpy(cl), window=window)
    assert got.shape == (b, 1, h, dh)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_dense_decode_ring_rule():
    """Once a ring has wrapped every slot is valid, so a windowed call at
    cache_len >= S_max sees the whole cache, and below S_max only the
    first cache_len slots: the same as an unwindowed call clamped to
    S_max."""
    rng = np.random.default_rng(5)
    q, k, v, _ = _dense_case(rng, 3, 96, 4, 2, 64, 0)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    cl = torch.tensor([40, 96, 250], dtype=torch.int32)
    ring = decode_attention_op(*args, cl, window=8)
    clamped = decode_attention_op(*args, torch.clamp(cl, max=96))
    assert torch.equal(ring, clamped)
    assert not torch.equal(ring[0], decode_attention_op(
        *args, torch.full((3,), 96, dtype=torch.int32))[0])


def test_dense_decode_launch_checks():
    """The checks the op makes before a CUDA launch (run here on CPU
    tensors of the right and the wrong kind): dh 64 / 128 / 192 only,
    matching shapes, contiguous bf16 and int32."""
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    kc = torch.zeros(2, 32, 2, 64, dtype=torch.bfloat16)
    cl = torch.ones(2, dtype=torch.int32)
    _check_dense(q, kc, kc, cl)
    _check_dense(torch.zeros(2, 48, 128, dtype=torch.bfloat16),
                 torch.zeros(2, 9, 1, 128, dtype=torch.bfloat16),
                 torch.zeros(2, 9, 1, 128, dtype=torch.bfloat16), cl)
    _check_dense(torch.zeros(2, 96, 192, dtype=torch.bfloat16),
                 torch.zeros(2, 9, 8, 192, dtype=torch.bfloat16),
                 torch.zeros(2, 9, 8, 192, dtype=torch.bfloat16), cl)
    bad = [
        (q[..., :32].contiguous(), kc[..., :32].contiguous(),
         kc[..., :32].contiguous(), cl, "head dim"),
        (q[:, :7].contiguous(), kc, kc, cl, "head dim"),
        (q, kc, kc[:, :16].contiguous(), cl, "mismatched"),
        (q, kc, kc, cl[:1], "mismatched"),
        (q.float(), kc, kc, cl, "contiguous"),
        (q, kc.transpose(1, 2), kc.transpose(1, 2), cl, "head dim"),
        (q, kc[:, ::2], kc[:, ::2], cl, "contiguous"),
        (q, kc, kc, cl.long(), "contiguous"),
    ]
    for args in bad:
        with pytest.raises(ValueError, match=args[-1]):
            _check_dense(*args[:-1])


@pytest.mark.parametrize("sq,sk,kvh", [(12, 12, 4), (5, 40, 2), (1, 40, 4)])
def test_encoder_attention_vs_jnp_twin(sq, sk, kvh):
    """Bidirectional attention (encoder self, prompt cross, one-query
    decode cross) through the flash op's plain version, port vs
    reference."""
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.normal(0, 1, (2, sq, 4, 64)).astype(np.float32)
    k = rng.normal(0, 1, (2, sk, kvh, 64)).astype(np.float32)
    v = rng.normal(0, 1, (2, sk, kvh, 64)).astype(np.float32)
    want = np.asarray(jax_encoder_attn(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    got = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    with pytest.raises(ValueError, match="kv_mask"):
        encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          kv_mask=torch.ones(2, sk, dtype=torch.bool))


# ------------------------------------------------------ device dispatching

def test_paged_and_flash_launch_checks_take_head_dim_192():
    """The checks the paged and flash ops make before a CUDA launch (run
    here on CPU tensors): head dims 64, 128 and 192 and any query heads
    per kv head pass; another head dim, and a pool that is not 16-byte
    aligned (the kernels copy 16-byte chunks), raise."""
    tables = torch.ones(2, 4, dtype=torch.int32)
    cl = torch.ones(2, dtype=torch.int32)
    for h, kvh, dh in [(32, 8, 64), (48, 1, 128), (96, 8, 192)]:
        q = torch.zeros(2, h, dh, dtype=torch.bfloat16)
        pool = torch.zeros(9, 16, kvh, dh, dtype=torch.bfloat16)
        _check(q, pool, pool, tables, cl)
        qf = torch.zeros(1, 64, h, dh, dtype=torch.bfloat16)
        kf = torch.zeros(1, 64, kvh, dh, dtype=torch.bfloat16)
        pos = torch.zeros(64, dtype=torch.int32)
        _check_flash(qf, kf, kf, pos, pos)
    q = torch.zeros(2, 8, 96, dtype=torch.bfloat16)
    pool = torch.zeros(9, 16, 2, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        _check(q, pool, pool, tables, cl)
    with pytest.raises(ValueError, match="head dim"):
        _check_flash(torch.zeros(1, 8, 8, 96, dtype=torch.bfloat16),
                     torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16),
                     torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16),
                     torch.zeros(8, dtype=torch.int32),
                     torch.zeros(8, dtype=torch.int32))
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    flat = torch.zeros(9 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(9, 16, 2, 64)          # 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check(q, shifted, shifted, tables, cl)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A tensor that is not on the CPU never reaches a plain version: a
    device without a kernel raises instead of falling back."""
    meta = torch.device("meta")
    q = torch.empty(1, 64, 4, 64, dtype=torch.bfloat16, device=meta)
    k = torch.empty(1, 64, 2, 64, dtype=torch.bfloat16, device=meta)
    pos = torch.empty(64, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, k, k, pos, pos)
    pool = torch.empty(4, 16, 2, 64, dtype=torch.bfloat16, device=meta)
    for op in (decode_attention_paged_op, decode_attention_paged_lse_op):
        with pytest.raises(ValueError, match="unsupported device"):
            op(q[:, 0], pool, pool,
               torch.empty(1, 2, dtype=torch.int32, device=meta),
               torch.empty(1, dtype=torch.int32, device=meta))
    s = torch.empty(8, 4, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        gittins_attained(s, s, torch.empty(8, device=meta))
    cache = torch.empty(1, 64, 2, 64, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention_op(q[:, 0], cache, cache,
                            torch.empty(1, dtype=torch.int32, device=meta))
    lanes = torch.empty(2, dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        categorical(torch.empty(2, 16, device=meta),
                    torch.empty(2, device=meta),
                    torch.empty(2, dtype=torch.bool, device=meta),
                    prng_key(0), lanes, lanes)


def test_cpu_calls_launch_nothing():
    kernels = (GITTINS_KERNEL, PAGED_DECODE_KERNEL, FLASH_PREFILL_KERNEL,
               FLASH_SPLIT_KERNEL, DENSE_DECODE_KERNEL, PAGED_LSE_KERNEL,
               CATEGORICAL_KERNEL)
    before = [k.launches for k in kernels]
    rng = np.random.default_rng(0)
    q, kp, vp, tables, cl = _paged_case(rng, 2, 4, 2, 64, 8, 8, 2)
    decode_attention_paged_op(*(torch.from_numpy(x) for x in
                                (q, kp, vp, tables, cl)))
    decode_attention_paged(*(torch.from_numpy(x) for x in
                             (q[:, None], kp, vp, tables, cl)), n_splits=2)
    x = torch.zeros(1, 8, 4, 64)
    pos = torch.arange(8, dtype=torch.int32)
    flash_attention(x, x[:, :, :2], x[:, :, :2], pos, pos)
    gittins_attained(torch.ones(8, 4), torch.full((8, 4), 0.25),
                     torch.zeros(8))
    q, k, v, cl = _dense_case(rng, 2, 32, 4, 2, 64, 8)
    decode_attention_op(*(torch.from_numpy(x) for x in (q, k, v, cl)),
                        window=8)
    encoder_attention(x, x[:, :, :2], x[:, :, :2])
    kv = torch.zeros(1, 1024, 2, 64)     # one query over 1024 keys
    flash_attention(x[:, :1], kv, kv, pos[:1],
                    torch.arange(1024, dtype=torch.int32), causal=False)
    lanes = torch.zeros(2, dtype=torch.int64)
    categorical(torch.zeros(2, 16), torch.ones(2),
                torch.tensor([False, True]), prng_key(0), lanes, lanes)
    assert before == [k.launches for k in kernels]


@pytest.mark.parametrize("sq", [1, 2, 8, 16, 17, 64])
@pytest.mark.parametrize("sk", [1, 64, 255, 256, 257, 1500, 4096])
def test_flash_key_split_sizing(sq, sk):
    """The flash op's key split: only for at most SPLIT_MAX_SQ = 16
    bidirectional queries without a window; then fixed ranges of
    SPLIT_UNITS 64-row units from key 0 (the split-KV decode template's)
    that cover the keys exactly, each a whole number of 64-row units but
    the last, and a key's range the same for any longer key count.  The
    count takes Sq, Sk and the mask's kind alone: no batch, head count or
    card enters it (its signature has none)."""
    assert SPLIT_MAX_SQ == 16
    per = SPLIT_UNITS * SPLIT_UNIT
    n = flash_key_ranges(sq, sk)
    assert flash_key_ranges(sq, sk, causal=True) == 0
    assert flash_key_ranges(sq, sk, window=64) == 0
    if sq > SPLIT_MAX_SQ:
        assert n == 0
        return
    assert n == -(-sk // per) >= 1
    ranges = [(z * per, min(sk, (z + 1) * per)) for z in range(n)]
    assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(sk))
    assert all((hi - lo) % SPLIT_UNIT == 0 for lo, hi in ranges[:-1])
    assert flash_key_ranges(sq, 2 * sk + 7) >= n


# --------------------------------------------------------- flash backward

# (b, sq, h, kvh, dh, causal, window, s_past, start): GQA, MHA and MQA,
# dh 64, 128 and 192, a window of 64, masked prefix rows (negative kv
# positions) with a query offset, and a bidirectional call
BWD_CASES = [
    (2, 96, 4, 2, 64, True, 0, 0, 0),
    (1, 80, 4, 4, 128, True, 0, 0, 0),
    (1, 72, 6, 2, 192, True, 0, 0, 0),
    (2, 160, 4, 2, 64, True, 64, 0, 0),
    (1, 64, 4, 1, 64, True, 0, 128, 77),
    (2, 8, 4, 2, 128, False, 0, 40, 40),
]


def _bwd_case(case, seed):
    b, sq, h, kvh, dh, causal, window, s_past, start = case
    rng = np.random.default_rng(seed)
    sk = s_past + sq
    q = rng.normal(0, 1, (b, sq, h, dh)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, kvh, dh)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, kvh, dh)).astype(np.float32)
    dout = rng.normal(0, 1, (b, sq, h, dh)).astype(np.float32)
    pos = start + np.arange(sq)
    past = np.arange(s_past)
    kv_pos = np.concatenate([np.where(past < start, past, -(10 ** 9)), pos])
    return q, k, v, dout, pos, kv_pos, dict(causal=causal, window=window)


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_backward_reference_vs_autograd_and_jax_vjp(case):
    """attention_backward_reference (the explicit formula the backward
    kernel computes) against torch autograd of attention_reference and
    against jax.vjp of the reference's gqa_attention, in f32."""
    q, k, v, dout, pos, kv_pos, kw = _bwd_case(case, sum(case[:5]))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tpos, tkv = torch.from_numpy(pos), torch.from_numpy(kv_pos)
    out, lse = attention_reference(tq, tk, tv, tpos, tkv, return_lse=True,
                                   **kw)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    got = attention_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), tpos, tkv, out.detach(),
        lse.detach(),
        torch.from_numpy(dout), **kw)
    _, vjp = jax.vjp(lambda a, b_, c: jax_gqa(
        a, b_, c, positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(kv_pos), **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), a.numpy(), **F32_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL,
                                   err_msg=name)


# the backward kernel's arithmetic against the exact formula: P and dS
# enter its value products as two bf16 parts each, ~2^-17 relative a
# term, which leaves the gradients ~3e-6 off in relative norm (one part
# each left them ~1.7e-3 off); the bar is 1e-4
PASSES_BAR = 1e-4


def _rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("q_scale", [1.0, 3.0], ids=["flat", "peaked"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_backward_passes_reference_vs_exact_and_jax_vjp(case,
                                                                   q_scale):
    """attention_backward_passes_reference (the kernel's arithmetic: P
    by exp2, P and dS in two bf16 parts for the value products) against
    the exact
    plain backward and against jax.vjp of the reference's gqa_attention,
    within PASSES_BAR in relative norm, on flat and peaked scores; the
    ragged tiles, the window, the masked prefix and the bidirectional
    case included."""
    q, k, v, dout, pos, kv_pos, kw = _bwd_case(case, sum(case[:5]) + 1)
    q = (q * q_scale).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    tpos, tkv = torch.from_numpy(pos), torch.from_numpy(kv_pos)
    out, lse = attention_reference(tq, tk, tv, tpos, tkv, return_lse=True,
                                   **kw)
    got = attention_backward_passes_reference(tq, tk, tv, tpos, tkv, out,
                                              lse, tdo, **kw)
    exact = attention_backward_reference(tq, tk, tv, tpos, tkv, out, lse,
                                         tdo, **kw)
    _, vjp = jax.vjp(lambda a, b_, c: jax_gqa(
        a, b_, c, positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(kv_pos), **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    for name, g, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        assert g.shape == e.shape and g.dtype == e.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel_norm(g.numpy(), e.numpy()) <= PASSES_BAR, name
        assert _rel_norm(g.numpy(), np.asarray(w)) <= PASSES_BAR, name


def test_attention_reference_lse():
    """The forward's LSE: log of the sum of exp of each row's scaled,
    visible scores, (B, H, Sq) f32; the output unchanged by asking."""
    q, k, v, _, pos, kv_pos, kw = _bwd_case(BWD_CASES[4], 5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tpos, tkv = torch.from_numpy(pos), torch.from_numpy(kv_pos)
    out, lse = attention_reference(tq, tk, tv, tpos, tkv, return_lse=True,
                                   **kw)
    assert torch.equal(out, attention_reference(tq, tk, tv, tpos, tkv,
                                                **kw))
    b, sq, h, dh = q.shape
    kr = np.repeat(k.astype(np.float64), h // k.shape[2], axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) * dh ** -0.5
    vis = (kv_pos[None, :] >= 0) & (pos[:, None] >= kv_pos[None, :])
    s = np.where(vis, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES[:3] + BWD_CASES[4:])
def test_flash_function_cpu_grads_match_plain_autograd(case):
    """flash_attention under autograd goes through FlashAttentionFunction
    (the card's saved tensors, GQA reduction and plumbing, with the plain
    versions in place of the kernels): its gradients equal plain autograd
    of attention_reference, its output the op's without grad."""
    q, k, v, dout, pos, kv_pos, kw = _bwd_case(case, 7)
    tpos = torch.from_numpy(pos).to(torch.int32)
    tkv = torch.from_numpy(kv_pos).to(torch.int32)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ins, tpos, tkv, **kw)
    assert out.grad_fn is not None \
        and "FlashAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, ins, torch.from_numpy(dout))
    ins2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        attention_reference(*ins2, tpos, tkv, **kw), ins2,
        torch.from_numpy(dout))
    with torch.no_grad():
        plain = flash_attention(*(t.detach() for t in ins), tpos, tkv, **kw)
    assert torch.equal(out.detach(), plain)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32_TOL)


def test_flash_function_only_under_autograd():
    """Without grad, or with no input requiring it, the op runs exactly
    the serving path (no Function node)."""
    q, k, v, _, pos, kv_pos, kw = _bwd_case(BWD_CASES[0], 1)
    tpos = torch.from_numpy(pos).to(torch.int32)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    assert flash_attention(*ts, tpos, tpos, **kw).grad_fn is None
    with torch.no_grad():
        t = [x.clone().requires_grad_() for x in ts]
        assert flash_attention(*t, tpos, tpos, **kw).grad_fn is None
