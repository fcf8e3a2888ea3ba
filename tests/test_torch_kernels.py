"""Port kernels (repro_torch.kernels) against the JAX package's Pallas
kernels, run in interpret mode, and against its jnp twins.

On the CPU each op takes its plain PyTorch version, so these tests hold
the plain versions to the reference (tests/test_torch_gpu.py holds the
CUDA kernels to the plain versions on the card).  Inputs are made with numpy
from a seed and handed to both sides.  Tolerances: 1e-5 in f32 and 2e-2
in bf16 (the JAX package's own kernel bar, tests/test_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_paged_op \
    as jax_paged_op
from repro.kernels.flash_attention.ops import flash_attention \
    as jax_flash
from repro.models.attention import decode_attention_paged \
    as jax_decode_paged
from repro.models.attention import gqa_attention as jax_gqa
from repro_torch.kernels.decode_attention.ops import (
    PAGED_DECODE_KERNEL, decode_attention_paged_op)
from repro_torch.kernels.flash_attention.ops import (FLASH_PREFILL_KERNEL,
                                                     flash_attention)
from repro_torch.kernels.gittins.ops import (GITTINS_KERNEL,
                                             gittins_attained)
from repro_torch.models.attention import (combine_lse_partials,
                                          decode_attention_paged,
                                          gqa_attention)

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


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


def test_paged_decode_n_splits_not_ported():
    x = torch.zeros(1, 1, 4, 64)
    pool = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Queue A 10"):
        decode_attention_paged(x, pool, pool, torch.ones(1, 1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32), n_splits=2)


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


# ------------------------------------------------------ device dispatching

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
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention_paged_op(
            q[:, 0], pool, pool,
            torch.empty(1, 2, dtype=torch.int32, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta))
    s = torch.empty(8, 4, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        gittins_attained(s, s, torch.empty(8, device=meta))


def test_cpu_calls_launch_nothing():
    before = (GITTINS_KERNEL.launches, PAGED_DECODE_KERNEL.launches,
              FLASH_PREFILL_KERNEL.launches)
    rng = np.random.default_rng(0)
    q, kp, vp, tables, cl = _paged_case(rng, 2, 4, 2, 64, 8, 8, 2)
    decode_attention_paged_op(*(torch.from_numpy(x) for x in
                                (q, kp, vp, tables, cl)))
    x = torch.zeros(1, 8, 4, 64)
    pos = torch.arange(8, dtype=torch.int32)
    flash_attention(x, x[:, :, :2], x[:, :, :2], pos, pos)
    gittins_attained(torch.ones(8, 4), torch.full((8, 4), 0.25),
                     torch.zeros(8))
    assert before == (GITTINS_KERNEL.launches, PAGED_DECODE_KERNEL.launches,
                      FLASH_PREFILL_KERNEL.launches)
