"""The fused step's sampled draw (repro_torch.kernels.categorical) against
``jax.random`` on the CPU.

The reference draws each sampled token as ``jax.random.categorical`` under
the key fold_in(fold_in(PRNGKey(engine seed), request seed), position)
(``repro/serving/engine.py:304-316``).  The port's plain version gives the
same keys and the same uniform bits, bit for bit; its Gumbel noise differs
from XLA's only by the two logarithms (torch's CPU ``log`` is not XLA's),
within GUMBEL_ATOL; and its tokens equal JAX's, where a flip is allowed
only on a lane whose two best scores lie within NEAR_TIE of each other.
The JAX settings the bits follow are asserted first, so that a change in
JAX fails here and not as streams that part for no visible reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.build import shape_pass
from repro_torch.kernels.categorical import categorical, prng_key
from repro_torch.kernels.categorical.ref import (fold_in, gumbel, lane_keys,
                                                 threefry2x32, uniform)
from repro_torch.testing.sampling import EDGE_N, edge_rows

torch.set_num_threads(1)

# |port - XLA| of the noise: two ulps of a draw in [8, 16), one above 16
# (the largest is -log(-log(1 - 2**-24)) = 16.6); 9.5e-7 seen at 16 x
# 128256 draws
GUMBEL_ATOL = 2e-6
# a token may differ from JAX's only where the plain version's two best
# scores lie within NEAR_TIE * max(1, |best|) of each other
NEAR_TIE = 4e-6
TINY = np.finfo(np.float32).tiny
REQUEST_SEEDS = np.array([0, 1, 12345, 2**31, 2**32 - 1, 2**31 - 1],
                         np.uint32)
COUNTERS = np.array([0, 1, 2, 4095, 4096, 77], np.uint32)


def _jax_keys(engine_seed, seeds, counters):
    base = jax.random.PRNGKey(engine_seed)
    return jax.vmap(lambda s, c: jax.random.fold_in(
        jax.random.fold_in(base, s), c))(jnp.asarray(seeds, jnp.uint32),
                                         jnp.asarray(counters, jnp.uint32))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_jax_settings_the_draw_follows():
    """The settings ``ref.py`` states: threefry2x32, partitionable
    counters, the low-range Gumbel, and PRNGKey without 64-bit seeds."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("key, count, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0))])
def test_threefry_known_answers(key, count, want):
    """The Random123 known-answer vectors of threefry2x32-20, which JAX's
    own tests hold its threefry to."""
    y0, y1 = threefry2x32(*key, *count)
    assert (int(y0), int(y1)) == want


@pytest.mark.parametrize("engine_seed", [0, 1, 7, 2**31 - 1])
def test_keys_bit_identical(engine_seed):
    """prng_key, one fold_in and both fold_ins equal ``jax.random``'s key
    data, for request seeds 0 .. 2**32 - 1 and counters up to 4096."""
    base = jax.random.PRNGKey(engine_seed)
    assert prng_key(engine_seed).tolist() == \
        np.asarray(jax.random.key_data(base)).tolist()
    once = jax.vmap(lambda s: jax.random.key_data(
        jax.random.fold_in(base, s)))(jnp.asarray(REQUEST_SEEDS))
    assert np.array_equal(
        fold_in(prng_key(engine_seed), _t(REQUEST_SEEDS)).numpy(),
        np.asarray(once).astype(np.int64))
    twice = jax.random.key_data(_jax_keys(engine_seed, REQUEST_SEEDS,
                                          COUNTERS))
    assert np.array_equal(
        lane_keys(prng_key(engine_seed), _t(REQUEST_SEEDS),
                  _t(COUNTERS)).numpy(),
        np.asarray(twice).astype(np.int64))


def test_uniform_bits_and_gumbel_match_jax():
    """The uniform's bits equal ``jax.random.uniform(key, (V,),
    minval=tiny, maxval=1.)``'s; the noise is within GUMBEL_ATOL of
    ``jax.random.gumbel``'s."""
    v = 50304
    keys = _jax_keys(0, REQUEST_SEEDS, COUNTERS)
    tk = _t(jax.random.key_data(keys))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (v,), minval=TINY, maxval=1.))(keys))
    got = uniform(tk, v).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= TINY and got.max() < 1.0
    g_want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(keys))
    err = np.abs(gumbel(tk, v).numpy() - g_want)
    assert err.max() <= GUMBEL_ATOL, err.max()


def _near_tie_flips(scores, tokens, want):
    """How many lanes pick another token than ``want``; each such lane
    must be a near tie of the plain version's scores (lanes, V)."""
    flips = np.nonzero(tokens != want)[0]
    for lane in flips:
        top2 = np.sort(scores[lane])[-2:]
        assert top2[1] - top2[0] <= NEAR_TIE * max(1.0, abs(top2[1])), \
            (lane, top2)
    return len(flips)


@pytest.mark.parametrize("temperature", [0.3, 0.6, 1.0])
@pytest.mark.parametrize("vocab", [40, 50304, 128256])
def test_tokens_equal_jax_categorical(vocab, temperature):
    """``categorical`` (on the CPU, the plain version) picks what
    ``jax.vmap(jax.random.categorical)(keys, logits / t)`` picks on its
    sampled lanes and ``argmax`` on its greedy ones."""
    lanes = 6
    rng = np.random.default_rng(vocab + int(temperature * 10))
    logits = rng.normal(0, 3, (lanes, vocab)).astype(np.float32)
    temps = np.full(lanes, temperature, np.float32)
    greedy = np.zeros(lanes, bool)
    greedy[2] = True
    safe_t = np.where(greedy, 1.0, temps).astype(np.float32)
    keys = _jax_keys(3, REQUEST_SEEDS, COUNTERS)
    want = np.array(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits) / safe_t[:, None]))
    want[greedy] = logits[greedy].argmax(axis=1)
    value, index = categorical(
        torch.from_numpy(logits), torch.from_numpy(safe_t),
        torch.from_numpy(greedy), prng_key(3), _t(REQUEST_SEEDS),
        _t(COUNTERS))
    noise = gumbel(_t(jax.random.key_data(keys)), vocab).numpy()
    scores = np.where(greedy[:, None], logits,
                      logits / safe_t[:, None] + noise)
    assert _near_tie_flips(scores, index.numpy(), want) == 0
    assert np.array_equal(value[greedy].numpy(), logits[greedy].max(axis=1))


def test_shard_parts_are_the_whole_row():
    """Parts at their offsets, concatenated, are the whole row's noise bit
    for bit, and their winners merged by value (ties to the earlier part)
    are the whole row's pick."""
    v, cuts = 1000, (0, 250, 500, 750, 1000)
    keys = lane_keys(prng_key(0), _t(REQUEST_SEEDS), _t(COUNTERS))
    whole = gumbel(keys, v)
    parts = [gumbel(keys, b - a, offset=a) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts, dim=1), whole)
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(0, 1, (6, v)).astype(np.float32))
    logits[0, 10] = logits[0, 600] = 50.0          # a tie across parts
    temps = torch.full((6,), 0.6)
    greedy = torch.tensor([True, False, False, True, False, False])
    args = (prng_key(0), _t(REQUEST_SEEDS), _t(COUNTERS))
    want_v, want_i = categorical(logits, temps, greedy, *args)
    best_v = best_i = None
    for a, b in zip(cuts, cuts[1:]):
        pv, pi = categorical(logits[:, a:b], temps, greedy, *args, offset=a)
        pi = pi + a
        if best_v is None:
            best_v, best_i = pv, pi
        else:
            better = pv > best_v
            best_v = torch.where(better, pv, best_v)
            best_i = torch.where(better, pi, best_i)
    assert torch.equal(best_i, want_i) and torch.equal(best_v, want_v)
    assert int(want_i[0]) == 10


def test_op_outputs_and_meta_shape_pass():
    """The op's outputs (f32 values, int64 columns, a greedy lane's ties to
    column 0); on meta inside the dry-run's shape pass it takes the plain
    version's shapes (outside it meta raises:
    tests/test_torch_kernels.py::test_wrappers_refuse_non_cpu_non_cuda_tensors)."""
    logits = torch.zeros(2, 16, dtype=torch.bfloat16)
    args = (torch.ones(2), torch.tensor([False, True]), prng_key(0),
            torch.tensor([1, 2]), torch.tensor([0, 0]))
    v, i = categorical(logits, *args)
    assert v.dtype == torch.float32 and i.dtype == torch.int64
    assert int(i[1]) == 0 and float(v[1]) == 0.0
    meta = [t if t is args[2] else t.to("meta") for t in args]
    with shape_pass():
        v, i = categorical(logits.to("meta"), *meta)
    assert v.shape == (2,) and i.shape == (2,) and i.device.type == "meta"


# ------------------------------------------------------- hand-made rows

# (lane, dtype) of each hand-made row the plain version is held to: every
# named lane in f32, and in bf16 all but lane 5, whose exact tie is made in
# f32 and rounds away in bf16
_ROWS = ([(lane, torch.float32) for lane in (0, 1, 2, 3, 4, 5, 6, 7)]
         + [(lane, torch.bfloat16) for lane in (0, 1, 2, 3, 4, 6, 7)])


@pytest.mark.parametrize("lane, dtype", _ROWS)
def test_hand_made_rows(lane, dtype):
    """The hand-made rows (``repro_torch.testing.sampling``): the plain
    version picks the column each lane was made for (a clear winner, the
    first NaN of a sampled and of a greedy lane, column 0 of an all -inf
    row, the lower column of a tie of raw logits and of exact scores, the
    first +inf), with the value that column scores."""
    rows = edge_rows(dtype=dtype)
    value, index = categorical(*rows.args)
    col = rows.want[lane]
    assert int(index[lane]) == col
    logits, temps, greedy, base, seeds, counters = rows.args
    x = logits[lane, col].float()
    if greedy[lane]:
        want = x
    else:
        keys = lane_keys(base, seeds[lane:lane + 1], counters[lane:lane + 1])
        want = x / temps[lane] + gumbel(keys, EDGE_N)[0, col]
    torch.testing.assert_close(value[lane], want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_hand_made_rows_on_vocab_shards(parts):
    """The hand-made rows cut into vocab shards at their offsets, each
    drawn alone and merged by value, ties to the earlier shard (as the
    engine's ``_sample_sharded`` merges them): the whole row's (value,
    column) on every lane without a NaN (the merge lets a later shard's
    NaN lose, the whole row's argmax lets it win)."""
    rows = edge_rows()
    want_v, want_i = categorical(*rows.args)
    logits = rows.args[0]
    bounds = np.linspace(0, EDGE_N, parts + 1).astype(int)
    best_v = best_i = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        v, i = categorical(logits[:, lo:hi], *rows.args[1:], offset=int(lo))
        i = i + int(lo)
        if best_v is None:
            best_v, best_i = v, i
        else:
            better = v > best_v
            best_v = torch.where(better, v, best_v)
            best_i = torch.where(better, i, best_i)
    lanes = [k for k in range(logits.shape[0])
             if not bool(logits[k].isnan().any())]
    assert len(lanes) == 8
    assert torch.equal(best_i[lanes], want_i[lanes])
    assert torch.equal(best_v[lanes], want_v[lanes])
