"""Plain PyTorch version of the fused step's sampled draw: JAX's threefry2x32
``PRNGKey`` / ``fold_in`` and Gumbel-max ``categorical``, bit for bit up to
the two logarithms.

The reference draws a sampled token as (``repro/serving/engine.py:304-316``)

    key = fold_in(fold_in(PRNGKey(engine seed), crc32(request id)), position)
    tok = jax.random.categorical(key, logits.astype(f32) / temperature)

These functions give the same bits under the JAX settings this follows
(``tests/test_torch_sampling.py`` asserts each on the reference side):

- ``jax_default_prng_impl`` = ``threefry2x32`` (20 rounds, rotations
  (13, 15, 26, 6) / (17, 29, 16, 24), a key injection every 4 rounds with
  k2 = k0 ^ k1 ^ 0x1BD11BDA);
- ``jax_threefry_partitionable`` True: element j of a draw of shape (n,)
  is threefry of the counter (0, j), its 32 bits the first word XOR the
  second;
- ``jax_high_dynamic_range_gumbel`` False (Gumbel mode "low"): the uniform
  ``(bits >> 9 | 0x3F800000) as f32 - 1``, times (1 - tiny) (1.0 in f32),
  plus tiny, at least tiny, and the noise ``-log(-log u)``.

``PRNGKey(seed)`` without 64-bit mode is the pair (0, seed mod 2**32);
``fold_in(key, d)`` is threefry of the counter (0, d).  A key is an int64
tensor whose last axis holds the two uint32 words; every integer tensor
here holds values in [0, 2**32) in int64 (sums masked, no product), so the
CPU and the card compute the same bits.  The logarithms are torch's: on
the CPU they may differ from XLA's by an ulp (the tests bound it), on the
card they are the kernel's IEEE ``logf``.
"""

from __future__ import annotations

import torch

__all__ = ["MASK32", "TINY", "threefry2x32", "prng_key", "fold_in",
           "lane_keys", "uniform", "gumbel", "categorical"]

MASK32 = 0xFFFFFFFF
TINY = torch.finfo(torch.float32).tiny
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1); int64 tensors (or ints) of uint32 values that
    broadcast together.  Returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & MASK32
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (64-bit mode off): (2,) int64."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of keys (..., 2) and uint32 data (...)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data & MASK32)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def lane_keys(base_key: torch.Tensor, rid_seeds: torch.Tensor,
              counters: torch.Tensor) -> torch.Tensor:
    """The reference's per-lane key, fold_in(fold_in(base, seed),
    counter): (lanes, 2)."""
    base = base_key.to(rid_seeds.device)
    return fold_in(fold_in(base, rid_seeds), counters)


def uniform(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, (offset + n,), minval=tiny, maxval=1.)``
    columns offset .. offset + n - 1, per key of keys (lanes, 2): (lanes,
    n) f32."""
    col = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=keys.device)
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], 0, col[None, :])
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    scale = torch.tensor(1.0 - TINY, dtype=torch.float32)    # 1.0 in f32
    return torch.clamp(f * scale + TINY, min=TINY)


def gumbel(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """The Gumbel noise ``jax.random.gumbel(key, (offset + n,))`` (mode
    "low") draws at columns offset .. offset + n - 1: (lanes, n) f32."""
    return -torch.log(-torch.log(uniform(keys, n, offset)))


def categorical(logits: torch.Tensor, temps: torch.Tensor,
                greedy: torch.Tensor, base_key: torch.Tensor,
                rid_seeds: torch.Tensor, counters: torch.Tensor,
                offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The winner of each lane of ``logits`` (lanes, n), the columns
    offset .. offset + n - 1 of the whole row: (value f32, index int64,
    the index within these columns).

    A sampled lane scores ``logits.float() / temps + gumbel``, as the
    reference adds ``logits.astype(f32) / safe_t`` to its Gumbel draw; a
    greedy lane scores its raw logit.  The winner is the largest score
    (NaN the largest), ties to the lowest column, as ``torch.argmax``
    picks; shards merged by value, ties to the earlier shard, give the
    whole row's pick."""
    score = logits.float()
    keys = lane_keys(base_key, rid_seeds.long(), counters.long())
    noise = gumbel(keys, logits.shape[-1], offset)
    sampled = score / temps.float()[:, None] + noise
    score = torch.where(greedy.bool()[:, None], score, sampled)
    value, index = score.max(dim=-1)
    return value, index
