"""Hand-made rows of the fused step's sampled draw
(``repro_torch.kernels.categorical``): a clear winner, NaN, -inf and +inf
columns, ties, greedy and sampled lanes, each with the column the draw
must pick.  The CPU tests hold the plain version to them; on the card
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the kernel to the
plain version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.categorical.ref import gumbel, lane_keys, prng_key

__all__ = ["EDGE_N", "EDGE_SEED", "EdgeRows", "edge_rows"]

# columns a row: about 79 in each of the kernel's 64 column blocks
# (ops.COLUMN_BLOCKS), so that the special columns of a row lie in
# different blocks
EDGE_N = 5000
EDGE_SEED = 5
_LANES = 10
_TOP = 30.0    # above any other column's a + noise (|x| < 6, noise < 16)


class EdgeRows:
    """The draw's arguments (``args``: logits, temps, greedy, base key,
    request seeds, counters) and the columns it must pick (``want``: lane
    -> column; the lanes not named are plain random draws; lane 5's exact
    tie is made from the CPU's noise, and holds on the card where its log
    equals the CPU's)."""

    def __init__(self, args, want):
        self.args, self.want = args, want


def _f32(v) -> np.float32:
    return np.float32(v)


def edge_rows(device="cpu", dtype=torch.float32) -> EdgeRows:
    """The hand-made rows on ``device`` with logits of ``dtype`` (the tie
    columns are exact in f32; in bf16 they round, and the rows stay valid
    draws).  Lanes: 0 a clear winner (sampled, t 1); 1 NaN columns
    (sampled); 2 and 3 all -inf (sampled, greedy); 4 a tie of raw logits
    (greedy); 5 a tie of exact scores (sampled, t 1); 6 +inf columns
    (sampled); 7 NaN columns (greedy); 8 and 9 plain draws (sampled at t
    0.3, greedy)."""
    n = EDGE_N
    rng = np.random.default_rng(28)
    x = rng.normal(0.0, 1.0, (_LANES, n)).astype(np.float32)
    temps = np.array([1.0, 0.6, 0.6, 1.0, 1.0, 1.0, 0.6, 1.0, 0.3, 1.0],
                     np.float32)
    greedy = np.array([False, False, False, True, True, False, False, True,
                       False, True])
    seeds = np.array([0, 1, 2**31, 2**32 - 1, 7, 12345, 99, 3, 4, 5],
                     np.int64)
    counters = np.arange(_LANES, dtype=np.int64) * 131
    base = prng_key(EDGE_SEED)
    noise = gumbel(lane_keys(base, torch.from_numpy(seeds),
                             torch.from_numpy(counters)), n).numpy()
    x[8:] *= 3           # the plain draws at std 3

    # lane 0: a clear winner
    top = 4321
    x[0, top] = _TOP
    # lane 1: NaN columns
    x[1, [700, 3100]] = np.nan
    # lanes 2, 3: all -inf
    x[2] = x[3] = -np.inf
    # lane 4: a tie of raw logits
    x[4, [1234, 4000]] = 9.0
    # lane 5: two columns whose exact scores tie (t 1: a = x)
    first, second = 321, 4800
    x[5, first] = _TOP
    score = _f32(x[5, first]) + _f32(noise[5, first])
    g2 = _f32(noise[5, second])
    near = [_f32(score) - g2]
    for step in (np.inf, -np.inf):
        c = near[0]
        for _ in range(8):
            c = np.nextafter(c, _f32(step))
            near.append(c)
    x[5, second] = next(c for c in near if _f32(c + g2) == score)
    # lane 6: +inf columns; lane 7: NaN columns of a greedy lane
    x[6, [2222, 4444]] = np.inf
    x[7, [10, 4999]] = np.nan
    want = {0: top, 1: 700, 2: 0, 3: 0, 4: 1234, 5: first, 6: 2222, 7: 10}
    dev = torch.device(device)
    args = (torch.from_numpy(x).to(dtype).to(dev),
            torch.from_numpy(temps).to(dev), torch.from_numpy(greedy).to(dev),
            base, torch.from_numpy(seeds).to(dev),
            torch.from_numpy(counters).to(dev))
    return EdgeRows(args, want)
