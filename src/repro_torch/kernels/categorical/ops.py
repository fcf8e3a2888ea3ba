"""The fused step's sampled draw: the hand-written CUDA kernel
(``csrc/categorical.cu``) for CUDA tensors, the plain version in ``ref.py``
for CPU tensors.  A build or launch error raises; nothing falls back.

``categorical`` takes one (lanes, n) block of logits, the columns offset ..
offset + n - 1 of the whole row (a vocab shard of a plan passes its own),
and returns each lane's (value, column) winner: for a sampled lane the
largest ``logits.float() / temps + gumbel`` with the reference's threefry
keys, for a greedy lane the largest raw logit, ties to the lowest column.
The kernel is one launch (COLUMN_BLOCKS fixed column blocks a lane, the
last of which merges the lane's partials), on
``torch.cuda.current_stream``, so a CUDA graph captures it; its partials
are allocated here, each written before it is read.

The kernel counts each lane's finished blocks in counters of its own on
the device, which the merging block sets back to 0, so two calls on one
device must not run at once.  The engine's cannot: it draws from its one
decode loop, eagerly or as a replay of a step graph, on the device's
current stream, and each draw waits in stream order for the one before.
A caller that draws on several streams orders them itself.
"""

from __future__ import annotations

import torch

from ..build import plain_here
from .kernel import CATEGORICAL_KERNEL
from .ref import MASK32, categorical as categorical_reference, prng_key

__all__ = ["categorical", "prng_key", "CATEGORICAL_KERNEL", "COLUMN_BLOCKS"]

# column blocks a lane: the kernel's grid and the partials' width (a count
# that depends neither on the batch nor on the table width)
COLUMN_BLOCKS = 64
# the widest block of logits the kernel takes: 16 columns a thread of 256,
# in each of COLUMN_BLOCKS blocks (every vocabulary of the configs)
MAX_COLUMNS = COLUMN_BLOCKS * 16 * 256


def categorical(logits: torch.Tensor, temps: torch.Tensor,
                greedy: torch.Tensor, base_key: torch.Tensor,
                rid_seeds: torch.Tensor, counters: torch.Tensor,
                offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (lanes, n) bf16 or f32, the last dim contiguous; temps:
    (lanes,) f32, the divisor of sampled lanes; greedy: (lanes,) bool;
    base_key: ``prng_key(engine seed)``, a (2,) int64 tensor on the CPU;
    rid_seeds, counters: (lanes,) int64 holding the uint32 data folded in
    (request seed, position).  Returns (value (lanes,) f32, index (lanes,)
    int64, the column within these n)."""
    dev = logits.device
    if plain_here(dev):
        return categorical_reference(logits, temps, greedy, base_key,
                                     rid_seeds, counters, offset)
    if dev.type != "cuda":
        raise ValueError(f"categorical: unsupported device {dev}")
    lanes, n = logits.shape
    if logits.dtype not in (torch.bfloat16, torch.float32) \
            or logits.stride(-1) != 1:
        raise ValueError(f"categorical: logits must be bf16 or f32 with a "
                         f"contiguous last dim, got {logits.dtype} strides "
                         f"{logits.stride()}")
    for name, t, dtype in (("temps", temps, torch.float32),
                           ("greedy", greedy, torch.bool),
                           ("rid_seeds", rid_seeds, torch.int64),
                           ("counters", counters, torch.int64)):
        if t.shape != (lanes,) or t.device != dev or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"categorical: {name} must be a contiguous "
                             f"({lanes},) {dtype} tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if base_key.device.type != "cpu" or base_key.shape != (2,):
        raise ValueError("categorical: base_key must be prng_key(seed), a "
                         "(2,) tensor on the CPU")
    if n > MAX_COLUMNS:
        raise ValueError(f"categorical: {n} columns, the kernel takes at "
                         f"most {MAX_COLUMNS}")
    if offset < 0 or offset + n > MASK32 + 1:
        raise ValueError(f"categorical: columns {offset}..{offset + n} "
                         f"exceed the uint32 counter")
    k0, k1 = (int(w) & MASK32 for w in base_key.tolist())
    partials = torch.empty((lanes, COLUMN_BLOCKS, 2), dtype=torch.int32,
                           device=dev)
    value = torch.empty(lanes, dtype=torch.float32, device=dev)
    index = torch.empty(lanes, dtype=torch.int64, device=dev)
    CATEGORICAL_KERNEL(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        logits.stride(0), temps.data_ptr(), greedy.data_ptr(),
        rid_seeds.data_ptr(), counters.data_ptr(), k0, k1,
        partials.data_ptr(), COLUMN_BLOCKS, value.data_ptr(),
        index.data_ptr(), lanes, n, offset,
        torch.cuda.current_stream(dev).cuda_stream)
    CATEGORICAL_KERNEL.launches += 1
    return value, index
