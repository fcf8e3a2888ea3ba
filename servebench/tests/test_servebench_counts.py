"""Operation and byte counts against hand counts at small shapes, and the
trace reader's interval arithmetic."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from servebench import counts  # noqa: E402
from servebench.trace import (TraceSummary, breakdown, idle_gaps,  # noqa: E402
                              label_gaps, union_length)

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab_size": 10}
MOE = dict(DENSE, n_experts=4, experts_per_token=2, moe_d_ff=3)


def test_decode_attention_bytes_by_hand():
    # lanes with 5 and 7 keys: 12 tokens x 2 (K, V) x 2 layers x 2 kv
    # heads x 2 dims x 2 bytes, plus 2 lanes x (q, o) x 2 layers x 4
    # heads x 2 dims x 2 bytes
    want = 12 * 2 * 2 * 2 * 2 * 2 + 2 * 2 * 2 * 4 * 2 * 2
    assert counts.decode_attention_bytes(DENSE, 12, 2) == want


def test_causal_chunk_flops_by_hand():
    # a chunk of 3 tokens at positions 4, 5, 6 sees 5 + 6 + 7 keys
    keys = 5 + 6 + 7
    want = keys * 4 * 4 * 2 * 2        # 4 flops x heads x head_dim x layers
    assert counts.causal_chunk_flops(DENSE, 4, 3) == want
    assert counts.causal_chunk_flops(DENSE, 0, 1) == 1 * 4 * 4 * 2 * 2


def test_dense_and_moe_token_flops_by_hand():
    # q, o: 8 x 8 each; k, v: 8 x 4 each; SwiGLU: 3 x 8 x 16
    per_layer = 8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16
    assert counts.linear_flops_per_token(DENSE) == 2 * 2 * per_layer
    # the router 8 x 4 and 2 experts of 3 x 8 x 3, not the padded buffer
    moe_layer = 8 * 8 * 2 + 8 * 4 * 2 + 8 * 4 + 2 * 3 * 8 * 3
    assert counts.linear_flops_per_token(MOE) == 2 * 2 * moe_layer
    assert counts.head_flops_per_token(DENSE) == 2 * 8 * 10
    # a decode step of 2 lanes over 12 keys in all
    assert counts.decode_flops(DENSE, 12, 2) == 2 * (
        2 * 2 * per_layer + 2 * 8 * 10) + 12 * 4 * 4 * 2 * 2
    # a prefill chunk: no head
    assert counts.prefill_flops(MOE, 4, 3) == 3 * 2 * 2 * moe_layer \
        + counts.causal_chunk_flops(MOE, 4, 3)


def test_chunk_attention_bytes_by_hand():
    # q and o of 3 tokens, K and V of 7 positions, 2 layers
    want = 2 * 3 * 4 * 2 * 2 * 2 + 7 * 2 * 2 * 2 * 2 * 2
    assert counts.chunk_attention_bytes(DENSE, 4, 3) == want


def test_union_not_sum_of_overlapping_streams():
    busy, merged = union_length([(0, 4), (2, 6), (8, 9), (8.5, 8.7)])
    assert busy == pytest.approx(7.0)
    assert merged == [[0, 6], [8, 9]]
    assert idle_gaps(merged, -1, 12) == [(-1, 0), (6, 8), (9, 12)]


def test_gaps_labelled_by_innermost_span():
    spans = [("step", 0.0, 10.0), ("order", 1.0, 2.0), ("submit", 11.0, 12.0)]
    got = label_gaps([(1.2, 1.6), (5.0, 6.0), (10.2, 10.8), (11.1, 11.9)],
                     spans)
    assert got == [("order", pytest.approx(0.4)), ("step", 1.0),
                   ("harness", pytest.approx(0.6)),
                   ("submit", pytest.approx(0.8))]
    ts = TraceSummary(window_s=1.0, busy_s=0.5,
                      kernel_s={"void k<1>()": 0.2, "m": 0.3},
                      gaps=[("step", 0.1), ("order", 0.3)])
    b = breakdown(ts)
    assert b["device_ops"] == [["m", 0.3], ["k<1>()", 0.2]]
    assert b["idle_gaps"] == [["order", 0.3], ["step", 0.1]]
