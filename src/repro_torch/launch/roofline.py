"""Roofline terms of a step on the H100 (the port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds per step:

    compute    = FLOPs_per_device / HW["peak_flops"]
    memory     = bytes_per_device / HW["hbm_bw"]
    collective = collective_bytes_per_device / HW["link_bw"]

with the reference's arithmetic (``roofline_terms``, ``analytic_floors``,
``model_flops``, ``decode_flop_split``) unchanged; only the peaks are the
card's.  The reference's ``collective_bytes`` sums the collectives of
XLA's optimized HLO text; the port has no compiler that writes the
collectives of a step down (the serving plan issues its own), so it has no
counterpart here, and the dry-run reports those fields as not measured.
"""

from __future__ import annotations

__all__ = ["HW", "roofline_terms", "analytic_floors", "model_flops",
           "decode_flop_split"]

# NVIDIA H100 SXM5 80 GB (700 W), from NVIDIA's H100 Tensor Core GPU
# datasheet: dense bf16 tensor-core peak, HBM3 bandwidth and NVLink 4
# bandwidth per direction (900 GB/s both ways).  ``hbm_bytes`` is the
# ``total_memory`` that torch.cuda.get_device_properties(0) reports on an
# "NVIDIA H100 80GB HBM3" at a 700 W power limit (chip_smoke.py prints the
# card's own figure beside it).
HW = {
    "peak_flops": 989e12,          # bf16 / device, dense
    "hbm_bw": 3.35e12,             # bytes/s / device
    "hbm_bytes": 85_017_493_504,   # per device
    "link_bw": 450e9,              # bytes/s / device, NVLink 4, one way
}


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, hw: dict = HW) -> dict:
    compute = flops_per_chip / hw["peak_flops"]
    memory = bytes_per_chip / hw["hbm_bw"]
    collective = coll_bytes_per_chip / hw["link_bw"]
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    return terms


def analytic_floors(cfg, shape, n_chips: int) -> dict:
    """Closed-form lower bounds on per-device FLOPs and HBM bytes per step
    (2ND inference / 6ND training FLOPs; one weight read plus the KV
    traffic for memory) and a collective floor, as the reference's; the
    dry-run reports max(counted, floor)."""
    n_active = cfg.active_param_count()
    param_bytes = cfg.param_count() * 2  # bf16
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in ("ssm", "hybrid"):
        kv_bpt = 0.0
    else:
        kv_bpt = (cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
    mp = max(1, cfg.model_parallel)
    data_par = max(1, n_chips // mp)
    coll = 0.0
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        # fwd + bwd weight reads + grad write + opt read/write (bf16-ish)
        mem = 4.0 * param_bytes * max(1, cfg.grad_accum) \
            + 2.0 * tokens * kv_bpt
        # FSDP per-layer weight gathers (fwd + bwd, per microbatch) and
        # the gradient reduce-scatter / all-gather
        if cfg.fsdp:
            coll += (2.0 * max(1, cfg.grad_accum) * param_bytes / mp
                     * (1.0 - 1.0 / data_par))
        coll += 2.0 * param_bytes / mp * (1.0 - 1.0 / data_par)  # grad AR
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens \
            + 2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * B * S * S
        mem = param_bytes + tokens * kv_bpt
        # TP: one activation all-gather + one reduce per layer (per chip)
        coll += 2.0 * cfg.n_layers * (tokens / data_par) * cfg.d_model * 2
    else:  # decode: one token per sequence over the full cache
        s_cache = (cfg.window if cfg.attention_kind == "sliding_window"
                   else S)
        flops = 2.0 * n_active * B \
            + 2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * B * s_cache
        mem = param_bytes + B * s_cache * kv_bpt
        coll += 2.0 * cfg.n_layers * (B / data_par) * cfg.d_model * 2
    return {"flops_floor": flops / n_chips, "bytes_floor": mem / n_chips,
            "collective_floor": coll}


def model_flops(cfg, shape, n_chips: int) -> float:
    """Useful model FLOPs per step per device: 6 N D train, 2 N D
    inference (N = active parameters for MoE)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    return mult * n_active * tokens / n_chips


def decode_flop_split(cfg, *, tp: int, parallel: str, batch: int,
                      s_cache: int) -> dict:
    """Per-decode-step FLOPs split by placement under the serving rule
    table (``decode_rule_table``): the FLOPs each sharded component sheds
    per device (``off_replica``: its FLOPs times 1 - 1/tp) against those
    every device repeats (``replicated``)."""
    from ..sharding.partitioning import decode_rule_table
    rules, report = decode_rule_table(cfg, tp, parallel=parallel)
    D, dh = cfg.d_model, cfg.head_dim
    H, KV, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    gate = 3 if cfg.activation == "swiglu" else 2

    # (flops per token, sharded?) per component
    comp = {
        "qkv_proj": (2.0 * D * (H + 2 * KV) * dh * L,
                     rules.get("heads") is not None),
        "wo_proj": (2.0 * H * dh * D * L,
                    rules.get("heads_out") is not None),
        # scores + weighted sum over the cache; the LSE split stripes the
        # page axis, so attention divides even where the kv heads do not
        "attention": (4.0 * H * dh * s_cache * L,
                      rules.get("pool_kv") is not None
                      or report["attention"] == "lse-split"),
        "lm_head": (2.0 * D * cfg.padded_vocab,
                    rules.get("vocab") is not None),
    }
    if cfg.family == "moe":
        moe_layers = L - cfg.first_k_dense
        routed = (2.0 * gate * D * cfg.moe_d_ff * cfg.experts_per_token
                  * moe_layers)
        shared = (2.0 * gate * D * cfg.moe_d_ff * cfg.n_shared_experts
                  * moe_layers)
        comp["moe_routed"] = (routed, rules.get("expert") is not None)
        # shared experts are a plain MLP: they follow the mlp axis
        comp["moe_shared"] = (shared, rules.get("mlp") is not None)
        if cfg.first_k_dense:
            dff = cfg.dense_d_ff or cfg.d_ff
            comp["mlp"] = (2.0 * gate * D * dff * cfg.first_k_dense,
                           rules.get("mlp") is not None)
    else:
        comp["mlp"] = (2.0 * gate * D * cfg.d_ff * L,
                       rules.get("mlp") is not None)

    total = sum(f for f, _ in comp.values()) * batch
    sharded = sum(f for f, s in comp.values() if s) * batch
    off = sharded * (1.0 - 1.0 / max(1, tp))
    return {
        "tp": tp, "parallel": parallel,
        "total_flops": total,
        "sharded_flops": sharded,
        "replicated_flops": total - sharded,
        "off_replica_flops": off,
        "per_device_flops": total - off,
        "components": {k: {"flops": f * batch, "sharded": s}
                       for k, (f, s) in comp.items()},
    }
