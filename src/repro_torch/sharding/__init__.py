"""Sharding rules and serving hooks for tensor-parallel serving (the
serving half of ``repro.sharding``)."""

from .context import (attn_split_count, gather_model, serving_plan,
                      serving_sharding)
from .partitioning import (decode_rule_table, decode_rules, megatron_axes,
                           paged_kv_pool_spec, resolve_specs,
                           shard_bytes_table)

__all__ = ["attn_split_count", "decode_rule_table", "decode_rules",
           "gather_model", "megatron_axes", "paged_kv_pool_spec",
           "resolve_specs", "serving_plan", "serving_sharding",
           "shard_bytes_table"]
