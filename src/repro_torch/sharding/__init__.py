"""Sharding rules and activation / serving hooks (the port of
``repro.sharding``)."""

from .context import (activation_sharding, attn_split_count,
                      constrain_activations, gather_model, serving_plan,
                      serving_sharding)
from .partitioning import (NamedSharding, batch_axes, decode_rule_table,
                           decode_rules, kv_cache_spec, logits_spec,
                           megatron_axes, named_shardings,
                           paged_kv_pool_spec, resolve_specs, rules_for,
                           shard_bytes_table, ssm_state_spec)

__all__ = ["NamedSharding", "activation_sharding", "attn_split_count",
           "batch_axes", "constrain_activations", "decode_rule_table",
           "decode_rules", "gather_model", "kv_cache_spec", "logits_spec",
           "megatron_axes", "named_shardings", "paged_kv_pool_spec",
           "resolve_specs", "rules_for", "serving_plan", "serving_sharding",
           "shard_bytes_table", "ssm_state_spec"]
