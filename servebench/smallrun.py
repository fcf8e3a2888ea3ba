"""A cell cut to a size the CPU runs in seconds, for the benchmark's own
tests: the configuration's reduced model (2 layers, width 256, a 512-id
vocabulary), 4 slots of 256 tokens, 64-token chunks, and the cell's mix
with lengths clipped to 64 in and 8 out."""

from __future__ import annotations

import copy

__all__ = ["small_cell", "SEED"]

SEED = 2**31 + 12345


def small_cell(workload: str):
    """(configuration, mix, model config) of ``workload`` at the small
    size."""
    from servebench.harness import arch_of, port_config
    from servebench.run import load_cell
    _, _, cfg, mix = load_cell(workload)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    mc = port_config(cfg, reduced=True)
    cfg["arch"] = arch_of(mc)
    cfg["engine"].update(n_slots=4, max_seq_len=256, capacity_tokens=4096,
                         prefill_chunk=64, max_tokens_per_step=68)
    mix.update(max_input=64, max_output=8)
    if mix["kind"] == "poisson":
        mix.update(rate_rps=4.0, prelude_s=2.0)
    else:
        mix.update(refill_pool=200)
    return cfg, mix, mc
