"""Registry of the 10 assigned architectures and 4 input shapes."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.config import ModelConfig

__all__ = ["ARCH_IDS", "SHAPE_IDS", "InputShape", "get_config", "get_shape",
           "iter_configs"]

ARCH_IDS = (
    "qwen2-1.5b",
    "olmoe-1b-7b",
    "nemotron-4-340b",
    "deepseek-moe-16b",
    "seamless-m4t-medium",
    "mamba2-2.7b",
    "llama3.2-1b",
    "internvl2-76b",
    "granite-34b",
    "zamba2-1.2b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
SHAPE_IDS = tuple(_SHAPES)


def get_shape(name: str) -> InputShape:
    return _SHAPES[name]


def get_config(arch: str, *, reduced: bool = False,
               long_context: bool = False) -> ModelConfig:
    """Load an architecture config.

    reduced: smoke-test variant (2 layers, d_model<=256, <=4 experts).
    long_context: apply the arch's documented long_500k variant (sliding-
        window attention for dense/MoE/VLM; native for SSM/hybrid).
    """
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    cfg: ModelConfig = mod.CONFIG
    if long_context:
        if not hasattr(mod, "LONG_CONTEXT"):
            raise ValueError(
                f"{arch} has no long-context variant (see DESIGN.md skips)")
        cfg = mod.LONG_CONTEXT
    if reduced:
        cfg = cfg.reduced()
    return cfg


def iter_configs(reduced: bool = False):
    for a in ARCH_IDS:
        yield a, get_config(a, reduced=reduced)
