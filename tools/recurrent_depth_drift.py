"""How far the port's dense-cache decode of a recurrent model drifts from a
teacher-forced forward, by depth and compute dtype, on the CPU.

    PYTHONPATH=src python tools/recurrent_depth_drift.py \
        [--arch mamba2-2.7b] [--depths 2 16 64] [--prompt 64] [--steps 16]

For each depth (the config cut to that many layers, full width, random
weights of seed 0) and each of f32 and bf16 (weights and dense cache in
that dtype), runs ``Model.prefill`` on one random prompt, ``--steps``
greedy ``Model.decode_step`` calls, and a teacher-forced ``Model.forward``
over prompt + generated tokens, then prints the largest logit difference
in bf16 steps at the forward's largest |logit| (the bar unit of
``repro_torch.testing.generate.teacher_forced_check``) and how many
greedy picks equal the forward's argmax.  Beside it, the model's own
sensitivity to rounding: the same forward with every embedding weight
moved by about one unit in the last place of the dtype (2^-23 relative
in f32, 2^-7 in bf16, random signs), in the same steps.  Where the two
are alike, decode and forward part by rounding that the depth amplifies,
not by a different computation.  At full width and depth a run
holds about 20 GB of host memory (mamba2-2.7b: 11 GB of f32 weights).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.testing.generate import (  # noqa: E402
    bf16_ulp, dense_cache_from_prefill)


def _cast(node, dtype):
    if isinstance(node, dict):
        return {k: _cast(v, dtype) for k, v in node.items()}
    return node.to(dtype) if node.is_floating_point() else node


class _CastCache:
    """The model, its dense cache made in ``dtype`` (the conv tail too)."""

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype

    def init_cache(self, *args, **kw):
        return _cast(self.model.init_cache(*args, **kw), self.dtype)


def drift(cfg, dtype, prompt: int, steps: int) -> dict:
    """One greedy run of ``steps`` decode steps against the teacher-forced
    forward, weights and dense cache in ``dtype``."""
    model = build_model(cfg)
    params = _cast(model.init(torch.Generator().manual_seed(0)), dtype)
    tokens = torch.randint(3, cfg.vocab_size, (1, prompt),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        last, pre = model.prefill(params, {"tokens": tokens})
        cache = dense_cache_from_prefill(_CastCache(model, dtype), pre, 1,
                                         prompt + steps + 1)
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        toks, logits = [tok], [last.float()]
        for i in range(steps):
            cl = torch.full((1,), prompt + i, dtype=torch.int32)
            out, cache = model.decode_step(params, tok, cache, cl)
            tok = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            logits.append(out.float())
        gen = torch.cat(toks, dim=1).long()
        full = torch.cat([tokens, gen[:, :-1]], dim=1)
        forced = model.forward(params, {"tokens": full})[0][:, prompt - 1:] \
            .float()
        rel = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7
        sign = torch.randint(0, 2, params["embed"].shape,
                             generator=torch.Generator().manual_seed(2)) * 2 - 1
        nudged = dict(params, embed=(params["embed"].float()
                                     * (1 + rel * sign)).to(dtype))
        moved = model.forward(nudged, {"tokens": full})[0][:, prompt - 1:] \
            .float()
    step = float(bf16_ulp(forced.abs().max()))
    diff = float((torch.stack(logits, dim=1) - forced).abs().max())
    return {"drift_steps": diff / step, "max_abs": diff,
            "nudge_steps": float((moved - forced).abs().max()) / step,
            "argmax_equal": int((forced.argmax(-1) == gen).sum()),
            "positions": gen.numel()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 16, 64])
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    for depth in args.depths:
        cfg = get_config(args.arch).with_overrides(n_layers=depth)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            t0 = time.perf_counter()
            r = drift(cfg, dtype, args.prompt, args.steps)
            print(f"{args.arch} {depth} layers (d {cfg.d_model}) {name} on "
                  f"the CPU: decode vs teacher-forced forward max logit diff "
                  f"{r['max_abs']:.4e} = {r['drift_steps']:.2f} bf16 steps; "
                  f"argmax equal at {r['argmax_equal']}/{r['positions']}; "
                  f"forward with the embeddings moved an ulp: "
                  f"{r['nudge_steps']:.2f} bf16 steps "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
