"""Greedy generation through the Model facade's dense-cache path
(``Model.prefill`` -> ``Model.decode_step``), and its check against a
teacher-forced ``Model.forward`` under the tolerance contract.

    run = greedy_generate(model, params, batch, max_len, steps)
    stats = teacher_forced_check(model, params, batch, run, "label")

The paged engine and ``launch.serve`` refuse the encoder-decoder, as the
reference's do, so this is how it is driven.
"""

from __future__ import annotations

import time

import torch

from .tolerance import assert_tokens_close

__all__ = ["LOGIT_ULPS", "FLIP_ULPS", "bf16_ulp", "dense_cache_from_prefill",
           "greedy_generate", "teacher_forced_check"]

# the teacher-forced check's bars, in bf16 steps (see teacher_forced_check)
LOGIT_ULPS = 3
FLIP_ULPS = 2


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def dense_cache_from_prefill(model, pre, batch: int, max_len: int):
    """A dense decode cache of ``max_len`` slots holding a prefill's cache:
    the self-attention K/V in the first slots, the recurrent state copied
    into the cache's own tensors (so the conv tail keeps the cache's
    dtype), and the encoder-decoder's cross K/V as the prefill's own
    tensors (no copy)."""
    device = next(_leaves(pre)).device
    cache = model.init_cache(batch, max_len, device=device)
    for name, t in pre.items():
        if name in ("k", "v"):
            s = t.shape[2]
            if s > max_len:
                raise ValueError(f"dense_cache_from_prefill: prefill of {s} "
                                 f"tokens exceeds max_len {max_len}")
            cache[name][:, :, :s] = t
        elif name == "ssm":
            for leaf, st in t.items():
                cache["ssm"][leaf].copy_(st)
        else:
            cache[name] = t
    return cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(model, params, batch, max_len: int, steps: int) -> dict:
    """Model.prefill, then ``steps`` greedy Model.decode_step calls over a
    dense cache of ``max_len`` slots.  Returns the generated tokens (B,
    steps + 1) (the first from the prefill's logits) with the logits that
    chose them (B, steps + 1, V), whether every logit was finite, and
    host-clock seconds of prefill and decode."""
    tokens = batch["tokens"]
    b, p = tokens.shape
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    last, pre = model.prefill(params, batch)
    cache = dense_cache_from_prefill(model, pre, b, max_len)
    del pre
    finite = torch.isfinite(last).all()
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    out, logits_out = [tok], [last]
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(steps):
        cl = torch.full((b,), p + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, tok, cache, cl)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok)
        logits_out.append(logits)
    _sync(dev)
    t2 = time.perf_counter()
    return {"tokens": torch.cat(out, dim=1),
            "logits": torch.stack(logits_out, dim=1), "finite": bool(finite),
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def teacher_forced_check(model, params, batch, run, label: str, *,
                         logit_ulps: float | None = None,
                         flip_ulps: float | None = None) -> dict:
    """Hold a greedy run to a teacher-forced Model.forward over prompt +
    generated tokens, under the tolerance contract
    (``assert_tokens_close``), with bars counted in bf16 steps:

    - the logits that chose each token lie within ``logit_ulps`` bf16
      steps, taken at the forward's largest |logit|, of the forward's
      logits at the same position;
    - the greedy stream matches the forward's picks at the contract's
      rate.  The forward's pick at a position is the greedy token where
      the greedy token's forward logit lies within ``flip_ulps`` bf16
      steps of the forward's maximum there (two paths that round
      differently may flip a near-tie: over a 256k vocabulary of random
      weights the top two are often equal), and the forward's argmax
      elsewhere.

    Returns the contract's stats plus the bar, the drift in bf16 steps,
    the counts of exact argmax agreement, exact top-1 ties and excused
    flips, and the largest flip's margin in bf16 steps.
    ``logit_ulps`` and ``flip_ulps`` default to LOGIT_ULPS and FLIP_ULPS."""
    logit_ulps = LOGIT_ULPS if logit_ulps is None else logit_ulps
    flip_ulps = FLIP_ULPS if flip_ulps is None else flip_ulps
    p = batch["tokens"].shape[1]
    gen_toks = run["tokens"].long()
    full = dict(batch, tokens=torch.cat(
        [batch["tokens"], gen_toks[:, :-1].to(batch["tokens"].dtype)], 1))
    logits, _, _ = model.forward(params, full)
    forced = logits[:, p - 1:].float()
    del logits
    step = float(bf16_ulp(forced.abs().max()))
    fmax = forced.max(dim=-1).values
    picked = forced.gather(-1, gen_toks[..., None])[..., 0]
    argmax = torch.argmax(forced, dim=-1)
    margin = (fmax - picked) / bf16_ulp(fmax)
    flip = argmax != gen_toks
    coin = flip & (margin <= flip_ulps)
    want = torch.where(coin, gen_toks, argmax)
    stats = assert_tokens_close(
        gen_toks.tolist(), want.tolist(),
        logits=run["logits"].float().cpu().numpy(),
        ref_logits=forced.cpu().numpy(),
        max_logit_diff=logit_ulps * step, label=label)
    stats["logit_bar"] = logit_ulps * step
    stats["drift_ulps"] = stats["max_logit_diff"] / step
    stats["exact"] = int((~flip).sum())
    stats["ties"] = int(((forced == fmax[..., None]).sum(dim=-1) > 1).sum())
    stats["coin_tosses"] = int(coin.sum())
    stats["flip_ulps_max"] = float(margin[flip].max()) if bool(flip.any()) \
        else 0.0
    stats["positions"] = gen_toks.numel()
    return stats
