"""The plain reference the served outputs are judged against.

Plain PyTorch and NumPy.  It imports nothing of the program and takes
nothing the program made: the weights are the benchmark's own (made from
the seed), handed here in this module's layout, and the program's outputs
(served tokens, prefill chunk boundaries, priorities) are read only to be
judged.

* ``Decoder``: the served decoder (dense GQA with optional QKV bias, or
  top-K MoE with capacity-limited dispatch) over one request's prompt and
  served tokens, in float32 with TF32 off, or, as the control, with every
  GEMM's weights and inputs rounded to fp8 e4m3 (per output channel and
  per token scales).  The architecture is the program's as its
  configuration file states it (RMSNorm, rotate-half RoPE, SwiGLU, the
  vocabulary padded to a multiple of 256 and tied or untied head; MoE gates
  renormalised over the top K, a prefill chunk's experts holding
  ``int(N K capacity_factor / E)`` rows, N the chunk padded to a power of
  two from 64, a decode token dropping nothing).
* The sampling draw: JAX's threefry2x32 ``PRNGKey`` / ``fold_in`` and
  Gumbel noise (mode "low"), frozen here.  A sampled token wins
  ``logit / T + gumbel(fold_in(fold_in(PRNGKey(seed), crc32(id)), j))``.
* The Gittins index of a discrete cost distribution after attained cost
  (paper Sec. 3.3), frozen here in float64; ``gittins_bf16`` is its
  control.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Decoder", "request_keys", "gumbel_noise", "gittins_index",
           "gittins_bf16", "attained_cost", "rid_seed"]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
_FP8_MAX = 448.0


# ------------------------------------------------------------ sampling draw

def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def _threefry(k0, k1, x0, x1):
    """threefry2x32, 20 rounds, on int64 tensors of uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def rid_seed(request_id: str) -> int:
    return zlib.crc32(request_id.encode())


def request_keys(engine_seed: int, request_id: str, positions,
                 device) -> torch.Tensor:
    """(n, 2) keys fold_in(fold_in(PRNGKey(engine_seed), crc32(id)), j)
    for the output positions j."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    k0, k1 = z, z + (int(engine_seed) & MASK32)
    k0, k1 = _threefry(k0, k1, z, z + rid_seed(request_id))
    pos = torch.as_tensor(positions, dtype=torch.int64,
                          device=device) & MASK32
    a, b = _threefry(k0.expand_as(pos), k1.expand_as(pos),
                     torch.zeros_like(pos), pos)
    return torch.stack([a, b], dim=-1)


def gumbel_noise(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Gumbel noise of columns 0 .. n-1 under each key (rows, 2): (rows,
    n) float64, from the f32 uniform JAX draws."""
    col = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b0, b1 = _threefry(keys[:, :1], keys[:, 1:], torch.zeros_like(col), col)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u + _TINY, min=_TINY).double()
    return -torch.log(-torch.log(u))


# ----------------------------------------------------------------- Gittins

def attained_cost(input_len, generated):
    """The resource-bound cost C = O^2 / 2 + I O of ``generated`` outputs."""
    i = np.asarray(input_len, np.float64)
    g = np.asarray(generated, np.float64)
    return g * g / 2.0 + i * g


def gittins_index(support, probs, attained) -> np.ndarray:
    """G = min_j E[min(X, c_j)] / P(X <= c_j) of the remaining cost X
    (the distribution conditioned on X > attained and re-origined); a row
    whose every support point is spent takes its largest point (at least
    1).  float64."""
    sup = np.asarray(support, np.float64)
    p0 = np.asarray(probs, np.float64)
    valid = p0 > 0.0
    att = np.maximum(np.asarray(attained, np.float64), 0.0)
    cond = att > 0.0
    alive = valid & (~cond[:, None] | (sup > att[:, None]))
    p = np.where(alive, p0, 0.0)
    total = p.sum(axis=1)
    exhausted = cond & (total <= 0.0)
    p = np.where(cond[:, None], p / np.where(total > 0, total, 1.0)[:, None],
                 p)
    c = np.where(alive, sup - np.where(cond, att, 0.0)[:, None], 0.0)
    mass = np.cumsum(p, axis=1)
    num = np.cumsum(c * p, axis=1) + c * (1.0 - mass)
    ratio = np.where(alive, num / np.where(alive, mass, 1.0), np.inf)
    out = ratio.min(axis=1)
    tail = np.maximum(np.max(np.where(valid, sup, -np.inf), axis=1), 1.0)
    return np.where(exhausted, tail, out)


def gittins_bf16(support, probs, attained) -> np.ndarray:
    """The control: the same index with every operand and partial sum
    rounded to bfloat16."""
    bf = torch.bfloat16
    sup = torch.as_tensor(np.asarray(support, np.float64)).to(bf)
    p0 = torch.as_tensor(np.asarray(probs, np.float64)).to(bf)
    att = torch.as_tensor(np.maximum(np.asarray(attained, np.float64), 0.0)
                          ).to(bf)
    valid = p0 > 0
    cond = att > 0
    alive = valid & (~cond[:, None] | (sup > att[:, None]))
    p = torch.where(alive, p0, torch.zeros_like(p0))
    total = p.sum(dim=1)
    p = torch.where(cond[:, None], p / torch.where(
        total > 0, total, torch.ones_like(total))[:, None], p)
    c = torch.where(alive, sup - torch.where(cond, att, torch.zeros_like(
        att))[:, None], torch.zeros_like(sup))
    mass = torch.cumsum(p, dim=1)
    num = torch.cumsum(c * p, dim=1) + c * (1 - mass)
    ratio = torch.where(alive, num / torch.where(alive, mass,
                                                 torch.ones_like(mass)),
                        torch.full_like(num, float("inf")))
    out = ratio.min(dim=1).values.double().numpy()
    exhausted = (cond & (total <= 0)).numpy()
    tail = np.maximum(np.max(np.where(np.asarray(probs) > 0,
                                      np.asarray(support, np.float64),
                                      -np.inf), axis=1), 1.0)
    return np.where(exhausted, tail, out)


# ----------------------------------------------------------------- decoder

def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Decoder:
    """The served decoder over one sequence at a time, layer by layer.

    ``arch``: a configuration file's ``arch`` object.  ``weights``: {
    "embed" (V, D), "final_norm" (D,), "lm_head" (D, V) or None when tied,
    "layers": [per layer {"ln1", "ln2", "wq", "wk", "wv", "wo", optional
    "bq", "bk", "bv", and "w_gate", "w_in", "w_out" (dense: (D, F), (D, F),
    (F, D); MoE: (E, D, F), (E, D, F), (E, F, D)) with "router" (D, E)}]}
    with x @ w products, in any dtype; each layer is taken up to float32
    when it runs.  ``precision``: "f32" or "fp8" (the control)."""

    def __init__(self, arch: dict, weights: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"bad precision {precision!r}")
        # float32 products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.arch = arch
        self.w = weights
        self.precision = precision

    def _mm(self, x, w):
        """x (..., K) @ w (K, N) in the run's precision."""
        w = w.float()
        if self.precision == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def _bmm(self, x, w):
        w = w.float()
        if self.precision == "fp8":
            return torch.bmm(_fp8(x, -1), _fp8(w, 1))
        return torch.bmm(x, w)

    def _norm(self, x, scale):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.arch["norm_eps"]) * scale.float()

    def _rope(self, x, pos):
        dh = x.shape[-1]
        freqs = 1.0 / (self.arch["rope_theta"] ** (torch.arange(
            0, dh, 2, dtype=torch.float32, device=x.device) / dh))
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v, block: int = 512):
        """Causal GQA over one sequence: q (S, H, dh), k, v (S, KV, dh)."""
        s, h, dh = q.shape
        kv = k.shape[1]
        r = h // kv
        out = torch.empty_like(q)
        kk = k.permute(1, 0, 2)                                 # (KV, S, dh)
        vv = v.permute(1, 0, 2)
        for a in range(0, s, block):
            b = min(s, a + block)
            qb = q[a:b].reshape(b - a, kv, r, dh).permute(1, 2, 0, 3)
            sc = torch.einsum("grqd,gkd->grqk", qb, kk[:, :b]) / math.sqrt(dh)
            qpos = torch.arange(a, b, device=q.device)[:, None]
            kpos = torch.arange(b, device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            o = torch.einsum("grqk,gkd->grqd", torch.softmax(sc, dim=-1),
                             vv[:, :b])
            out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, h, dh)
        return out

    def _dense_ffn(self, lw, x):
        g = self._mm(x, lw["w_gate"])
        u = self._mm(x, lw["w_in"])
        return self._mm(F.silu(g) * u, lw["w_out"])

    def _route(self, lw, x, segments):
        """Top-K assignments of every position kept under its segment's
        capacity: (token, expert, gate) rows of the kept ones."""
        E, K = self.arch["n_experts"], self.arch["experts_per_token"]
        logits = x @ lw["router"].float()
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_i = top_p[:, :K], top_i[:, :K]
        gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        keep = torch.ones_like(top_i, dtype=torch.bool)
        for a, b, cap in segments:
            if cap is None:
                continue
            e = top_i[a:b].reshape(-1)
            onehot = F.one_hot(e, E).to(torch.int64)
            rank = (torch.cumsum(onehot, 0) - onehot).gather(
                1, e[:, None])[:, 0]
            keep[a:b] = (rank < cap).view(b - a, K)
        tok = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(
            top_i)
        return tok[keep], top_i[keep], gates[keep]

    def _moe_ffn(self, lw, x, segments):
        tok, exp, gate = self._route(lw, x, segments)
        out = torch.zeros_like(x)
        order = torch.argsort(exp, stable=True)
        tok, exp, gate = tok[order], exp[order], gate[order]
        counts = torch.bincount(exp, minlength=self.arch["n_experts"]).tolist()
        start = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            t = tok[start:start + n]
            xe = x[t][None]
            g = self._bmm(xe, lw["w_gate"][e:e + 1])
            u = self._bmm(xe, lw["w_in"][e:e + 1])
            y = self._bmm(F.silu(g) * u, lw["w_out"][e:e + 1])[0]
            out.index_add_(0, t, y * gate[start:start + n, None])
            start += n
        return out

    def capacity(self, padded: int) -> int:
        nk = padded * self.arch["experts_per_token"]
        return min(nk, max(1, int(nk * self.arch["capacity_factor"]
                                  / self.arch["n_experts"])))

    @torch.no_grad()
    def logits(self, tokens, chunks, first_logit: int) -> torch.Tensor:
        """float32 logits (over the padded vocabulary) at positions
        ``first_logit`` .. S - 1 of ``tokens`` (S,), the prompt followed by
        the served tokens.  ``chunks``: the prefill chunks that computed
        positions 0 .. first_logit - 1, as (start, end, padded length); a
        position from ``first_logit`` on was computed by a decode step."""
        a = self.arch
        dev = self.w["embed"].device
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
        s = tokens.shape[0]
        pos = torch.arange(s, device=dev)
        segments = []
        if a.get("n_experts", 0):
            for c0, c1, padded in chunks:
                hi = min(c1, first_logit)
                if hi > c0:
                    segments.append((c0, hi, self.capacity(padded)))
            segments.append((first_logit, s, None))
        h = self.w["embed"][tokens].float()
        H, KV, dh = a["n_heads"], a["n_kv_heads"], a["head_dim"]
        for lw in self.w["layers"]:
            x = self._norm(h, lw["ln1"])
            q = self._mm(x, lw["wq"])
            k = self._mm(x, lw["wk"])
            v = self._mm(x, lw["wv"])
            if "bq" in lw:
                q = q + lw["bq"].float()
                k = k + lw["bk"].float()
                v = v + lw["bv"].float()
            q = self._rope(q.view(s, H, dh), pos)
            k = self._rope(k.view(s, KV, dh), pos)
            o = self._attention(q, k, v.view(s, KV, dh))
            h = h + self._mm(o.reshape(s, H * dh), lw["wo"])
            x = self._norm(h, lw["ln2"])
            if a.get("n_experts", 0):
                h = h + self._moe_ffn(lw, x, segments)
            else:
                h = h + self._dense_ffn(lw, x)
        x = self._norm(h[first_logit:], self.w["final_norm"])
        head = self.w["lm_head"] if self.w.get("lm_head") is not None \
            else self.w["embed"].T
        return self._mm(x, head)
