"""The port's dense-cache generate drive (``repro_torch.testing.generate``)
on the CPU: the dense cache built from a prefill, greedy generation
through ``Model.prefill`` -> ``Model.decode_step`` held to a
teacher-forced ``Model.forward`` at the bars the card's drives use, and
the check failing where the logits or the stream are wrong.

Reduced configs of every family the dense-cache path serves, on the
port's own bf16 weights from a seeded generator (the compute dtype of the
card's drives).  The port alone: the reference parity of these paths is
in tests/test_torch_model.py and tests/test_torch_encdec.py.
"""

import pytest
import torch

import repro_torch.testing.generate as gen_mod
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.testing import TokenMismatch
from repro_torch.testing.generate import (bf16_ulp, dense_cache_from_prefill,
                                          greedy_generate,
                                          teacher_forced_check)

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ARCHS = ("llama3.2-1b", "mamba2-2.7b", "zamba2-1.2b", "seamless-m4t-medium")
B, PROMPT, MAX_LEN, STEPS = 2, 12, 24, 8


def _setup(arch, cut=None):
    cfg = get_config(arch, reduced=cut is None).with_overrides(**(cut or {}))
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (B, PROMPT),
                                     generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = (torch.randn(B, 10, cfg.d_model, generator=g)
                           * 0.02).bfloat16()
    return cfg, model, params, batch


@pytest.fixture(scope="module", params=ARCHS)
def drive(request):
    cfg, model, params, batch = _setup(request.param)
    run = greedy_generate(model, params, batch, MAX_LEN, STEPS)
    return cfg, model, params, batch, run


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, 3.0, -0.53, 0.0])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -8,
                         2.0 ** -133])
    assert torch.equal(bf16_ulp(x), want)
    # the spacing: y + ulp is a bf16 number, y + ulp / 2 rounds back to y
    y = torch.tensor([1.0, 3.0, 0.53]).bfloat16().float()
    up = y + bf16_ulp(y)
    assert torch.equal(up.bfloat16().float(), up)
    assert torch.equal((y + bf16_ulp(y) / 2).bfloat16().float(), y)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_cache_from_prefill(arch):
    """The prefill's self K/V in the first slots and zeros after, the
    recurrent state copied into the cache's own tensors, the cross K/V
    the prefill's own tensors."""
    cfg, model, params, batch = _setup(arch)
    _, pre = model.prefill(params, batch)
    cache = dense_cache_from_prefill(model, pre, B, MAX_LEN)
    shapes = model.cache_shapes(B, MAX_LEN)
    assert set(cache) == set(pre)
    for name in ("k", "v"):
        if name in pre:
            assert cache[name].shape == shapes[name][0]
            assert torch.equal(cache[name][:, :, :PROMPT], pre[name])
            assert not cache[name][:, :, PROMPT:].any()
    for name in ("cross_k", "cross_v"):
        if name in pre:
            assert cache[name] is pre[name]
    if "ssm" in pre:
        for name, t in pre["ssm"].items():
            got = cache["ssm"][name]
            assert got.dtype == shapes["ssm"][name][1]
            assert got.data_ptr() != t.data_ptr()
            assert torch.equal(got, t.to(got.dtype))
    if "k" in pre:
        with pytest.raises(ValueError, match="exceeds max_len"):
            dense_cache_from_prefill(model, pre, B, PROMPT - 1)


def test_greedy_generate_matches_teacher_forced_forward(drive):
    cfg, model, params, batch, run = drive
    assert run["finite"]
    assert run["tokens"].shape == (B, STEPS + 1)
    assert run["logits"].shape == (B, STEPS + 1, cfg.vocab_size)
    stats = teacher_forced_check(model, params, batch, run, cfg.name)
    assert stats["positions"] == B * (STEPS + 1)
    assert stats["max_logit_diff"] <= stats["logit_bar"]
    assert stats["rate"] >= 0.999


def test_teacher_forced_check_catches_drifted_logits(drive):
    """Logits moved by 8 bf16 steps at the forward's scale fail the logit
    bar (3 steps), with the stream unchanged."""
    cfg, model, params, batch, run = drive
    step = bf16_ulp(run["logits"].float().abs().max())
    bad = dict(run, logits=run["logits"].float() + 8 * step)
    with pytest.raises(TokenMismatch, match="logit"):
        teacher_forced_check(model, params, batch, bad, cfg.name)


def test_teacher_forced_check_catches_a_wrong_token(drive):
    """A generated token that is not a near-tie of the forward's maximum
    (here its least likely token) is a divergence, not an excused flip."""
    cfg, model, params, batch, run = drive
    full = dict(batch, tokens=torch.cat(
        [batch["tokens"], run["tokens"][:, :-1].to(batch["tokens"].dtype)],
        1))
    forced, _, _ = model.forward(params, full)
    toks = run["tokens"].clone()
    toks[0, STEPS // 2] = int(torch.argmin(forced[0, PROMPT - 1
                                                  + STEPS // 2]))
    with pytest.raises(TokenMismatch, match="match rate"):
        teacher_forced_check(model, params, batch, dict(run, tokens=toks),
                             cfg.name)


# the recurrent drives the card holds to the check: full width, 2 layers
# (the vocabulary cut here only to keep the CPU test short)
CUTS = {"mamba2-2.7b": dict(n_layers=2, vocab_size=4096),
        "zamba2-1.2b": dict(n_layers=2, hybrid_attn_every=1,
                            vocab_size=4096)}


@pytest.mark.parametrize("arch,leaf", [("mamba2-2.7b", "ssd"),
                                       ("mamba2-2.7b", "conv"),
                                       ("zamba2-1.2b", "ssd"),
                                       ("zamba2-1.2b", "kv")])
def test_teacher_forced_check_catches_a_lost_cache(arch, leaf,
                                                   monkeypatch):
    """At the card's cut of the recurrent drives (full width, 2 layers),
    the check passes, and a dense cache that loses what the prefill left
    in it (the SSD state, the conv tail, or the attention K/V of the last
    group layer) fails it: the bars see the state the decode carries."""
    cfg, model, params, batch = _setup(arch, CUTS[arch])
    run = greedy_generate(model, params, batch, MAX_LEN, STEPS)
    teacher_forced_check(model, params, batch, run, cfg.name)
    build = gen_mod.dense_cache_from_prefill

    def lossy(*args):
        cache = build(*args)
        for t in ((cache["k"][-1], cache["v"][-1]) if leaf == "kv"
                  else (cache["ssm"][leaf],)):
            t.zero_()
        return cache

    monkeypatch.setattr(gen_mod, "dense_cache_from_prefill", lossy)
    run = greedy_generate(model, params, batch, MAX_LEN, STEPS)
    with pytest.raises(TokenMismatch):
        teacher_forced_check(model, params, batch, run, cfg.name)
