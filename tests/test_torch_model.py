"""Attention decoders of the port (repro_torch.models) against the
reference (repro.models) on reduced llama3.2-1b, qwen2-1.5b (qkv bias),
olmoe-1b-7b (MoE), deepseek-moe-16b (MoE with shared experts and a
leading dense layer) and internvl2-76b (VLM, served on text alone), and
the dense-cache ``Model.decode_step`` of the same three and of reduced
llama3.2-1b (also with an 8-slot sliding-window ring), mamba2-2.7b and
zamba2-1.2b.  The MoE prefill and chunk paths route with the configs'
own capacity factor, so tokens drop there as in the reference.

Both sides run the reference's own weights, upcast to f32 (jax 0.9 on
the CPU cannot run a bf16 x bf16 -> f32 dot), carried into the port by
``params_from_numpy``.  KV pools stay bf16 on both sides; the dense
caches are f32 on both.  Checked: prefill logits, prefill-chunk KV and
paged-decode logits within atol 1e-4, and 16 greedy tokens identical;
dense-cache decode logits within the same atol and 16 greedy tokens
identical, and in the port dense-cache decode equal to paged decode from
the same prefill.  The port's decode step writes its caches in place, so
no test reuses a cache after a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.layers import init_from_template

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ARCHS = ["llama3.2-1b", "qwen2-1.5b", "olmoe-1b-7b", "deepseek-moe-16b",
         "internvl2-76b"]
ATOL = 1e-4


def _pair(arch):
    cfg = ref_get_config(arch, reduced=True)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref.init(jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        # zero-initialised biases would hide a wiring fault: make them real
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            b = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = rng.normal(
                0, 0.02, b.shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, tree)
    port = build_model(get_config(arch, reduced=True))
    return cfg, ref, ref_params, port, params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def test_config_and_template_match(pair):
    cfg, ref, ref_params, port, params = pair
    assert port.cfg == get_config(cfg.name.removesuffix("-smoke"),
                                  reduced=True)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    assert got == shapes


def test_init_from_template_dtypes_and_scale():
    cfg = get_config("qwen2-1.5b", reduced=True)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    assert p["embed"].dtype == torch.bfloat16
    assert p["layers"]["ln1"]["scale"].dtype == torch.float32
    assert p["layers"]["attn"]["bq"].dtype == torch.float32
    assert torch.all(p["layers"]["attn"]["bq"] == 0)
    assert torch.all(p["final_norm"]["scale"] == 1)
    std = float(p["layers"]["mlp"]["w_in"].float().std())
    assert 0.015 < std < 0.025          # min(0.02, fan_in ** -0.5)
    again = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], p["embed"])
    assert init_from_template({"x": m.template()["embed"]},
                              torch.Generator().manual_seed(1))["x"].shape \
        == p["embed"].shape


def test_bridge_keeps_bf16_leaves():
    cfg = ref_get_config("llama3.2-1b", reduced=True)
    tree = jax.tree.map(np.asarray, ref_build_model(cfg).init(
        jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(tree["embed"], np.float32))


def test_prefill_logits(pair):
    cfg, ref, ref_params, port, params = pair
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, (2, 24))
    want, _, _ = ref.forward(ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache, _ = port.forward(params, {"tokens": torch.from_numpy(tokens)},
                                 collect_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    last, _ = port.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(last, got[:, -1])
    assert cache["k"].shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads,
                                cfg.head_dim)


@pytest.mark.parametrize("s0,take", [(0, 20), (32, 24), (40, 17)])
def test_prefill_chunk_kv(pair, s0, take):
    """One chunk over a gathered prefix padded past ``start`` (rows >= s0
    masked), as the engine calls it; the chunk itself padded to 64."""
    cfg, ref, ref_params, port, params = pair
    rng = np.random.default_rng(s0 + take)
    cpad, past_pad = 64, (64 if s0 else 0)
    toks = np.zeros((1, cpad), np.int32)
    toks[0, :take] = rng.integers(3, cfg.vocab_size, take)
    shape = (cfg.n_layers, 1, past_pad, cfg.n_kv_heads, cfg.head_dim)
    pk = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                          ).bfloat16()
    pv = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                          ).bfloat16()
    ref_k, ref_v = ref.prefill_chunk(
        ref_params, jnp.asarray(toks), jnp.asarray(pk.float().numpy(),
                                                   jnp.bfloat16),
        jnp.asarray(pv.float().numpy(), jnp.bfloat16), jnp.int32(s0))
    k, v = port.prefill_chunk(params, torch.from_numpy(toks), pk, pv, s0)
    for got, want in ((k, ref_k), (v, ref_v)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :, :take].numpy(),
                                   np.asarray(want)[:, :, :take], atol=ATOL,
                                   rtol=0)


def _paged_setup(cfg, seed, b=3, page=8, n_pages=40, p_max=8):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    pools = [np.asarray(torch.from_numpy(rng.normal(0, 1, shape).astype(
        np.float32)).bfloat16().float()) for _ in range(2)]
    tables = np.stack([rng.permutation(np.arange(1, n_pages))[:p_max]
                       for _ in range(b)]).astype(np.int32)
    cache_len = np.array([5, 17, 30][:b], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, (b, 1)).astype(np.int32)
    return pools, tables, cache_len, tokens


def test_paged_decode_logits_and_pool_writes(pair):
    cfg, ref, ref_params, port, params = pair
    pools, tables, cl, tok = _paged_setup(cfg, 3)
    ref_cache = {"k": jnp.asarray(pools[0], jnp.bfloat16),
                 "v": jnp.asarray(pools[1], jnp.bfloat16)}
    cache = {"k": torch.from_numpy(pools[0]).bfloat16(),
             "v": torch.from_numpy(pools[1]).bfloat16()}
    want, ref_cache = ref.decode_step_paged(
        ref_params, jnp.asarray(tok), ref_cache, jnp.asarray(cl),
        jnp.asarray(tables), page_size=8)
    got, cache = port.decode_step_paged(
        params, torch.from_numpy(tok), cache, torch.from_numpy(cl),
        torch.from_numpy(tables), page_size=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache[name].float().numpy(),
            np.asarray(ref_cache[name], np.float32), atol=2e-2, rtol=0)


def test_greedy_tokens_identical_16_steps(pair):
    cfg, ref, ref_params, port, params = pair
    pools, tables, cl, tok = _paged_setup(cfg, 4)
    ref_cache = {"k": jnp.asarray(pools[0], jnp.bfloat16),
                 "v": jnp.asarray(pools[1], jnp.bfloat16)}
    cache = {"k": torch.from_numpy(pools[0]).bfloat16(),
             "v": torch.from_numpy(pools[1]).bfloat16()}
    ref_tok, port_tok = jnp.asarray(tok), torch.from_numpy(tok)
    ref_cl, port_cl = jnp.asarray(cl), torch.from_numpy(cl)
    jt, pt = jnp.asarray(tables), torch.from_numpy(tables)
    want, got = [], []
    for _ in range(16):
        lw, ref_cache = ref.decode_step_paged(ref_params, ref_tok, ref_cache,
                                              ref_cl, jt, page_size=8)
        lg, cache = port.decode_step_paged(params, port_tok, cache, port_cl,
                                           pt, page_size=8)
        ref_tok = jnp.argmax(lw, axis=-1).astype(jnp.int32)[:, None]
        port_tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        want.append(np.asarray(ref_tok)[:, 0].tolist())
        got.append(port_tok[:, 0].tolist())
        ref_cl, port_cl = ref_cl + 1, port_cl + 1
    assert got == want


# -------------------------------------------------- dense-cache decode step

# (arch, sliding-window ring of this many slots or 0, dense cache slots)
DENSE_CASES = {"llama3.2-1b": ("llama3.2-1b", 0, 32),
               "llama3.2-1b-ring8": ("llama3.2-1b", 8, 8),
               "olmoe-1b-7b": ("olmoe-1b-7b", 0, 32),
               "deepseek-moe-16b": ("deepseek-moe-16b", 0, 32),
               "internvl2-76b": ("internvl2-76b", 0, 32),
               "mamba2-2.7b": ("mamba2-2.7b", 0, 32),
               "zamba2-1.2b": ("zamba2-1.2b", 0, 32)}


def _dense_pair(case):
    arch, window, max_len = DENSE_CASES[case]
    cfg = ref_get_config(arch, reduced=True)
    pcfg = get_config(arch, reduced=True)
    if window:
        cfg = cfg.with_overrides(attention_kind="sliding_window",
                                 window=window)
        pcfg = pcfg.with_overrides(attention_kind="sliding_window",
                                   window=window)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref.init(jax.random.PRNGKey(0)))
    return (cfg, ref, jax.tree.map(jnp.asarray, tree), build_model(pcfg),
            params_from_numpy(tree, "cpu"), max_len)


@pytest.fixture(scope="module", params=sorted(DENSE_CASES))
def dense_pair(request):
    return _dense_pair(request.param)


def _f32_caches(ref, port, b, max_len):
    """Zero dense caches of every leaf in f32, for both packages."""
    ref_cache = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                             ref.cache_shapes(b, max_len))
    cache = jax.tree.map(lambda t: t.float(),
                         port.init_cache(b, max_len, device="cpu"))
    return ref_cache, cache


def test_dense_cache_layout(dense_pair):
    cfg, ref, _, port, _, max_len = dense_pair
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        ref.cache_shapes(3, max_len))
    got = jax.tree.map(lambda leaf: (tuple(leaf[0]),
                                     str(leaf[1]).removeprefix("torch.")),
                       port.cache_shapes(3, max_len),
                       is_leaf=lambda x: isinstance(x, tuple))
    assert got == want
    cache = port.init_cache(3, max_len, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix("torch.")),
                        cache) == want
    assert all(float(t.abs().sum()) == 0
               for t in jax.tree_util.tree_leaves(cache))


def test_dense_decode_logits_match_reference(dense_pair):
    """12 teacher-forced steps from an empty cache (the ring wraps after
    8): logits at every step and the final caches against the
    reference's."""
    cfg, ref, ref_params, port, params, max_len = dense_pair
    b, n = 2, 12
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (b, n))
    ref_cache, cache = _f32_caches(ref, port, b, max_len)
    for t in range(n):
        tok = toks[:, t:t + 1].astype(np.int32)
        cl = np.full((b,), t, np.int32)
        want, ref_cache = ref.decode_step(ref_params, jnp.asarray(tok),
                                          ref_cache, jnp.asarray(cl))
        got, cache = port.decode_step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(cl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_cache)
    flat = dict(jax.tree_util.tree_leaves_with_path(cache))
    for path, leaf in flat_ref:
        np.testing.assert_allclose(flat[path].numpy(), np.asarray(leaf),
                                   atol=ATOL, rtol=0, err_msg=str(path))


def test_dense_decode_deep_recurrent_matches_reference_and_forward():
    """Depth does not part the port from the reference: mamba2-2.7b cut to
    reduced width but 16 layers, f32 weights and caches, 12 decode steps
    from an empty cache held to the reference's logits and to the port's
    own teacher-forced forward at 1e-4 (at full width the bf16 drift
    between decode and forward grows with depth by rounding alone,
    ``tools/recurrent_depth_drift.py``)."""
    cfg = ref_get_config("mamba2-2.7b", reduced=True).with_overrides(
        n_layers=16)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref.init(jax.random.PRNGKey(0)))
    ref_params = jax.tree.map(jnp.asarray, tree)
    port = build_model(get_config("mamba2-2.7b", reduced=True)
                       .with_overrides(n_layers=16))
    params = params_from_numpy(tree, "cpu")
    b, n = 2, 12
    toks = np.random.default_rng(8).integers(3, cfg.vocab_size, (b, n))
    ref_cache, cache = _f32_caches(ref, port, b, n + 1)
    steps = []
    for t in range(n):
        tok = toks[:, t:t + 1].astype(np.int32)
        cl = np.full((b,), t, np.int32)
        want, ref_cache = ref.decode_step(ref_params, jnp.asarray(tok),
                                          ref_cache, jnp.asarray(cl))
        got, cache = port.decode_step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(cl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
        steps.append(got)
    forced = port.forward(params, {"tokens": torch.from_numpy(toks)})[0]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               forced.float().numpy(), atol=ATOL, rtol=0)


def test_dense_decode_greedy_tokens_identical_16_steps(dense_pair):
    cfg, ref, ref_params, port, params, max_len = dense_pair
    b = 2
    tok = np.random.default_rng(6).integers(3, cfg.vocab_size,
                                            (b, 1)).astype(np.int32)
    ref_cache, cache = _f32_caches(ref, port, b, max_len)
    ref_tok, port_tok = jnp.asarray(tok), torch.from_numpy(tok)
    want, got = [], []
    for t in range(16):
        cl = np.full((b,), t, np.int32)
        lw, ref_cache = ref.decode_step(ref_params, ref_tok, ref_cache,
                                        jnp.asarray(cl))
        lg, cache = port.decode_step(params, port_tok, cache,
                                     torch.from_numpy(cl))
        ref_tok = jnp.argmax(lw, axis=-1).astype(jnp.int32)[:, None]
        port_tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        want.append(np.asarray(ref_tok)[:, 0].tolist())
        got.append(port_tok[:, 0].tolist())
    assert got == want


def test_dense_decode_equals_paged_decode(dense_pair):
    """In the port alone: from one prefill of 12 tokens, 8 greedy steps
    over the dense cache (a ring holds the last 8 positions at slot
    pos % 8) and over a paged pool (pages in shuffled order, a logical
    window of the same size) give the same logits and tokens."""
    cfg, _, _, port, params, max_len = dense_pair
    b, s, page, n_pages = 2, 12, 4, 24
    window = cfg.window if cfg.attention_kind == "sliding_window" else 0
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s)))
    _, pre = port.prefill(params, {"tokens": toks[:, :-1]})
    dense = jax.tree.map(lambda t: t.float(),
                         port.init_cache(b, max_len, device="cpu"))
    paged = {}
    if "k" in pre:
        pos = torch.arange(s - 1)
        keep = pos[pos >= s - 1 - max_len] if window else pos
        p_max = (s + 8 + page - 1) // page
        tables = torch.from_numpy(rng.permutation(np.arange(1, n_pages))[
            :b * p_max].reshape(b, p_max).astype(np.int32))
        for name in ("k", "v"):
            dense[name][:, :, keep % max_len] = pre[name][:, :, keep]
            pool = torch.zeros((pre[name].shape[0], n_pages, page)
                               + pre[name].shape[3:])
            flat = pool.view(pool.shape[0], n_pages * page,
                             *pool.shape[3:])
            for r in range(b):
                slot = tables[r, pos // page].long() * page + pos % page
                flat[:, slot] = pre[name][:, r]
            paged[name] = pool
    else:
        tables = torch.ones((b, 1), dtype=torch.int32)
    if "ssm" in pre:
        for name in ("ssd", "conv"):
            dense["ssm"][name].copy_(pre["ssm"][name])
        paged["ssm"] = {k: v.clone() for k, v in dense["ssm"].items()}
    tok_d = tok_p = toks[:, -1:].to(torch.int32)
    for t in range(8):
        cl = torch.full((b,), s - 1 + t, dtype=torch.int32)
        ld, dense = port.decode_step(params, tok_d, dense, cl)
        lp, paged = port.decode_step_paged(params, tok_p, paged, cl, tables,
                                           page_size=page)
        np.testing.assert_allclose(ld.numpy(), lp.numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
        tok_d = torch.argmax(ld, dim=-1).to(torch.int32)[:, None]
        tok_p = torch.argmax(lp, dim=-1).to(torch.int32)[:, None]
        assert torch.equal(tok_d, tok_p)
