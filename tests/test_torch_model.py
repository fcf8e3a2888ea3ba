"""Dense decoder of the port (repro_torch.models) against the reference
(repro.models) on reduced llama3.2-1b and qwen2-1.5b (qkv bias).

Both sides run the reference's own weights, upcast to f32 (jax 0.9 on
the CPU cannot run a bf16 x bf16 -> f32 dot), carried into the port by
``params_from_numpy``.  KV pools stay bf16 on both sides.  Checked:
prefill logits, prefill-chunk KV and paged-decode logits within atol
1e-4, and 16 greedy tokens identical.
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

ARCHS = ["llama3.2-1b", "qwen2-1.5b"]
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


def test_other_families_not_ported():
    for arch, item in (("olmoe-1b-7b", "Queue A 6"),
                       ("internvl2-76b", "Queue A 6"),
                       ("seamless-m4t-medium", "Queue A 12")):
        with pytest.raises(NotImplementedError, match=item):
            build_model(get_config(arch, reduced=True))
