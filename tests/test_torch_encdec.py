"""Encoder-decoder of the port (repro_torch.models.encdec and the Model
facade's seamless-m4t-medium path) against the reference (repro.models)
on the reduced seamless-m4t-medium config.

Both sides run the reference's own bf16 weights, carried into the port by
``params_from_numpy`` with their bf16 leaves intact, on bf16 frames.  The
f32-upcast route of the other parity tests is closed here: the
reference's ``encode`` casts the frames to bf16, and an f32 weight then
changes its layer scan's carry dtype, which JAX refuses (ROADMAP Queue C
R5).  So both packages compute in bf16 and the bar is the reference's own
for this path, ``tests/test_models_consistency.py``: rtol 5e-2, atol
2e-2.  The port's decode step writes its cache in place, so no test
reuses a cache after a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch.configs import get_config
from repro_torch.core import Scheduler
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model
from repro_torch.models import encdec as port_encdec
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import ServingEngine
from repro_torch.testing.generate import dense_cache_from_prefill

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=5e-2, atol=2e-2)
B, S_ENC, S_DEC = 2, 12, 16


@pytest.fixture(scope="module")
def pair():
    cfg = ref_get_config(ARCH, reduced=True)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(ARCH, reduced=True))
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port, \
        params_from_numpy(tree, "cpu")


def _inputs(cfg, seed, s_dec=S_DEC + 1):
    """bf16 frames (N(0, 0.02), as the reference's tests draw them) and
    decoder tokens, the same values for both packages."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.normal(0, 0.02, (B, S_ENC, cfg.d_model))
                              .astype(np.float32)).bfloat16()
    tokens = rng.integers(3, cfg.vocab_size, (B, s_dec)).astype(np.int32)
    return frames, tokens


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL, **kw)


def test_template_and_bridge(pair):
    """The port's template has the reference's keys, shapes and dtypes,
    and the bridged params keep them (bf16 weights, f32 norm scales)."""
    cfg, ref, ref_params, port, params = pair

    def sig(tree):
        return jax.tree.map(
            lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")
                       if isinstance(x.dtype, torch.dtype)
                       else jnp.dtype(x.dtype).name),
            tree, is_leaf=lambda x: hasattr(x, "shape"))

    want = sig(ref.template())
    assert sig(port.template()) == want
    assert sig(params) == want
    assert params["dec_layers"]["cross"]["wq"].dtype == torch.bfloat16
    assert params["dec_layers"]["ln_cross"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["enc_layers"]["attn"]["wk"].float().numpy(),
        np.asarray(ref_params["enc_layers"]["attn"]["wk"], np.float32))
    assert sig(port.init(torch.Generator().manual_seed(0))) == want


def test_encode(pair):
    cfg, _, ref_params, _, params = pair
    frames, _ = _inputs(cfg, 1)
    want = ref_encdec.encode(ref_params, cfg, _jnp(frames), remat=False)
    got = port_encdec.encode(params, cfg, frames)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want)


def test_forward_logits(pair):
    cfg, ref, ref_params, port, params = pair
    frames, tokens = _inputs(cfg, 2)
    want, _, _ = ref.forward(ref_params, {"frames": _jnp(frames),
                                          "tokens": jnp.asarray(tokens)},
                             remat=False)
    got, _, aux = port.forward(params, {"frames": frames,
                                        "tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and float(aux) == 0.0
    _close(got, want)


def test_prefill_caches(pair):
    """Every cache tensor of Model.prefill: the decoder's self K/V and the
    cross K/V of every layer, and the last-position logits."""
    cfg, ref, ref_params, port, params = pair
    frames, tokens = _inputs(cfg, 3, S_DEC)
    want_last, want = ref.prefill(ref_params, {"frames": _jnp(frames),
                                               "tokens": jnp.asarray(tokens)})
    got_last, got = port.prefill(params, {"frames": frames,
                                          "tokens": torch.from_numpy(tokens)})
    assert set(got) == set(want) == {"k", "v", "cross_k", "cross_v"}
    for name in got:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == torch.bfloat16, name
        _close(got[name], want[name], err_msg=name)
    _close(got_last, want_last)


def test_teacher_forced_decode_steps(pair):
    """Prefill, then 8 decode steps on both sides, each fed the
    reference's greedy token; logits at every step."""
    cfg, ref, ref_params, port, params = pair
    frames, tokens = _inputs(cfg, 4, S_DEC)
    max_len = S_DEC + 8
    _, rc = ref.prefill(ref_params, {"frames": _jnp(frames),
                                     "tokens": jnp.asarray(tokens)})
    _, pc = port.prefill(params, {"frames": frames,
                                  "tokens": torch.from_numpy(tokens)})
    ref_cache = ref.init_cache(B, max_len, S_ENC)
    ref_cache = dict(ref_cache, cross_k=rc["cross_k"], cross_v=rc["cross_v"],
                     k=ref_cache["k"].at[:, :, :S_DEC].set(rc["k"]),
                     v=ref_cache["v"].at[:, :, :S_DEC].set(rc["v"]))
    cache = dense_cache_from_prefill(port, pc, B, max_len)
    tok = tokens[:, -1:]
    for t in range(8):
        cl = np.full((B,), S_DEC + t, np.int32)
        want, ref_cache = ref.decode_step(ref_params, jnp.asarray(tok),
                                          ref_cache, jnp.asarray(cl))
        got, cache = port.decode_step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(cl))
        _close(got, want, err_msg=f"step {t}")
        tok = np.array(jnp.argmax(want, axis=-1), np.int32)[:, None]


def test_decode_matches_full_forward(pair):
    """In the port alone, as tests/test_models_consistency.py does for
    the reference: prefill S tokens, decode token S+1 over a dense cache
    padded by 4 slots, against the full forward's last logits."""
    cfg, _, _, port, params = pair
    frames, tokens = _inputs(cfg, 0)
    toks = torch.from_numpy(tokens)
    full, _, _ = port.forward(params, {"frames": frames, "tokens": toks})
    _, pre = port.prefill(params, {"frames": frames,
                                   "tokens": toks[:, :S_DEC]})
    cache = dense_cache_from_prefill(port, pre, B, S_DEC + 4)
    got, _ = port.decode_step(params, toks[:, S_DEC:], cache,
                              torch.full((B,), S_DEC, dtype=torch.int32))
    _close(got, full[:, -1].float())


def test_cache_shapes_match_reference(pair):
    cfg, ref, _, port, _ = pair
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        ref.cache_shapes(3, 40, 24))
    got = {k: (tuple(shape), str(dtype).removeprefix("torch."))
           for k, (shape, dtype) in port.cache_shapes(3, 40, 24).items()}
    assert got == want
    cache = port.init_cache(3, 40, 24, device="cpu")
    assert all(float(t.abs().sum()) == 0 for t in cache.values())


def test_paged_engine_and_cli_refuse_encdec(pair):
    """As in the reference: the paged engine and the serving CLI do not
    take the encoder-decoder (its path is Model.prefill/decode_step)."""
    _, _, _, port, params = pair
    assert not port.supports_paged
    with pytest.raises(ValueError, match="not servable through the paged"):
        ServingEngine(model=port, scheduler=Scheduler(), params=params,
                      device="cpu")
    with pytest.raises(SystemExit, match="decoder-only archs"):
        port_serve.main(["--arch", ARCH, "--device", "cpu"])
