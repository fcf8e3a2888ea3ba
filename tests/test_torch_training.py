"""Training in the port (repro_torch.training, repro_torch.data.datasets,
``Model.loss_fn`` / ``param_specs``, ``lm_loss``, remat,
``launch.train``) against the reference (repro.training and friends).

Every input is drawn with numpy from a seed and handed to both sides; the
models run the reference's own weights upcast to f32 (jax 0.9 on the CPU
cannot run a bf16 x bf16 -> f32 dot, ROADMAP Queue C R1), carried into
the port by ``params_from_numpy``.  The encoder-decoder cannot take f32
weights in the reference (R5): it runs both packages on the reference's
bf16 weights at the bar of tests/test_models_consistency.py (rtol 5e-2,
atol 2e-2), and is held to the port's own invariants besides.  On the
CPU the flash op under autograd runs ``FlashAttentionFunction`` with the
plain versions in place of the kernels, so these tests exercise the
card's saved tensors and GQA reduction, and so does the SSD scan under
``SSDScanFunction`` (``ssd_backward_reference``); the decode ops' plain
versions stay differentiable here (their refusal on the card is tested by
patching the device check).
"""

import os
import re
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.data import lm_batches as ref_lm_batches
from repro.data import zipf_tokens as ref_zipf_tokens
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.training import AdamW as RefAdamW
from repro.training import load_checkpoint as ref_load_checkpoint
from repro.training import make_lr_schedule as ref_make_lr_schedule
from repro.training import make_train_step as ref_make_train_step
from repro.training import save_checkpoint as ref_save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import lm_batches, zipf_tokens
from repro_torch.kernels import grad_guard
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_op, decode_attention_paged_lse_op,
    decode_attention_paged_op)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.layers import shapes_from_template
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import lm_loss
from repro_torch.training import (AdamW, AdamWState, load_checkpoint,
                                  make_lr_schedule, make_train_step,
                                  save_checkpoint)
from repro_torch.tree import tree_leaves, tree_unflatten

# one intra-op thread: the suite runs files in parallel workers, and
# torch's default thread pool per worker would oversubscribe the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-6
# (arch, overrides): olmoe-1b-7b at half its capacity, so that tokens drop
LOSS_CASES = [("llama3.2-1b", {}), ("qwen2-1.5b", {}),
              ("olmoe-1b-7b", {"capacity_factor": 0.5}),
              ("deepseek-moe-16b", {}), ("internvl2-76b", {}),
              ("mamba2-2.7b", {}), ("zamba2-1.2b", {})]
B, S = 2, 32


def _f32_pair(arch, **overrides):
    """(ref cfg, ref model, ref f32 params, port model, port params): the
    reference's own weights, upcast; qkv biases made non-zero."""
    cfg = ref_get_config(arch, reduced=True).with_overrides(**overrides)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref.init(jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            b = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = rng.normal(
                0, 0.02, b.shape).astype(np.float32)
    port = build_model(get_config(arch, reduced=True).with_overrides(
        **overrides))
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port, \
        params_from_numpy(tree, "cpu")


def _batch(cfg, seed, b=B, s=S):
    """numpy batch: tokens == labels, and patches for the VLM."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(0, 0.02, (b, 4, cfg.d_model)).astype(
            np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(model, params, batch, remat=None):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = model.loss_fn(tree_unflatten(params, leaves),
                                  _torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, grads


def _ref_grads(ref, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: ref.loss_fn(p, jb), has_aux=True)(params)
    return loss, metrics, jax.tree.leaves(grads)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 3])
def test_lm_batches_bit_identical(seed):
    ref, port = ref_lm_batches(1000, 4, 96, seed=seed), \
        lm_batches(1000, 4, 96, seed=seed)
    for _ in range(5):
        a, b = next(ref), next(port)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    assert np.array_equal(ref_zipf_tokens(r1, 500, 300),
                          zipf_tokens(r2, 500, 300))


# ------------------------------------------------------------ param specs

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_shapes_match_reference(arch):
    assert ARCH_IDS == REF_ARCH_IDS
    ref = ref_build_model(ref_get_config(arch))
    port = build_model(get_config(arch))
    assert port.param_specs() == ref.param_specs()
    from repro.models.layers import shapes_from_template as ref_shapes
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        ref_shapes(ref.template()))
    got = shapes_from_template(port.template())
    flat = jax.tree.map(lambda sd: (sd[0], str(sd[1]).removeprefix(
        "torch.")), got, is_leaf=lambda x: isinstance(x, tuple)
        and len(x) == 2 and isinstance(x[0], tuple))
    assert flat == want


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 3, (3, 17, 101)).astype(np.float32)
    labels = rng.integers(0, 101, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) > 0.4).astype(np.float32) if masked \
        else None
    want = float(ref_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask)))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6)
    # an empty mask: the count is clamped at 1, the loss 0
    zero = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                   torch.zeros(3, 17))
    assert float(zero) == 0.0


def _sequential_ssd(x, dt, a_decay, bmat, cmat, init_state=None,
                    chunk=256):
    """The reference's SSD scan as its own sequential oracle
    (repro/kernels/ssd_scan/ref.py's recurrence, with the final state):
    the same function as ``repro.models.ssm.ssd_chunked``, whose gradient
    is NaN once a chunk's masked segment sums overflow exp (ROADMAP Queue
    C R7)."""
    f32 = jnp.float32
    b, s, h, p = x.shape
    n = bmat.shape[-1]

    def step(state, xs):
        xt, dtt, at, bt, ct = xs
        xdt = xt.astype(f32) * dtt.astype(f32)[..., None]
        state = state * at.astype(f32)[..., None, None] \
            + jnp.einsum("bhp,bn->bhpn", xdt, bt.astype(f32))
        return state, jnp.einsum("bhpn,bn->bhp", state, ct.astype(f32))

    init = jnp.zeros((b, h, p, n), f32) if init_state is None else init_state
    final, ys = jax.lax.scan(step, init, tuple(
        jnp.moveaxis(t, 1, 0) for t in (x, dt, a_decay, bmat, cmat)))
    return jnp.moveaxis(ys, 0, 1).astype(x.dtype), final


@pytest.mark.parametrize("arch,overrides", LOSS_CASES,
                         ids=[a for a, _ in LOSS_CASES])
def test_loss_fn_and_gradients_match_reference(arch, overrides,
                                               monkeypatch):
    """Model.loss_fn and the gradient of every parameter against
    jax.value_and_grad of the reference's loss_fn (cfg.remat on both).
    For the recurrent families the reference's chunked scan is swapped
    for its sequential oracle (``_sequential_ssd``) in this process, so
    that its gradient is finite; every gradient compared is."""
    cfg, ref, ref_params, port, params = _f32_pair(arch, **overrides)
    batch = _batch(cfg, seed=5)
    if overrides.get("capacity_factor"):
        # fewer slots than assignments: tokens drop
        n = B * S
        assert capacity(port.cfg, n, decode=False) * cfg.n_experts \
            < n * cfg.experts_per_token
    if cfg.family in ("ssm", "hybrid"):
        monkeypatch.setattr(ref_ssm, "ssd_chunked", _sequential_ssd)
    want_loss, want_m, want_g = _ref_grads(ref, ref_params, batch)
    loss, metrics, grads = _port_grads(port, params, batch)
    assert float(loss) == pytest.approx(float(want_loss), rel=RTOL)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), rtol=RTOL, atol=ATOL)
    if cfg.family == "moe":
        assert float(metrics["aux_loss"].detach()) > 0
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        w = np.asarray(w)
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_reference_ssd_gradient_is_nan_r7():
    """Pins ROADMAP Queue C R7: the reference's chunked scan masks exp of
    the segment sums after taking it, so its gradient is NaN at the
    reduced mamba2-2.7b's weights; the port's plain scan masks before
    (the same forward) and its gradient is finite."""
    cfg, ref, ref_params, port, params = _f32_pair("mamba2-2.7b")
    batch = _batch(cfg, seed=5)
    want_loss, _, want_g = _ref_grads(ref, ref_params, batch)
    assert any(np.isnan(np.asarray(w)).any() for w in want_g)
    loss, _, grads = _port_grads(port, params, batch)
    assert float(loss) == pytest.approx(float(want_loss), rel=RTOL)
    assert all(torch.isfinite(g).all() for g in grads)


def test_encdec_loss_and_gradients_match_reference_bf16():
    """seamless-m4t-medium on the reference's bf16 weights (R5) at the
    reference's own bar for this path (rtol 5e-2, atol 2e-2)."""
    arch = "seamless-m4t-medium"
    cfg = ref_get_config(arch, reduced=True)
    ref = ref_build_model(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(arch, reduced=True))
    params = params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(2)
    frames = rng.normal(0, 0.02, (B, 12, cfg.d_model)).astype(np.float32)
    frames = torch.from_numpy(frames).bfloat16()
    toks = rng.integers(3, cfg.vocab_size, (B, 16)).astype(np.int32)
    jb = {"frames": jnp.asarray(frames.float().numpy()).astype(jnp.bfloat16),
          "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    (want, _), want_g = jax.value_and_grad(
        lambda p: ref.loss_fn(p, jb), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = port.loss_fn(tree_unflatten(params, leaves), {
        "frames": frames, "tokens": torch.from_numpy(toks),
        "labels": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(want), rel=5e-2, abs=2e-2)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        assert g.dtype == getattr(torch, str(w.dtype))
        assert torch.isfinite(g).all() and np.isfinite(
            np.asarray(w, np.float32)).all()
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=5e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "internvl2-76b", "mamba2-2.7b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_remat_changes_nothing(arch):
    """Remat on against off: the loss and every gradient bit-identical."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    if cfg.family != "encdec":
        params = {k: v for k, v in params.items()}
        params = tree_unflatten(params, [p.float() if p.is_floating_point()
                                         else p
                                         for p in tree_leaves(params)])
    batch = _batch(cfg, seed=9)
    if cfg.family == "encdec":
        rng = np.random.default_rng(9)
        batch["frames"] = rng.normal(0, 0.02, (B, 12, cfg.d_model)).astype(
            np.float32)
    on = _port_grads(model, params, batch, remat=True)
    off = _port_grads(model, params, batch, remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[2], off[2]):
        assert torch.equal(a, b)


def test_encdec_trains_on_its_own():
    """The encoder-decoder's training held to the port's invariants (its
    reference cannot take f32 weights, R5): finite losses that fall over
    10 steps of the train step."""
    cfg = get_config("seamless-m4t-medium", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=3e-3)
    state = opt.init(params)
    step = make_train_step(model, opt, make_lr_schedule(warmup=2, total=10))
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.normal(0, 0.02, (4, 12, cfg.d_model))
                              .astype(np.float32)).bfloat16()
    data = lm_batches(cfg.vocab_size, 4, 32, seed=0)
    losses = []
    for _ in range(10):
        b = _torch_batch(next(data))
        b["frames"] = frames
        params, state, mt = step(params, state, b)
        losses.append(float(mt["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.2


# --------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup,total,min_frac", [(10, 100, 0.1),
                                                   (2, 20, 0.1),
                                                   (0, 7, 0.25)])
def test_lr_schedule_matches_reference(warmup, total, min_frac):
    ref = ref_make_lr_schedule(warmup=warmup, total=total, min_frac=min_frac)
    port = make_lr_schedule(warmup=warmup, total=total, min_frac=min_frac)
    for step in range(total + 3):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(ref(step)), rel=1e-6,
                                           abs=1e-7)
    assert float(port(0)) == 0.0 or warmup == 0


# ------------------------------------------------------------------ AdamW

def _adam_tree(rng):
    """f32 leaves of 1, 2 and 3 dims (the last above the lowered
    chunk_threshold) and bf16 leaves."""
    return {"a": rng.normal(0, 1, (7,)).astype(np.float32),
            "b": {"w": rng.normal(0, 1, (5, 6)).astype(np.float32),
                  "stack": rng.normal(0, 1, (3, 4, 5)).astype(np.float32)},
            "h": rng.normal(0, 1, (4, 6)).astype(np.float32),
            "hb": rng.normal(0, 1, (6,)).astype(np.float32)}


BF16_LEAVES = ("h", "hb")


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    rng = np.random.default_rng(21)
    tree = _adam_tree(rng)
    kw = dict(learning_rate=0.05, moment_dtype=moment_dtype,
              chunk_threshold=16)
    ref_opt, opt = RefAdamW(**kw), AdamW(**kw)

    def ref_cast(t):
        return {k: (ref_cast(v) if isinstance(v, dict) else
                    jnp.asarray(v).astype(jnp.bfloat16 if k in BF16_LEAVES
                                          else jnp.float32))
                for k, v in t.items()}

    rp = ref_cast(tree)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    rs, ps = ref_opt.init(rp), opt.init(pp)
    assert ps.count.dtype == torch.int32
    for i, scale in enumerate((1.0, 0.5, 0.25)):
        g = ref_cast(jax.tree.map(lambda a: rng.normal(0, 1, a.shape)
                                  .astype(np.float32), tree))
        tg = params_from_numpy(jax.tree.map(np.asarray, g), "cpu")
        rp, rs = ref_opt.update(g, rs, rp, lr_scale=jnp.float32(scale))
        pp, ps = opt.update(tg, ps, pp, lr_scale=torch.tensor(scale))
        assert int(ps.count) == int(rs.count) == i + 1
        for want, got in ((rp, pp), (rs.m, ps.m), (rs.v, ps.v)):
            for w, t in zip(jax.tree.leaves(want), tree_leaves(got)):
                w = np.asarray(w)
                assert str(t.dtype).removeprefix("torch.") == str(w.dtype)
                if t.dtype == torch.bfloat16:
                    # within one bf16 step of the value
                    step = np.abs(w.astype(np.float32)) * 2.0 ** -7 + 1e-30
                    assert np.all(np.abs(t.float().numpy()
                                         - w.astype(np.float32)) <= step)
                else:
                    np.testing.assert_allclose(t.numpy(), w, rtol=1e-6,
                                               atol=1e-7)


def test_adamw_chunked_update_changes_nothing():
    """A leaf over chunk_threshold with three dims is updated one leading
    slice at a time: the same result as whole."""
    rng = np.random.default_rng(3)
    p = {"w": torch.from_numpy(rng.normal(0, 1, (4, 5, 6)).astype(
        np.float32))}
    g = {"w": torch.from_numpy(rng.normal(0, 1, (4, 5, 6)).astype(
        np.float32))}
    whole, chunked = AdamW(learning_rate=0.1), \
        AdamW(learning_rate=0.1, chunk_threshold=10)
    a, sa = whole.update(g, whole.init(p), p)
    b, sb = chunked.update(g, chunked.init(p), p)
    assert torch.equal(a["w"], b["w"]) and torch.equal(sa.m["w"], sb.m["w"]) \
        and torch.equal(sa.v["w"], sb.v["w"])


def test_adamw_matches_reference_on_scalar_quadratic():
    """tests/test_training.py's case, step for step against the
    reference."""
    opt, ref_opt = AdamW(learning_rate=0.1, weight_decay=0.0), \
        RefAdamW(learning_rate=0.1, weight_decay=0.0)
    params, rp = {"w": torch.tensor([2.0])}, {"w": jnp.array([2.0])}
    state, rs = opt.init(params), ref_opt.init(rp)
    for _ in range(50):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
        rp, rs = ref_opt.update({"w": 2 * rp["w"]}, rs, rp)
        assert float(params["w"][0]) == pytest.approx(float(rp["w"][0]),
                                                      rel=1e-5, abs=1e-6)
    assert abs(float(params["w"][0])) < 0.5


# ------------------------------------------------------------- train step

def _step_pair(arch, accum=1, lr=1e-3, **overrides):
    """Both packages' train steps (AdamW at ``lr``, no schedule) on the
    same f32 weights."""
    cfg, ref, rp, port, pp = _f32_pair(arch, grad_accum=accum, **overrides)
    return cfg, ref, rp, port, pp, \
        ref_make_train_step(ref, RefAdamW(learning_rate=lr)), \
        make_train_step(port, AdamW(learning_rate=lr))


def _hold_params(got, want, grads, lr):
    """Within 1e-4 relative wherever |grad| > 1e-6, everywhere within 2 lr
    (an AdamW step is about lr sign(g), whose sign a near-zero gradient
    may flip)."""
    for t, w, g in zip(tree_leaves(got), jax.tree.leaves(want), grads):
        t, w = t.detach().numpy(), np.asarray(w)
        assert np.isfinite(t).all() and np.isfinite(w).all()
        big = np.abs(g.numpy()) > 1e-6
        np.testing.assert_allclose(t[big], w[big], rtol=1e-4, atol=1e-7)
        assert np.all(np.abs(t - w) <= 2 * lr * (1 + 1e-4))


@pytest.mark.parametrize("arch,overrides", [
    ("llama3.2-1b", {}), ("olmoe-1b-7b", {"capacity_factor": 0.5})],
    ids=["llama3.2-1b", "olmoe-1b-7b"])
def test_train_step_matches_reference_over_three_steps(arch, overrides):
    """Three steps of both packages' train steps: the loss (and an MoE's
    router aux loss) within 1e-4 relative at each, the params after the
    first held to the reference's (``_hold_params``).  olmoe-1b-7b runs at
    half its capacity, so that tokens drop: its dispatch's gradient (kept
    rows only, none through the dump row) is held over steps whose routing
    moves with the weights."""
    lr = 1e-3
    cfg, ref, rp, port, pp, ref_step, step = _step_pair(arch, lr=lr,
                                                        **overrides)
    if overrides:
        n = 4 * 32
        assert capacity(port.cfg, n, decode=False) * cfg.n_experts \
            < n * cfg.experts_per_token
    rs, ps = RefAdamW(learning_rate=lr).init(rp), \
        AdamW(learning_rate=lr).init(pp)
    data = ref_lm_batches(cfg.vocab_size, 4, 32, seed=0)
    for i in range(3):
        b = next(data)
        if i == 0:
            _, _, grads = _port_grads(port, pp, b)
        rp, rs, rmt = ref_step(rp, rs, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        pp, ps, mt = step(pp, ps, _torch_batch(b))
        assert float(mt["loss"]) == pytest.approx(float(rmt["loss"]),
                                                  rel=1e-4)
        if cfg.family == "moe":
            assert float(mt["aux_loss"]) > 0
            assert float(mt["aux_loss"]) == pytest.approx(
                float(rmt["aux_loss"]), rel=1e-4)
        if i == 0:
            _hold_params(pp, rp, grads, lr)
    assert int(ps.count) == 3


def test_grad_accum_two_equals_one_and_matches_reference():
    """accum 2 over a 4-batch against accum 1 at tests/test_training.py's
    bars, and against the reference's own accum-2 step at 1e-4."""
    lr = 1e-3
    b = next(ref_lm_batches(ref_get_config("qwen2-1.5b", reduced=True)
                            .vocab_size, 4, 32, seed=1))
    out = {}
    for accum in (1, 2):
        cfg, ref, rp, port, pp, ref_step, _ = _step_pair("qwen2-1.5b", accum,
                                                         lr)
        opt = AdamW(learning_rate=lr)
        step = make_train_step(port, opt)
        out[accum] = step(pp, opt.init(pp), _torch_batch(b))
        if accum == 2:
            ref_opt = RefAdamW(learning_rate=lr)
            rp2, _, rmt = ref_make_train_step(ref, ref_opt)(
                rp, ref_opt.init(rp), {k: jnp.asarray(v)
                                       for k, v in b.items()})
            assert float(out[2][2]["loss"]) == pytest.approx(
                float(rmt["loss"]), rel=1e-4)
            _, _, grads = _port_grads(port, pp, b)
            _hold_params(out[2][0], rp2, grads, lr)
    assert float(out[1][2]["loss"]) == pytest.approx(
        float(out[2][2]["loss"]), rel=1e-2)
    for a, c in zip(tree_leaves(out[1][0]), tree_leaves(out[2][0])):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   rtol=5e-2, atol=5e-3)


# ------------------------------------------------------------- checkpoint

def _ckpt_trees():
    cfg = ref_get_config("mamba2-2.7b", reduced=True)
    ref = ref_build_model(cfg)
    rp = ref.init(jax.random.PRNGKey(3))
    ropt = RefAdamW()
    rs = ropt.init(rp)
    # moments that are not zero
    rs = rs._replace(count=jnp.asarray(7, jnp.int32),
                     m=jax.tree.map(lambda a: a + 0.25, rs.m),
                     v=jax.tree.map(lambda a: a + 0.5, rs.v))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    ps = AdamWState(count=torch.tensor(7, dtype=torch.int32),
                    m=params_from_numpy(jax.tree.map(np.asarray, rs.m),
                                        "cpu"),
                    v=params_from_numpy(jax.tree.map(np.asarray, rs.v),
                                        "cpu"))
    return rp, rs, pp, ps


def _same(port_tree, ref_tree):
    leaves = tree_leaves(port_tree) if isinstance(port_tree, dict) \
        else [port_tree]
    for t, w in zip(leaves, jax.tree.leaves(ref_tree)):
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype)
        assert np.array_equal(t.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_read_by_the_other_package(writer):
    rp, rs, pp, ps = _ckpt_trees()
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(pp))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        if writer == "port":
            save_checkpoint(path, pp, ps, step=42)
            assert not os.path.exists(path + ".tmp.npz")
            with np.load(path) as data:
                assert all(data[k].dtype != np.dtype("V2") for k in data)
            p2, s2, step = ref_load_checkpoint(path, rp, rs)
            assert step == 42
            _same(pp, p2)
            _same(ps.m, s2.m)
            _same(ps.v, s2.v)
            assert int(s2.count) == 7 and s2.count.dtype == jnp.int32
        else:
            ref_save_checkpoint(path, rp, rs, step=42)
            p2, s2, step = load_checkpoint(path, pp, ps)
            assert step == 42
            _same(p2, rp)
            _same(s2.m, rs.m)
            _same(s2.v, rs.v)
            assert s2.count.dtype == torch.int32 and int(s2.count) == 7
        # and a round trip in the port alone, params only
        save_checkpoint(path, pp, step=3)
        p3, none, step = load_checkpoint(path, pp)
        assert none is None and step == 3
        for a, b in zip(tree_leaves(pp), tree_leaves(p3)):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- launch

def test_launch_train_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    for ln in lines:
        assert re.fullmatch(r"step +\d+ loss \d+\.\d{4} \(\d+\.\d{2}s/step\)",
                            ln), ln


# ------------------------------------------------------------------ guard

def _ssd_inputs(requires_grad):
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 16, 2, 32, 16
    x = torch.from_numpy(rng.normal(0, 1, (b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(rng.random((b, s, h)).astype(np.float32))
    a = torch.from_numpy(rng.random((b, s, h)).astype(np.float32))
    bm = torch.from_numpy(rng.normal(0, 1, (b, s, n)).astype(np.float32))
    cm = torch.from_numpy(rng.normal(0, 1, (b, s, n)).astype(np.float32))
    x.requires_grad_(requires_grad)
    return x, dt, a, bm, cm


def _decode_calls(q):
    kc = torch.zeros(2, 8, 1, 64)
    pool = torch.zeros(4, 8, 1, 64)
    tables = torch.ones(2, 1, dtype=torch.int32)
    cl = torch.full((2,), 3, dtype=torch.int32)
    return {"decode_attention": lambda: decode_attention_op(q, kc, kc, cl),
            "decode_attention_paged": lambda: decode_attention_paged_op(
                q, pool, pool, tables, cl),
            "decode_attention_paged_lse":
                lambda: decode_attention_paged_lse_op(q, pool, pool, tables,
                                                      cl)}


def _graph_nodes(t):
    """The names of every autograd node below ``t``."""
    seen, todo = [], [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and node.name() not in seen:
            seen.append(node.name())
            todo.extend(f for f, _ in node.next_functions)
    return seen


def test_ops_without_backward_refuse_autograd_on_the_card(monkeypatch):
    """The decode ops raise NotImplementedError under autograd on the card
    (the device check patched so that it runs here), saying they are
    serving-only, never returning a detached tensor; with grad disabled or
    nothing requiring it they run.  The SSD scan has its backward kernel:
    with the same device check patched, its outputs carry a gradient
    through SSDScanFunction."""
    monkeypatch.setattr(grad_guard, "on_card", lambda t: True)
    y, state = ssd_scan(*_ssd_inputs(True), chunk=8)
    for out in (y, state):
        assert out.grad_fn is not None
        assert "SSDScanFunctionBackward" in _graph_nodes(out)
    q = torch.zeros(2, 1, 64, requires_grad=True)
    for name, call in _decode_calls(q).items():
        with pytest.raises(NotImplementedError, match=name) as err:
            call()
        assert grad_guard.SERVING_ONLY in str(err.value)
        assert "Queue A" not in str(err.value)
    with torch.no_grad():
        y, _ = ssd_scan(*_ssd_inputs(True), chunk=8)
        assert y.grad_fn is None
        for call in _decode_calls(q).values():
            call()
    y, _ = ssd_scan(*_ssd_inputs(False), chunk=8)
    assert y.grad_fn is None
    assert not hasattr(grad_guard, "BACKWARD_ITEM")


def test_ops_without_backward_stay_differentiable_on_cpu():
    x, dt, a, bm, cm = _ssd_inputs(True)
    y, _ = ssd_scan(x, dt, a, bm, cm, chunk=8)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    q = torch.randn(2, 1, 64, requires_grad=True)
    for call in _decode_calls(q).values():
        out = call()
        out = out[0] if isinstance(out, tuple) else out
        assert out.grad_fn is not None
