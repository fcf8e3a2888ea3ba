"""The training and dry-run rule sets, the production meshes, the
activation-sharding hooks and the launcher's placement of the port
(``repro_torch.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.launch.train``), held to the reference.

The reference's rule functions read only ``mesh.axis_names`` and
``mesh.shape[...]``, so both packages take the same stand-in mesh here
(the reference's own production mesh needs 256 devices); their specs must
equal the reference's ``PartitionSpec``s entry for entry."""

from types import SimpleNamespace

import dataclasses

import numpy as np
import pytest
import torch

import repro.sharding.partitioning as ref_part
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro_torch.configs import get_config
from repro_torch.data import lm_batches
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import context as ctx
from repro_torch.sharding import partitioning as part
from repro_torch.training import AdamW, make_train_step

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
MODES = ("train", "serve", "serve_big")
BATCHES = (None, 1, 8, 16, 32, 128, 256)


def stand_in(name: str):
    axes, shape = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def spec(p) -> tuple:
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_axes_match_reference(mesh_name):
    mesh = stand_in(mesh_name)
    for b in BATCHES:
        assert part.batch_axes(mesh, b) == ref_part.batch_axes(mesh, b), b


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_match_reference(arch, mesh_name):
    """rules_for, kv_cache_spec, ssm_state_spec and logits_spec for every
    mode and batch, entry for entry."""
    mesh = stand_in(mesh_name)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for mode in MODES:
        assert part.rules_for(cfg, mode, mesh) \
            == ref_part.rules_for(rcfg, mode, mesh), mode
        for b in BATCHES:
            assert part.kv_cache_spec(cfg, mode, mesh, b) \
                == spec(ref_part.kv_cache_spec(rcfg, mode, mesh, b))
            want = ref_part.ssm_state_spec(rcfg, mode, mesh, b)
            assert part.ssm_state_spec(cfg, mode, mesh, b) \
                == {k: spec(v) for k, v in want.items()}
            assert part.logits_spec(mesh, mode, b) \
                == spec(ref_part.logits_spec(mesh, mode, b))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolved_parameter_specs_match_reference(arch):
    """The train rules resolved over the parameter tree on the multi-pod
    mesh, leaf by leaf."""
    from repro.models import build_model as ref_build_model
    import jax
    from jax.sharding import PartitionSpec as P
    mesh = stand_in("2x16x16")
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    got = part.resolve_specs(build_model(cfg).param_specs(),
                             part.rules_for(cfg, "train", mesh))
    want = ref_part.resolve_specs(ref_build_model(rcfg).param_specs(),
                                  ref_part.rules_for(rcfg, "train", mesh))
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0]
    from repro_torch.tree import tree_items
    port = dict(tree_items(got))
    assert len(port) == len(flat)
    for path, p in flat:
        key = tuple(k.key for k in path)
        assert port[key] == spec(p), key


def test_production_meshes():
    for multi, axes, shape in ((False, ("data", "model"), (16, 16)),
                               (True, ("pod", "data", "model"), (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.axis_names == axes
        assert tuple(mesh.shape.values()) == shape
        assert mesh.size == int(np.prod(shape))
        assert all(d == torch.device("meta") for d in mesh.devices.flat)
    assert not torch.cuda.is_initialized()


def test_named_shardings_map_a_spec_tree():
    mesh = make_production_mesh(multi_pod=True)
    tree = {"a": (("pod", "data"), "model"), "b": {"c": (None,)}}
    got = part.named_shardings(mesh, tree)
    assert got["a"].spec == (("pod", "data"), "model")
    assert got["b"]["c"].spec == (None,)
    assert got["a"].devices is mesh.devices
    assert [got["a"].axis_size(e) for e in got["a"].spec] == [32, 16]
    assert got["b"]["c"].axis_size(None) == 1


# ------------------------------------------------------------ the hooks

HOOKS = (ctx.constrain_activations, ctx.constrain_heads,
         ctx.constrain_inner, ctx.constrain_ssm_state)


def _install(mesh, spec_):
    s = part.NamedSharding(mesh, spec_)
    return ctx.activation_sharding(s, s, s, s, s)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hooks_are_the_identity_outside_a_context(device):
    x = torch.zeros(2, 3, 4, device=device)
    for hook in HOOKS:
        assert hook(x) is x
    assert ctx.constrain_expert_buf(x)[0] is x


def test_hooks_are_the_identity_on_the_local_mesh():
    mesh = make_local_mesh(devices=["cpu"])
    x = torch.randn(2, 3, 4)
    with _install(mesh, ("data", "model", None)):
        for hook in HOOKS:
            assert hook(x) is x
        assert ctx.constrain_expert_buf(x)[0] is x


def test_hooks_are_the_identity_on_meta():
    mesh = make_production_mesh(multi_pod=True)
    x = torch.empty(2, 3, 4, device="meta")
    with _install(mesh, (("pod", "data"), "model", None)):
        for hook in HOOKS:
            assert hook(x) is x
        assert ctx.constrain_expert_buf(x)[0] is x


def test_hooks_raise_on_a_wide_axis_over_real_devices():
    mesh = make_local_mesh(tp=2, devices=["cpu"] * 2)
    x = torch.randn(2, 3, 4)
    with _install(mesh, (None, "model", None)):
        for hook in HOOKS:
            with pytest.raises(NotImplementedError, match="Queue A 15"):
                hook(x)
        with pytest.raises(NotImplementedError, match="Queue A 15"):
            ctx.constrain_expert_buf(x)
    # an axis of size 1 over the same mesh is fine
    with _install(mesh, ("data", None, None)):
        for hook in HOOKS:
            assert hook(x) is x


def test_activation_sharding_restores_the_previous_state():
    mesh = make_local_mesh(devices=["cpu"])
    outer = part.NamedSharding(mesh, ("data", None, None))
    inner = part.NamedSharding(mesh, (None, "model", None))
    with ctx.activation_sharding(outer):
        with ctx.activation_sharding(inner, heads_spec=inner):
            assert ctx._state.spec is inner
            assert ctx._state.heads_spec is inner
        assert ctx._state.spec is outer
        assert ctx._state.heads_spec is None
    for key in ctx._TRAIN_KEYS:
        assert getattr(ctx._state, key) is None


def _train_losses(cfg, steps: int, *, sharding: bool):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=3e-3, moment_dtype=cfg.moment_dtype)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, port_train.schedule_for(steps))
    data = lm_batches(cfg.vocab_size, 2, 32, seed=0)
    mesh = make_local_mesh(devices=["cpu"])

    def shard(s):
        return part.NamedSharding(mesh, s)
    out = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        if sharding:
            with ctx.activation_sharding(
                    shard(("data", "model", None)),
                    shard(("data", None, "model", None)),
                    shard(("data", None, "model")),
                    shard(("data", "model", None, None)),
                    shard(("model", None, None))):
                params, state, m = step_fn(params, state, batch)
        else:
            params, state, m = step_fn(params, state, batch)
        out.append(m["loss"].item())
    return out, params


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_train_loss_bit_identical_under_activation_sharding(arch):
    """The train step with the reference's training specs installed on
    the 1x1 mesh gives the losses and weights of the step without them,
    bit for bit (dense, MoE and hybrid: every hook's call site runs)."""
    cfg = get_config(arch, reduced=True)
    want, p0 = _train_losses(cfg, 2, sharding=False)
    got, p1 = _train_losses(cfg, 2, sharding=True)
    assert got == want
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


def test_launcher_equals_a_direct_train_step(capsys):
    """launch.train.main on the CPU prints the losses of a direct
    make_train_step run over the same weights, batches and schedule."""
    port_train.main(["--device", "cpu", "--steps", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    got = {int(ln.split()[1]): ln.split()[3] for ln in lines}
    cfg = get_config("llama3.2-1b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=3e-3, moment_dtype=cfg.moment_dtype)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, port_train.schedule_for(3))
    data = lm_batches(cfg.vocab_size, 8, 128, seed=0)
    want = {}
    for step in range(3):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params, state, m = step_fn(params, state, batch)
        want[step] = f"{float(m['loss']):.4f}"
    assert got == {k: want[k] for k in (0, 2)}


def test_launcher_places_parameters_by_the_train_rules():
    cfg = get_config("llama3.2-1b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    local = make_local_mesh(devices=["cpu"])
    rules = part.rules_for(cfg, "train", local)
    shardings = part.named_shardings(local, part.resolve_specs(
        model.param_specs(), rules))
    placed = port_train.place_params(params, shardings)
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(params), tree_leaves(placed)):
        assert b is a or torch.equal(a, b)
    wide = make_local_mesh(tp=2, devices=["cpu"] * 2)
    shardings = part.named_shardings(wide, part.resolve_specs(
        model.param_specs(), part.rules_for(cfg, "train", wide)))
    with pytest.raises(NotImplementedError, match="Queue A 15"):
        port_train.place_params(params, shardings)


def test_fsdp_embed_rule_on_the_pod_mesh():
    """An FSDP config stores 'embed' over ('pod', 'data') when training on
    the multi-pod mesh, over 'data' for serve_big."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), fsdp=True)
    mesh = stand_in("2x16x16")
    assert part.rules_for(cfg, "train", mesh)["embed"] == ("pod", "data")
    assert part.rules_for(cfg, "serve_big", mesh)["embed"] == "data"
    assert part.rules_for(cfg, "serve", mesh)["embed"] is None
