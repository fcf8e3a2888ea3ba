"""Shared harness of the engine-level parity tests (prefix sharing, the
Gateway, the fault toolkit): one package tuple per side, the reference's
weights upcast to f32 for both engines, and the engine counters held
equal.

jax 0.9.0 on the CPU cannot run the reference's bf16 dots (ROADMAP Queue
C, R1), so both engines run the same f32 copy of the reference's
weights; the reference's conv cache starts in f32 (R4, see
tests/test_torch_engine.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as ref_core
import repro.serving as ref_serving
import repro.testing as ref_testing
import repro_torch.core as port_core
import repro_torch.serving as port_serving
import repro_torch.testing as port_testing
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy

# (core, serving, testing, get_config, build_model) of each package
REF = (ref_core, ref_serving, ref_testing, ref_get_config, ref_build_model)
PORT = (port_core, port_serving, port_testing, get_config, build_model)

COUNTERS = ("preemptions", "swap_outs", "swap_ins", "forced_evictions",
            "grow_failures", "prefills", "prefill_chunks", "prefill_tokens",
            "prefill_tokens_reused", "decode_tokens", "completed",
            "aborted", "timeout_aborts", "wasted_tokens", "shed", "retries",
            "swap_in_faults")

_WEIGHTS: dict = {}


def weights(arch: str):
    """(reference f32 params, port f32 params) of the reduced ``arch``,
    made once per process from ``PRNGKey(0)``."""
    if arch not in _WEIGHTS:
        cfg = ref_get_config(arch, reduced=True)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            ref_build_model(cfg).init(jax.random.PRNGKey(0)))
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, tree),
                          params_from_numpy(tree, "cpu"))
    return _WEIGHTS[arch]


def engine(pkg, arch: str, *, scheduler, **kw):
    """A ``ServingEngine`` of ``pkg`` over the reduced ``arch`` on the
    shared f32 weights (the port's on the CPU)."""
    _, serving, _, get_cfg, build = pkg
    ref_params, params = weights(arch)
    if serving is port_serving:
        kw.update(params=params, device="cpu")
    else:
        kw.update(params=ref_params)
    eng = serving.ServingEngine(model=build(get_cfg(arch, reduced=True)),
                                scheduler=scheduler, **kw)
    if serving is ref_serving and "ssm" in eng._cache:
        eng._cache["ssm"]["conv"] = eng._cache["ssm"]["conv"].astype(
            jnp.float32)
    return eng


def counters(eng) -> dict:
    return {name: getattr(eng.metrics, name) for name in COUNTERS}


def request_record(reqs) -> list:
    """Per request: id, state, finish reason and stream."""
    return [(r.request_id, r.state.name, r.finish_reason,
             list(r.output_tokens)) for r in reqs]
