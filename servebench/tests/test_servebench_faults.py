"""A run with its timed path broken underneath comes out not correct, for
each fault a served cell can have: a decode step that leaves the KV state
unchanged, half of the lanes left out, a token altered where it is
produced.  On the CPU at a small size, the harness's look for a card
skipped (one card, so no exchange between chips to leave out)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CELLS = ["qwen2-1.5b.mix-poisson", "olmoe-1b-7b.mix-backlog"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU runs beside other test workers: one thread each."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_unchanged(monkeypatch):
    # neither the prefill nor the decode step writes the KV pool
    import repro_torch.models.transformer as tf
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(tf, "_write_step_kv", lambda *a, **k: None)
    monkeypatch.setattr(ServingEngine, "_scatter", lambda *a, **k: None)


def _half_lanes(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    real = ServingEngine._fused_steps

    def half(self, lanes, tables, temps, **kw):
        lanes = lanes.copy()
        lanes[2, 1::2] = 0                     # odd lanes get no budget
        return real(self, lanes, tables, temps, **kw)
    monkeypatch.setattr(ServingEngine, "_fused_steps", half)


def _token_altered(monkeypatch):
    import repro_torch.serving.engine as eng
    real = eng.categorical

    def altered(logits, *a, **k):
        v, i = real(logits, *a, **k)
        return v, torch.remainder(i + 1, logits.shape[-1])
    monkeypatch.setattr(eng, "categorical", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_lanes": _half_lanes,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    from servebench import run as R
    from servebench.smallrun import SEED, small_cell
    cfg, mix, mc = small_cell(workload)
    FAULTS[fault](monkeypatch)
    try:
        result, _ = R.execute(workload, SEED, 2.0, False, device="cpu",
                              cfg_file=cfg, mix=mix, model_config=mc)
    except SystemExit as exc:
        # the harness refused to go on (a prelude that never fills the
        # batch): no result, which the driver counts as not correct
        assert "servebench:" in str(exc)
        return
    assert not result["correct"], result["checks"]
