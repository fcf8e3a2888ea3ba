"""The check that decides ``correct``, on the CPU at a small size: a sound
run passes, and the control (the reference in the precision below the
configuration's) reads higher than the program."""

import sys
from pathlib import Path

import numpy as np
import pytest

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


def _run(workload, seconds=2.0):
    from servebench import run as R
    from servebench.smallrun import SEED, small_cell
    cfg, mix, mc = small_cell(workload)
    return R.execute(workload, SEED, seconds, False, device="cpu",
                     cfg_file=cfg, mix=mix, model_config=mc)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, info = _run(workload)
    assert result["correct"], result["checks"]
    assert info["values"]["sampled_tokens"] > 0
    assert list(result["checks"])[-1] == "skipped_decodes"
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_the_program(workload):
    from servebench import check, harness
    from servebench.smallrun import SEED, small_cell
    cfg, mix, mc = small_cell(workload)
    # a small run serves a few dozen tokens; at T 0.6 the Gumbel noise
    # outweighs the control's error on nearly all of them, at T 0.1 the
    # logits weigh six times more and the control flips some picks
    mix["temperature"] = 0.1
    run = harness.run_cell(cfg, mix, SEED, 2.0, device="cpu",
                           model_config=mc)
    prio = run.program_priorities()
    seed = run.engine.seed
    run.release_program()
    rids = check.sample(run, np.random.default_rng(1))
    rw = harness.reference_weights(run.params, run.arch)
    prog = check.readings(run, prio, rids, run.arch, rw, seed)
    ctl = check.readings(run, prio, rids, run.arch, rw, seed, control=True)
    assert ctl["gap_sampled"] > prog["gap_sampled"]
    if prio["priority"].size:
        assert ctl["gittins_rel"] > 10 * prog["gittins_rel"]
