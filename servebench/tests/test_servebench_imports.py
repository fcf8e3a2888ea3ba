"""What a run loads: never JAX nor the JAX package, and the reference
nothing of the program; and a run refuses to start without a card or
without the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN_RUN = {"jax", "jaxlib", "flax", "repro"}
FORBIDDEN_REF = FORBIDDEN_RUN | {"repro_torch"}

_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from servebench import run as R
from servebench.smallrun import SEED, small_cell
w = "qwen2-1.5b.mix-poisson"
cfg, mix, mc = small_cell(w)
R.execute(w, SEED, 1.0, False, device="cpu", cfg_file=cfg, mix=mix,
          model_config=mc)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = """
import json, sys
sys.path[:0] = [{root!r}]
import servebench.reference, servebench.check, servebench.counts
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    mods = _top_level(_RUN.format(root=str(ROOT), src=str(ROOT / "src")))
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN_RUN, mods & FORBIDDEN_RUN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(_REF.format(root=str(ROOT)))
    assert not mods & FORBIDDEN_REF, mods & FORBIDDEN_REF


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would start")


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "servebench/run.py", "--workload",
         "qwen2-1.5b.mix-poisson", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        env=_env(), timeout=300)


def test_no_card_no_result(no_card):
    out = _cli(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "servebench", tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
