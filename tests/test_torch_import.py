"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and every module imports with JAX
blocked (and without building or loading any CUDA kernel)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'repro', 'triton'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.kernels.gittins.kernel import GITTINS_KERNEL\n"
        "from repro_torch.kernels.decode_attention.kernel import "
        "PAGED_DECODE_KERNEL\n"
        "from repro_torch.kernels.flash_attention.kernel import "
        "FLASH_PREFILL_KERNEL\n"
        "for k in (GITTINS_KERNEL, PAGED_DECODE_KERNEL, FLASH_PREFILL_KERNEL):\n"
        "    assert k._lib is None, k.symbol\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_module_names_mirror_the_reference():
    """``repro_torch.X`` is the counterpart of ``repro.X``: every ported
    module has a twin of the same name (kernels.build, models.bridge and
    the CUDA bindings are the port's own additions)."""
    own = {"repro_torch.kernels.build", "repro_torch.models.bridge",
           "repro_torch.launch"}
    ref = {p.relative_to(ROOT / "src").with_suffix("").as_posix()
           .replace("/", ".").removesuffix(".__init__")
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    for name in MODULES:
        if name in own:
            continue
        assert name.replace("repro_torch", "repro", 1) in ref, name


def test_smoke_script_fails_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where
    there is no card, and where it stands alone without the package."""
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
