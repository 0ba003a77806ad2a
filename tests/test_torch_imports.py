"""The port, its example drivers (``examples/*_torch.py``) and chip_smoke.py
import neither JAX nor the reference package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_found():
    names = {p.name for p in PORT_FILES}
    assert {"bridge.py", "ops.py", "serve.py", "chip_smoke.py", "quickstart_torch.py",
            "lsm_serving_torch.py", "checkpoint_dr_torch.py", "train_100m_torch.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.launch.serve, repro_torch.bridge, "
            "repro_torch.launch.steps, repro_torch.optim.adamw, repro_torch.launch.train, "
            "repro_torch.runtime, repro_torch.checkpoint, repro_torch.data, repro_torch.core, "
            "repro_torch.store.staging, repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, repro_torch.analysis, "
            "repro_torch.analysis.cost, repro_torch.analysis.roofline; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_importing_the_case_studies_loads_no_jax_or_reference():
    """The I/O server imports the re-miner only under ``--remine`` and the
    plugins import the miner's driver lazily: importing those modules (and
    the lazy targets) pulls in neither JAX nor the reference package."""
    code = ("import sys, repro_torch.launch.ioserver, repro_torch.analysis.remine, "
            "repro_torch.store.plugins, repro_torch.analysis.mine; "
            "repro_torch.store.plugins.mine_reference_graphs(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
