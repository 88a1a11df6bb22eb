"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, and the entry points never fall
back to the CPU on their own."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "path, pre = repro_torch.__path__, 'repro_torch.'\n"
        "for m in pkgutil.walk_packages(path, pre):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'repro'\n"
        "       or m.startswith('repro.')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core import fit, fit_k2means, gdi_device_init
    from repro_torch.data import gmm_blobs
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(x, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        gdi_device_init(x, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_k2means(x, x[:4], np.zeros(64, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        gmm_blobs(64, 4, 2)
