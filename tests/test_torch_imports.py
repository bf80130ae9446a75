"""repro_torch stands alone: importing every module of the port pulls in
neither jax nor any module of the JAX package ``repro``, and neither the
port's sources nor ``chip_smoke.py`` import them."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count = int(res.stdout.split()[0])
    assert count >= 20, res.stdout  # every module of the package was imported


def test_port_sources_do_not_name_jax():
    for path in [*(SRC / "repro_torch").rglob("*.py"), SRC.parent / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, (path, line)
                assert not stripped.startswith(("import repro ", "from repro ",
                                                "from repro.", "import repro.")), (path, line)
