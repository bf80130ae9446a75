"""repro_torch stands alone: importing every module of the port pulls in
neither jax nor any module of the JAX package ``repro``, and neither the
port's sources, ``chip_smoke.py`` nor the port's example
(``examples/cnn_classification_torch.py``) import them."""
import os
import re
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
EXAMPLE = SRC.parent / "examples" / "cnn_classification_torch.py"

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
    for path in [*(SRC / "repro_torch").rglob("*.py"), SRC.parent / "chip_smoke.py", EXAMPLE]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, (path, line)
                assert not stripped.startswith(("import repro ", "from repro ",
                                                "from repro.", "import repro.")), (path, line)


def test_example_imports_neither_jax_nor_repro():
    probe = (f"import runpy, sys; runpy.run_path({str(EXAMPLE)!r}, run_name='probe'); "
             "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
             "'jaxlib')) or m == 'repro' or m.startswith('repro.')); print(bad); "
             "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


MULTI_DEVICE = ("repro_torch.parallel.meshes", "repro_torch.parallel.sharding",
                "repro_torch.parallel.planner", "repro_torch.parallel.actshard",
                "repro_torch.parallel.collectives", "repro_torch.parallel.smoke",
                "repro_torch.launch.mesh")


@pytest.mark.parametrize("module", MULTI_DEVICE)
def test_multi_device_modules_are_scanned(module):
    """The multi-device modules are among those the probe above imports,
    and none of their import lines names jax or the JAX package."""
    import pkgutil

    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert module in names
    path = SRC / (module.replace(".", "/") + ".py")
    for line in path.read_text().splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped and not re.match(r"(from|import) repro(\.|\s)",
                                                          stripped), line
