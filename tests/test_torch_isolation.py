"""The port stands alone: importing ``repro_torch`` and every module in it
loads neither JAX nor any module of the reference package ``repro``, and
no source line of the port or of ``chip_smoke.py`` imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORTS_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len([k for k in sys.modules if k.startswith("repro_torch")]))
sys.exit(f"loaded: {bad}" if bad else 0)
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORTS_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30   # every module was imported


FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)"
    r"(\.|\s))", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_the_reference(path):
    assert not FORBIDDEN.findall(path.read_text())


def test_the_static_scan_catches_what_it_must():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "    from repro.kernels import ops", "import jaxlib"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import pag",
                 "# import jax in a comment"):
        assert not FORBIDDEN.search(line), line
