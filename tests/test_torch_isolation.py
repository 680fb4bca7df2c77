"""The port stands alone: importing ``repro_torch`` and every module in it
loads neither JAX nor any module of the reference package ``repro``, and
no source line of the port, of ``chip_smoke.py`` or of the scripts that
run its paths imports them."""
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
print(" ".join(k for k in sys.modules if k.startswith("repro_torch")))
sys.exit(f"loaded: {bad}" if bad else 0)
"""

# the LM serving path's modules, among those the walk must reach
LM_MODULES = {"repro_torch.configs.base", "repro_torch.configs.tinyllama_1_1b",
              "repro_torch.models", "repro_torch.models.attention",
              "repro_torch.models.layers", "repro_torch.models.model",
              "repro_torch.kernels.flash_attention",
              "repro_torch.serving.engine", "repro_torch.data.lm",
              "repro_torch.carry"}
# the ssm and hybrid families' serving modules
SSM_HYBRID_MODULES = {"repro_torch.configs.mamba2_370m",
                      "repro_torch.configs.hymba_1_5b",
                      "repro_torch.models.ssm", "repro_torch.models.model",
                      "repro_torch.models.attention",
                      "repro_torch.kernels.flash_attention",
                      "repro_torch.kernels.ops", "repro_torch.carry",
                      "repro_torch.serving.engine"}
# the audio and vlm families' serving modules
AUDIO_VLM_MODULES = {"repro_torch.configs.whisper_small",
                     "repro_torch.configs.internvl2_76b",
                     "repro_torch.models.layers", "repro_torch.models.model",
                     "repro_torch.data.lm", "repro_torch.serving.engine"}
# the training path's modules
TRAIN_MODULES = {"repro_torch.training", "repro_torch.training.optimizer",
                 "repro_torch.training.train_step",
                 "repro_torch.training.compression", "repro_torch.launch",
                 "repro_torch.launch.train", "repro_torch.checkpoint.ckpt",
                 "repro_torch.kernels.flash_attention", "repro_torch.carry"}

# the pod-scale data plane's modules
POD_MODULES = {"repro_torch.distributed", "repro_torch.distributed.compat",
               "repro_torch.launch.mesh", "repro_torch.core.distributed"}
# expert parallelism: the sharding rules, the mesh context, the MoE layer
EP_MODULES = {"repro_torch.distributed.sharding",
              "repro_torch.distributed.context", "repro_torch.models.moe",
              "repro_torch.carry"}
# the dry-run census: the shapes, the abstract inputs and specs, the census
CENSUS_MODULES = {"repro_torch.configs.base", "repro_torch.launch.specs",
                  "repro_torch.launch.dryrun"}
# the placement of every weight and of the decode cache by the specs: the
# blocks and their collectives, the tensor-parallel layers, the
# vocab-parallel greedy and loss, the optimizer over blocks, whole
# checkpoints of a mesh
TP_MODULES = {"repro_torch.distributed.sharding",
              "repro_torch.distributed.context",
              "repro_torch.core.distributed",
              "repro_torch.models.layers", "repro_torch.models.model",
              "repro_torch.models.attention", "repro_torch.models.moe",
              "repro_torch.serving.engine", "repro_torch.training.train_step",
              "repro_torch.training.optimizer", "repro_torch.carry",
              "repro_torch.checkpoint.ckpt", "repro_torch.launch.train"}


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORTS_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 40   # every module was imported
    assert LM_MODULES <= loaded, LM_MODULES - loaded
    assert TRAIN_MODULES <= loaded, TRAIN_MODULES - loaded
    assert SSM_HYBRID_MODULES <= loaded, SSM_HYBRID_MODULES - loaded
    assert AUDIO_VLM_MODULES <= loaded, AUDIO_VLM_MODULES - loaded
    assert POD_MODULES <= loaded, POD_MODULES - loaded
    assert EP_MODULES <= loaded, EP_MODULES - loaded
    assert CENSUS_MODULES <= loaded, CENSUS_MODULES - loaded
    assert TP_MODULES <= loaded, TP_MODULES - loaded


FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)"
    r"(\.|\s))", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "scripts").glob("*.py")),
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
