"""DSANN on PyTorch and CUDA: the port of the ``repro`` package.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``repro/core/search.py`` <-> ``repro_torch/core/search.py``)
and imports neither JAX nor anything of ``repro``. Public entry points
(``build_pag``, ``write_partitions``, ``search_pag``, ``ShardedServing``,
``AnnsFrontend``, ``make_dataset``) run on the CUDA card unless the caller
passes ``device="cpu"``; the scan kernels are hand-written CUDA
(``kernels/csrc``) built with ``nvcc`` at first use.
"""
from repro_torch.device import resolve_device  # noqa: F401  (sets TF32 off)
