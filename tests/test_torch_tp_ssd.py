"""The SSD layouts under ``model`` that the reference's specs give and no
earlier case meets: a concatenated leaf (``in_proj`` = z|x|B|C|dt, the
conv's x|B|C) that divides the axis as a whole while a part does not is
held as the reference's contiguous block, and the heads may split while
``in_proj`` stays whole (``models/ssm.py``'s ``Split``).

``tests/test_torch_tp.py``'s harness: the reference's jitted steps (its
params under ``param_shardings``) in JAX subprocesses on 8 forced host
devices, the port in gloo rank processes (a world of 4, then of 3 and of
2), each rank holding its blocks. float32 REDUCED configs whose widths
make each combination arise:

* A, the heads split over a whole ``in_proj`` (hymba-1.5b on 5 and 10):
  hymba with ``ssm_state`` 5 on (1, 4): ``in_proj`` 274 and conv 138
  columns whole, 8 heads split;
* B, the conv cut across its parts (mamba2-370m on 3, 6, 9 and 12):
  mamba2 with ``ssm_state`` 8 on (1, 3): ``in_proj`` 280 whole, conv 144
  = 128 + 8 + 8 in contiguous blocks of 48, 8 heads whole;
* C, ``in_proj`` cut across its parts (hymba-1.5b on 7 and 14): hymba
  with ``ssm_state`` 5 and ``ssm_head_dim`` 64 on (1, 4): ``in_proj`` 268
  in contiguous blocks of 67, conv 138 whole, 2 heads whole;
* A, B and C at once: mamba2 with ``ssm_state`` 5 on (1, 2): ``in_proj``
  274 and conv 138 contiguous, 8 heads split.

Each holds the seeded blocks (``local_block`` of the unsharded model of
the same seed), the prefill's logits within 1e-5 and its decode state
``h`` and conv window as the rank's ``cache_spec`` block of the
reference's, 4 greedy decode steps (``Engine.generate``'s tokens equal,
every step's logits within 1e-5) and two train steps under
``tests/test_torch_tp.py``'s rules. With no ranks,
``test_every_model_axis_places_the_published_ssd_layers`` holds
mamba2-370m and hymba-1.5b at published widths on every model axis 2-16
and 32 to the reference's specs.

Only the train cases tell the backward rules apart. On a copy of the
port: without the ``copy_over`` of z, the conv's output and dt where the
heads split over a whole output (``_own_heads``), cases A and ABC fail;
without the ``copy_over`` of a contiguous ``in_proj``'s input, or with
its output's gather summed (``gather_axis`` for ``gather_own``), C and
ABC fail; without the ``copy_over`` of a contiguous conv's input
(``_mine``), B and ABC fail.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_torch_tp as tp  # noqa: E402
from test_torch_tp import base  # noqa: E402
from test_torch_tp_hd import _derived  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.distributed.compat import abstract_mesh  # noqa: E402
from test_torch_sharding import _ref_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.context import mesh_context  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.models.ssm import BLOCK, PART, SSM  # noqa: E402

SEQ, NEW, STEPS = tp.S, tp.NEW, tp.STEPS
WORLD = 4   # rank processes: a world of 4, then of 3 and of 2
A = {"ssm_state": 5}
B = {"ssm_state": 8}
C = {"ssm_state": 5, "ssm_head_dim": 64}
# name: (kind, world, mesh shape (data, model), arch, config changes, B)
# (a decode case's prefill logits are held as a forward's)
CASES = {
    "dec/A-hymba-1x4": ("decode", 4, (1, 4), "hymba-1.5b", A, 2),
    "train/A-hymba-1x4": ("train", 4, (1, 4), "hymba-1.5b", A, 2),
    "dec/C-hymba-1x4": ("decode", 4, (1, 4), "hymba-1.5b", C, 2),
    "train/C-hymba-1x4": ("train", 4, (1, 4), "hymba-1.5b", C, 2),
    "dec/B-mamba2-1x3": ("decode", 3, (1, 3), "mamba2-370m", B, 2),
    "train/B-mamba2-1x3": ("train", 3, (1, 3), "mamba2-370m", B, 2),
    "dec/ABC-mamba2-1x2": ("decode", 2, (1, 2), "mamba2-370m", A, 2),
    "train/ABC-mamba2-1x2": ("train", 2, (1, 2), "mamba2-370m", A, 2),
}
# each case's Split: (in_proj's output, the conv's channels, heads split)
SPLITS = {"A": (None, None, True), "B": (None, BLOCK, False),
          "C": (BLOCK, None, False), "ABC": (BLOCK, BLOCK, True)}
# the configs seeded on every mesh of the port's worlds
SEEDED = {"A-hymba": ("hymba-1.5b", A), "C-hymba": ("hymba-1.5b", C),
          "B-mamba2": ("mamba2-370m", B)}


def _combination(name):
    return name.split("/")[1].split("-")[0]


# the reference's and the port's scripts of tests/test_torch_tp.py: the
# prefill's logits and SSD cache kept; the port's worlds of 4, 3 and 2,
# each case's Split recorded, the seeded configs with their changes, and
# neither the vocab-parallel loss nor the checkpoint run
_REFERENCE = _derived(tp._REFERENCE, [
    ("p, bt, cfg, max_len=S + new))(params, batch)",
     "p, bt, cfg, max_len=S + new))(params, batch)\n"
     '            res[f"{name}/logits"] = np.asarray(logits)\n'
     '            for key in ("h", "conv"):\n'
     '                res[f"{name}/cache/{key}"] = np.asarray(cache[key])')])
_PORT = _derived(tp._PORT, [
    ("torch.set_num_threads(1)\n",
     "torch.set_num_threads(1)\n"
     "from repro_torch.models.ssm import SSM\n"
     "def split_facts(model):\n"
     "    sp = next(m for m in model.modules()\n"
     "              if isinstance(m, SSM)).split_of()\n"
     "    return [str(sp.proj), str(sp.conv), str(sp.heads)]\n"),
    ('"cpu", mesh=mesh)\n',
     '"cpu", mesh=mesh)\n'
     '        res[f"{name}/split"] = np.array(split_facts(model))\n'),
    ("_, cache = prefill(model, batch, cfg, max_len=S + new)",
     "logits, cache = prefill(model, batch, cfg, max_len=S + new)\n"
     '                    res[f"{name}/logits"] = gather_vocab(\n'
     "                        model, logits).numpy()\n"
     '                    for key in ("h", "conv"):\n'
     '                        res[f"{name}/cache/{key}"] = '
     "cache[key].numpy().copy()"),
    ("for world in (4, 2):", "for world in (4, 3, 2):"),
    ("        for arch in seeded:\n"
     "            cfg = get_config(arch, reduced=True)",
     "        for key, (arch, changes) in seeded.items():\n"
     "            cfg = dataclasses.replace(get_config(arch, reduced=True),\n"
     "                                      **changes)"),
    ('res[f"seeded/{arch}/{shape}"]', 'res[f"seeded/{key}/{shape}"]')])
_PORT = _PORT[:_PORT.index("    if world == 2:   # (e)")] \
    + _PORT[_PORT.index("    compat.shutdown()"):]


def _inputs():
    x = {}
    for name, (kind, _, _, arch, changes, b) in CASES.items():
        cfg = tp._cfg(ref_get_config, arch, changes)
        x.update(tp._flatten(base._weights(cfg, seed=len(name)),
                             f"weights/{name}/"))
        for i in range(STEPS if kind == "train" else 1):
            batch = base._batch(cfg, b=b, s=SEQ, seed=10 * i + len(name))
            if kind != "train":
                del batch["labels"]
            x.update(tp._flatten(batch, f"batch/{name}/{i}/"))
    return x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides: {"x", "ref", "port": [rank 0..3], "out"}. The
    reference's decode and train cases run in two JAX subprocesses side
    by side."""
    out = tmp_path_factory.mktemp("tp_ssd")
    x = _inputs()
    env = dict(os.environ, PYTHONPATH=os.path.join(tp.ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    np.savez(out / "inputs.npz", **x)
    (out / "reference.py").write_text(_REFERENCE)
    (out / "port.py").write_text(_PORT)
    refs = []
    for kind in ("train", "decode"):
        d = out / kind
        d.mkdir()
        (d / "inputs.npz").symlink_to(out / "inputs.npz")
        cases = {k: v for k, v in CASES.items() if v[0] == kind}
        refs.append((d, subprocess.Popen(
            [sys.executable, str(out / "reference.py"), repr(cases),
             repr(tp.OCFG), str(STEPS), str(NEW), str(d), str(SEQ), "{}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    want = {}
    for d, p in refs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
        want.update(np.load(d / "reference.npz"))
    x.update({f"ref/{k}": v for k, v in want.items()
              if k.endswith("/tokens")})
    np.savez(out / "inputs.npz", **x)
    procs = [subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(r), str(out),
         repr(CASES), repr(tp.OCFG), str(STEPS), str(NEW), repr(SEEDED),
         str(SEQ), "{}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return {"x": x, "ref": want, "out": out,
            "port": [dict(np.load(out / f"port{r}.npz"))
                     for r in range(WORLD)]}


def _ranks(runs, name):
    return runs["port"][:CASES[name][1]]


@pytest.mark.parametrize("name", list(CASES))
def test_each_case_takes_its_combination(runs, name):
    want = [str(f) for f in SPLITS[_combination(name)]]
    for port in _ranks(runs, name):
        assert list(port[f"{name}/split"]) == want


@pytest.mark.parametrize("key", list(SEEDED))
@pytest.mark.parametrize("shape", [(1, 4), (1, 3), (1, 2)])
def test_a_seeded_model_holds_the_unsharded_blocks(runs, key, shape):
    for port in runs["port"][:math.prod(shape)]:
        ok, n_blocks, n = port[f"seeded/{key}/{shape}"]
        assert ok and n_blocks > 0, (key, shape, n_blocks, n)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("dec/")])
def test_prefill_matches_the_reference(runs, name):
    """The prefill's logits within 1e-5, and its SSD cache the rank's
    ``cache_spec`` block of the reference's: ``h`` by heads where they
    split, the conv window by contiguous channels where the conv is
    split, else whole."""
    _, _, shape, arch, changes, b = CASES[name]
    ref = runs["ref"]
    specs = ref_shd.cache_spec(tp._cfg(ref_get_config, arch, changes), b,
                               abstract_mesh(shape, ("data", "model")))
    for r, port in enumerate(_ranks(runs, name)):
        np.testing.assert_allclose(port[f"{name}/logits"],
                                   ref[f"{name}/logits"], **tp.LOGITS_TOL,
                                   err_msg=f"rank {r}")
        for key in ("h", "conv"):
            want = _block(ref[f"{name}/cache/{key}"], tuple(specs[key]),
                          shape[1], r)
            np.testing.assert_allclose(port[f"{name}/cache/{key}"], want,
                                       **tp.LOGITS_TOL,
                                       err_msg=f"rank {r} {key}")


def _block(whole, spec, m, index):
    """Block ``index`` of a whole array under a reference spec over
    ``model`` of ``m`` (contiguous, as jax places a ``NamedSharding``)."""
    for dim, entry in enumerate(spec):
        if entry == "model":
            n = whole.shape[dim] // m
            whole = np.take(whole, range(index * n, (index + 1) * n), dim)
    return whole


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("dec/")])
def test_greedy_decode_matches_the_reference(runs, name):
    """Equal greedy tokens from ``Engine.generate``; every decode step's
    logits (fed the reference's tokens) within 1e-5."""
    ref = runs["ref"]
    for r, port in enumerate(_ranks(runs, name)):
        np.testing.assert_array_equal(port[f"{name}/tokens"],
                                      ref[f"{name}/tokens"],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(port[f"{name}/step_logits"],
                                   ref[f"{name}/step_logits"],
                                   **tp.LOGITS_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("train/")])
def test_train_step_matches_the_reference(runs, name, i):
    """Each rank's loss and grad norm, and the parameters and moments
    gathered whole on rank 0, are the reference's after step i, under
    ``tests/test_torch_tp.py``'s rules."""
    tp.check_train_step(runs, CASES, name, i)


# ------------------------------------------------ published widths, no ranks

AXES = list(range(2, 17)) + [32]
# the combinations that published widths meet: (arch, model axis):
# (in_proj's output, the conv's channels, heads split)
PUBLISHED = {
    **{("hymba-1.5b", m): (None, None, True) for m in (5, 10)},
    **{("mamba2-370m", m): (None, BLOCK, False) for m in (3, 6, 9, 12)},
    ("hymba-1.5b", 32): (None, BLOCK, False),
    **{("hymba-1.5b", m): (BLOCK, None, False) for m in (7, 14)},
    **{("mamba2-370m", m): (PART, PART, True) for m in (2, 4, 8, 16, 32)},
    ("hymba-1.5b", 2): (PART, PART, True),
    ("hymba-1.5b", 4): (None, PART, False),
}
SSD_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "ssm_norm", "out_proj")


class _RankMesh:
    """A (1, m) mesh's axes with the coordinates of rank ``index``."""

    def __init__(self, m, index):
        self.axis_names, self.shape = ("data", "model"), {"data": 1,
                                                          "model": m}
        self.index = index

    def axis_index(self, axis):
        return self.index if axis == "model" else 0


@pytest.mark.parametrize("m", AXES)
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_every_model_axis_places_the_published_ssd_layers(arch, m):
    """mamba2-370m and hymba-1.5b at published widths on (1, m): the port
    places every SSD leaf (``placed_specs``) and every layer runs
    (``split_of``) with no refusal; each leaf's spec is the reference's
    and each rank's block of its columns the reference's contiguous block
    (a ``PartSpec`` leaf: the rank's block of each part, the same bytes);
    the layer's cuts follow the specs (the conv window's as the conv's
    weights are cut, ``h``'s as the heads) and the decode cache's blocks
    are ``cache_spec``'s."""
    cfg = get_config(arch)
    mesh = shd.MeshShape(("data", "model"), (1, m))
    ref_mesh = abstract_mesh((1, m), ("data", "model"))
    model = S.abstract_params(cfg, mesh)
    ssm = next(mod for mod in model.modules() if isinstance(mod, SSM))
    sp = ssm.split_of()
    want = _ref_specs(arch, ref_mesh, ref_shd.DistConfig())
    for leaf in SSD_LEAVES:
        spec = ssm.specs.get(leaf, (None,) * getattr(ssm, leaf).dim())
        assert (None,) + tuple(spec) == want[f"blocks.ssm.{leaf}"], leaf
        whole = shd.whole_shape(getattr(ssm, leaf).shape, spec, mesh)
        cols, n = torch.arange(whole[-1]), shd.group_size(mesh, spec[-1])
        blocks = [shd.local_block(cols, spec[-1:], _RankMesh(m, r))
                  for r in range(m)]
        if isinstance(spec, shd.PartSpec):
            assert torch.equal(torch.cat(blocks).sort().values, cols), leaf
            continue
        size = whole[-1] // n
        for r, got in enumerate(blocks):   # a whole leaf: n == 1
            i = r % n
            assert torch.equal(got, cols[i * size:(i + 1) * size]), (leaf, r)
    cut = {name: None if name not in ssm.specs else
           PART if isinstance(ssm.specs[name], shd.PartSpec) else BLOCK
           for name in ("in_proj", "conv_w")}
    cache_specs = ref_shd.cache_spec(get_config(arch), 8, ref_mesh)
    facts = (sp.proj, sp.conv, sp.heads, sp.rows) if sp else \
        (None, None, False, False)   # nothing split over model
    assert facts == (cut["in_proj"], cut["conv_w"],
                     cache_specs["h"][2] == "model",
                     want["blocks.ssm.ssm_norm"][1] == "model")
    assert (cache_specs["conv"][3] == "model") == (facts[1] is not None)
    if (arch, m) in PUBLISHED:
        assert facts[:3] == PUBLISHED[(arch, m)]
    with mesh_context(mesh):
        cache = init_cache(cfg, 8, 64, device=S.META)
    whole = {"h": (8, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
             "conv": (8, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)}
    for key, shape in whole.items():
        assert tuple(cache[key].shape) == shd.block_shape(
            (cfg.n_layers,) + shape, tuple(cache_specs[key]), mesh), key
