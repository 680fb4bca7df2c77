"""The dry-run census (``repro_torch.launch.dryrun`` and
``launch/specs.py``) against the reference's dry-run on the same shapes.

* The shape registry, the skip rule, and the abstract parameters,
  optimizer state, inputs and caches of every architecture at full width
  (the port's per-layer leaves matched to the reference's ``[L, ...]``
  stacks through ``sharding.reference_path``), with their specs on the
  16x16 and 2x16x16 meshes under each ``DistConfig`` variant.
* ``argument_size_in_bytes`` against XLA's compiled
  ``memory_analysis()`` of the reference's own ``lower_cell`` and
  ``lower_anns_cell`` on REDUCED cells, on a (2, 4) mesh of 8 forced host
  devices (one JAX subprocess); the output size plus XLA's 8 bytes a leaf
  of the output tuple against its ``output_size_in_bytes``.
* ``cost.flops`` against ``torch.utils.flop_counter.FlopCounterMode``
  over the port's own step on REDUCED CPU tensors, exactly (the plain
  attention computes every pair, so the count there is the census's with
  ``attention_flops_materialised`` for ``attention_flops``); and against
  ``launch/hlo_costs.analyze`` of the same cells compiled on one device:
  its dot FLOPs are the census's materialised count exactly, and what
  ``analyze`` adds for elementwise ops (one an element, converts first)
  is pinned cell by cell, as is the masked attention the kernel skips.
* ``collectives`` against the bytes recorded through
  ``core/distributed.py``'s ``_gather``, ``_sum_axis`` and
  ``_reduce_scatter`` in gloo CPU worlds of 5, 4, 3 and 2 ranks: the pod
  serve and assign steps, TinyLlama's and DBRX's REDUCED train steps,
  DBRX's prefill and decode, with expert parallelism, FSDP and
  microbatches; mamba2's train step (its SSD heads split), hymba's decode
  and whisper's prefill (its encoder and cross-attention); hymba's train
  step with its SSD heads split over a whole ``in_proj`` on (1, 5) and
  mamba2's with its conv cut across its parts on (1, 3), whose argument
  bytes are also held to XLA's on those meshes; and under
  ``DistConfig(shard_head_dim_fallback=True)`` qwen's and TinyLlama's
  train steps, hymba's decode and qwen's decode of one on (2, 2), each
  with ``FlopCounterMode`` over the step, its count the census's
  ``cost.flops`` (with the materialised attention).
* ``tests/test_dryrun_artifacts.py``'s three checks on records the
  census computes here (not read from disk), and the grid's time; the
  grid under the head-dim placement (``--shard-hd-fallback``) too.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as R  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import specs as ref_S  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    decode_step,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.training.optimizer import init_state  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig,
    make_train_step,
)
from test_torch_sharding import DISTS, MESHES, _dists, _meshes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = [a.replace("_", "-") for a in configs.ARCH_IDS]
ONE = shd.MeshShape(("data", "model"), (1, 1))
MESH_2x4 = shd.MeshShape(("data", "model"), (2, 4))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ref_opt(arch):
    return ref_opt.OptimizerConfig(
        **dataclasses.asdict(D.arch_opt_config(arch)))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_S.abstract_params(ref_configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return ref_S.abstract_opt_state(ref_configs.get_config(arch),
                                    _ref_opt(arch))


def _ref_leaves(tree):
    """{dotted reference path: leaf} (a spec tree's PartitionSpecs are
    leaves)."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {".".join(ref_shd._path_names(path)): leaf for path, leaf in flat}


def _port_opt_leaves(tree, across=frozenset()):
    """{(dotted reference path, whether the reference stacks it): leaf} of
    the port's optimizer state, or of its specs. ``across``: the vectors
    factored across the layers, whose column the reference does not
    stack (none at full width: no stack holds 128 layers)."""
    out = {("step", False): tree["step"]}
    for what in ("m", "v"):
        for name, leaf in tree[what].items():
            path, stacked = shd.reference_path(name)
            key = ".".join((what,) + path)
            if isinstance(leaf, dict):
                for sub in ("row", "col"):
                    out[(f"{key}.{sub}", stacked and not (
                        name in across and sub == "col"))] = leaf[sub]
            else:
                out[(key, stacked)] = leaf
    return out


def _across(state):
    return frozenset(n for n, v in state["v"].items()
                     if isinstance(v, dict) and v["row"].dim() == 0)


# --------------------------------------------- registry and abstract trees

@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_skip_rule_match_the_reference(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_configs.SHAPES.items()}
    for name in SHAPES:
        got = configs.cell_is_applicable(get_config(arch), SHAPES[name])
        want = ref_configs.cell_is_applicable(ref_configs.get_config(arch),
                                              ref_configs.SHAPES[name])
        assert got == want, name
    assert isinstance(SHAPES["long_500k"], ShapeConfig)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_opt_state_match_the_reference(arch):
    """Every leaf at full width: the reference's shape (its ``[L, ...]``
    stack of the port's per-layer tensors) and dtype, on the meta
    device; the optimizer state under the arch's ``arch_opt_config``."""
    cfg = get_config(arch)
    model = S.abstract_params(cfg)
    want = _ref_leaves(_ref_params(arch))
    seen = set()
    for name, p in model.named_parameters():
        path, stacked = shd.reference_path(name)
        ref = want[".".join(path)]
        assert p.device.type == "meta", name
        shape = (ref.shape[0],) + tuple(p.shape) if stacked \
            else tuple(p.shape)
        assert shape == tuple(ref.shape) and _dtype(p) == str(ref.dtype), \
            name
        seen.add(".".join(path))
    assert seen == set(want)
    state = S.abstract_opt_state(cfg, D.arch_opt_config(arch), model)
    want = _ref_leaves(_ref_state(arch))
    seen = set()
    for (key, stacked), t in _port_opt_leaves(state, _across(state)).items():
        ref = want[key]
        assert t.device.type == "meta", key
        shape = (ref.shape[0],) + tuple(t.shape) if stacked \
            else tuple(t.shape)
        assert shape == tuple(ref.shape) and _dtype(t) == str(ref.dtype), key
        seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_caches_match_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    for name, shape in SHAPES.items():
        if not configs.cell_is_applicable(cfg, shape)[0]:
            continue
        ref_shape = ref_configs.SHAPES[name]
        if shape.kind == "decode":
            tokens, cache, cur_pos = S.decode_inputs(cfg, shape)
            rt, rc, rp = ref_S.decode_inputs(ref_cfg, ref_shape)
            got = {"tokens": tokens, "cur_pos": cur_pos, **cache}
            want = {"tokens": rt, "cur_pos": rp, **rc}
        else:
            fn = S.train_inputs if shape.kind == "train" \
                else S.prefill_inputs
            got = fn(cfg, shape)
            want = getattr(ref_S, fn.__name__)(ref_cfg, ref_shape)
            if shape.kind == "prefill":   # and the cache a prefill makes
                got.update(init_cache(cfg, shape.global_batch,
                                      shape.seq_len, device=S.META))
                want.update(jax.eval_shape(lambda: R.init_cache(
                    ref_cfg, ref_shape.global_batch, ref_shape.seq_len)))
        assert set(got) == set(want), name
        for key, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype(t)) == (
                tuple(want[key].shape), str(want[key].dtype)), (name, key)


@pytest.mark.parametrize("d", sorted(DISTS))
@pytest.mark.parametrize("m", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, m, d):
    """The optimizer state's, every batch's and every cache's specs; the
    reference's spec of a stacked leaf is the port's with the layer's
    ``None`` in front."""
    ref_mesh, mesh = _meshes(m)
    ref_dist, dist = _dists(d)
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    want = {k: tuple(v) for k, v in _ref_leaves(ref_shd.param_specs(
        _ref_state(arch), ref_mesh, ref_dist)).items()}
    ocfg = D.arch_opt_config(arch)
    state = S.abstract_opt_state(cfg, ocfg)
    got = _port_opt_leaves(S.opt_shardings(cfg, ocfg, mesh, dist, state),
                           _across(state))
    assert {k for k, _ in got} == set(want)
    for (key, stacked), spec in got.items():
        assert ((None,) + spec if stacked else spec) == want[key], key
    for name, shape in SHAPES.items():
        if not configs.cell_is_applicable(cfg, shape)[0]:
            continue
        ref_shape = ref_configs.SHAPES[name]
        b = shape.global_batch
        if shape.kind == "decode":
            tokens, cache, _ = S.decode_inputs(cfg, shape)
            rt, rc, _ = ref_S.decode_inputs(ref_cfg, ref_shape)
            batch, ref_batch = {"tokens": tokens}, {"tokens": rt}
        else:
            batch = S.train_inputs(cfg, shape)
            ref_batch = ref_S.train_inputs(ref_cfg, ref_shape)
            cache = init_cache(cfg, b, shape.seq_len, device=S.META)
            rc = jax.eval_shape(lambda: R.init_cache(ref_cfg, b,
                                                     shape.seq_len))
        ref_b = ref_S.batch_shardings(ref_batch, ref_mesh, ref_dist)
        assert S.batch_shardings(batch, mesh, dist) == {
            k: tuple(v.spec) for k, v in ref_b.items()}, name
        ref_c = ref_S.cache_shardings(ref_cfg, rc, b, ref_mesh, ref_dist)
        assert S.cache_shardings(cfg, cache, b, mesh, dist) == {
            k: tuple(v.spec) for k, v in ref_c.items()}, name


def test_the_port_places_expert_blocks_and_whole_dense_weights():
    """``abstract_params`` under a mesh holds each expert-parallel MoE
    layer's blocks and every other weight as its ``param_specs`` block
    (the dense, attention and embedding weights too; the norms and the
    router whole); the census's ``port_argument_bytes`` is that model,
    its state and the rank's batch block."""
    cfg = get_config("dbrx-132b")
    mesh = shd.MeshShape(("data", "model"), (16, 16))
    placed = dict(S.abstract_params(cfg, mesh).named_parameters())
    whole = S.abstract_params(cfg)
    specs = shd.param_specs(whole, mesh)
    whole = dict(whole.named_parameters())
    for name, p in placed.items():
        want = shd.block_shape(whole[name].shape, specs[name], mesh)
        assert tuple(p.shape) == want, name
        if ".moe.w_" in name:
            assert p.numel() * 256 == whole[name].numel(), name
        elif name.endswith("norm") or name.endswith("router"):
            assert p.shape == whole[name].shape, name
        else:
            assert p.numel() < whole[name].numel(), name
    rec = D.census_cell("dbrx-132b", "prefill_32k", False)
    tokens = 32 * 32768 * 4 // 16
    assert rec["port_argument_bytes"] == D.whole_bytes(placed.values()) \
        + tokens


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_port_places_what_the_reference_specs_place(grid, mesh, arch,
                                                        shape):
    """In every family the port holds on a rank what the reference's
    specs give it: parameters (a decode's, those it reads; the SSD's
    concatenated leaves per part, the same bytes), optimizer state, batch
    and decode cache, to the byte."""
    _places_what_the_specs_place(grid["recs"][(mesh, arch, shape)])


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_port_places_what_the_specs_place_head_dim_split(grid, mesh,
                                                             arch, shape):
    """The same under ``DistConfig(shard_head_dim_fallback=True)``: the
    attention weights' head-dim blocks and the cache's."""
    _places_what_the_specs_place(
        grid["head_dim_fallback"][(mesh, arch, shape)])


def _places_what_the_specs_place(rec):
    if rec["status"] != "OK":
        assert rec["status"].startswith("SKIP")
        return
    assert rec["port_argument_bytes"] \
        == rec["memory"]["argument_size_in_bytes"]


# ------------------------------------------- the reference, compiled

CELLS = {   # name: (arch, kind, batch, seq)
    "tinyllama/train": ("tinyllama-1.1b", "train", 8, 64),
    "tinyllama/prefill": ("tinyllama-1.1b", "prefill", 8, 64),
    "tinyllama/decode": ("tinyllama-1.1b", "decode", 8, 64),
    "dbrx/train": ("dbrx-132b", "train", 8, 64),
    "hymba/decode": ("hymba-1.5b", "decode", 8, 64),
    "whisper/prefill": ("whisper-small", "prefill", 8, 64),
}
# anns-sift-10m's widths (d, queries, k, cap, p_loc, p_agg), cut in n
ANNS_CUT = dict(D.ANNS_CELLS["anns-sift-10m"], n=2_000_000)
ANNS = ("serve", "assign")

_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()   # 8 host devices, before dryrun sets its own flag
from jax.sharding import AxisType
import repro.launch.dryrun as D
from repro.launch import hlo_costs, specs as RS
from repro.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
cells, anns_cut, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    sys.argv[3]
placed = json.loads(sys.argv[4])
res = {"policy": {}}
for arch in ARCH_IDS:
    a = arch.replace("_", "-")
    res["policy"][a] = {"opt": dataclasses.asdict(D.arch_opt_config(a))}
    for name, shape in SHAPES.items():
        for multi in (False, True):
            res["policy"][a][f"{name}/{multi}"] = dataclasses.asdict(
                D.arch_train_config(a, shape, multi))
res["anns_cells"] = D.ANNS_CELLS

def use_mesh(shape):
    n = shape[0] * shape[1]
    D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
        devices=jax.devices()[:n])

def analyzed(rec, txt):
    # hlo_costs' total, and its dot FLOPs alone (no elementwise op, no
    # reduce counted)
    saved = hlo_costs._ELEMENTWISE
    hlo_costs._ELEMENTWISE = set()
    dots = hlo_costs.analyze(txt.replace(" reduce(", " reduce-none("))
    hlo_costs._ELEMENTWISE = saved
    return {"memory": rec["memory"], "flops": rec["hlo_costs"]["flops"],
            "dot_flops": dots["flops"]}

texts = {}
analyze = hlo_costs.analyze
def keep(txt, entry=None):
    texts["last"] = txt
    return analyze(txt, entry)
hlo_costs.analyze = keep
D.get_config = lambda a: get_config(a, reduced=True)
D.ANNS_CELLS = {"cut": anns_cut}
for name, (arch, kind, b, s, mesh, changes) in placed.items():
    use_mesh(mesh)
    D.get_config = lambda a: dataclasses.replace(get_config(a, reduced=True),
                                                 **changes)
    D.SHAPES = {kind: ShapeConfig(kind, s, b, kind)}
    rec = D.lower_cell(arch, kind, False)
    assert rec["status"] == "OK", rec
    res[f"{name}/{mesh}"] = {"memory": rec["memory"]}
D.get_config = lambda a: get_config(a, reduced=True)
for mesh in ((2, 4), (1, 1)):
    use_mesh(mesh)
    for name, (arch, kind, b, s) in cells.items():
        D.SHAPES = {kind: ShapeConfig(kind, s, b, kind)}
        rec = D.lower_cell(arch, kind, False)
        assert rec["status"] == "OK", rec
        r = analyzed(rec, texts["last"])
        cfg = get_config(arch, reduced=True)
        # the leaves of the step's outputs
        if kind == "train":
            leaves = len(jax.tree.leaves(RS.abstract_params(cfg))) \
                + len(jax.tree.leaves(RS.abstract_opt_state(
                    cfg, D.arch_opt_config(arch)))) + 5
        else:
            leaves = 1 + len(jax.tree.leaves(RS.decode_inputs(
                cfg, D.SHAPES[kind])[1]))
        r["output_leaves"] = leaves
        res[f"{name}/{mesh}"] = r
    for kind in ("serve", "assign"):
        rec = D.lower_anns_cell("cut", False, kind)
        assert rec["status"] == "OK", rec
        r = analyzed(rec, texts["last"])
        r["output_leaves"] = 2
        res[f"anns/{kind}/{mesh}"] = r
with open(out, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The reference's cells compiled in one JAX subprocess on 8 forced
    host devices: {"<cell>/(2, 4)" and "<cell>/(1, 1)": memory, hlo_costs
    FLOPs and their dot part, output leaves}, and its dry-run policies."""
    out = tmp_path_factory.mktemp("census")
    (out / "reference.py").write_text(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(out / "reference.py"),
                          json.dumps(CELLS), json.dumps(ANNS_CUT),
                          str(out / "reference.json"),
                          json.dumps(PLACED_CELLS)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    res = json.loads((out / "reference.json").read_text())
    res["seconds"] = time.perf_counter() - t0
    return res


# REDUCED cells on the meshes where the SSD takes a layout the (2, 4) mesh
# does not meet, their configs changed so that it arises: name: (arch,
# kind, batch, seq, mesh, config changes)
PLACED_CELLS = {
    # 10 SSD heads (d_model 80) split over 5, in_proj (346) and conv (176)
    # whole
    "hymba/train, SSD heads over a whole in_proj": (
        "hymba-1.5b", "train", 4, 32, (1, 5), {"d_model": 80}),
    # conv 144 = 128 + 8 + 8 in contiguous blocks of 48, in_proj (280)
    # whole
    "mamba2/train, conv cut across its parts": (
        "mamba2-370m", "train", 4, 32, (1, 3), {"ssm_state": 8}),
}


@pytest.mark.parametrize("name", list(PLACED_CELLS))
def test_argument_bytes_of_the_ssd_layouts_equal_the_compiled_reference(
        compiled, name):
    """The census's argument bytes on the cell's mesh are XLA's exactly,
    the SSD's leaves held as the reference's contiguous blocks."""
    arch, kind, b, s, mesh, changes = PLACED_CELLS[name]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    shape = ShapeConfig(kind, s, b, kind)
    got = D.lm_record(cfg, shape, shd.MeshShape(("data", "model"), mesh),
                      None, D.arch_opt_config(arch),
                      D.arch_train_config(arch, shape, False))["memory"]
    assert got["argument_size_in_bytes"] == compiled[
        f"{name}/{list(mesh)}"]["memory"]["argument_size_in_bytes"]


def _census(name, mesh):
    if name.startswith("anns/"):
        return D.anns_record(ANNS_CUT, mesh, name.split("/")[1])
    arch, kind, b, s = CELLS[name]
    shape = ShapeConfig(kind, s, b, kind)
    return D.lm_record(get_config(arch, reduced=True), shape, mesh, None,
                       D.arch_opt_config(arch),
                       D.arch_train_config(arch, shape, False))


ALL_CELLS = list(CELLS) + [f"anns/{k}" for k in ANNS]


def test_the_reference_compiles_in_two_minutes(compiled):
    assert compiled["seconds"] < 120, compiled["seconds"]


def test_policies_and_anns_cells_match_the_reference(compiled):
    for arch, pol in compiled["policy"].items():
        assert dataclasses.asdict(D.arch_opt_config(arch)) == pol["opt"]
        for name, shape in SHAPES.items():
            for multi in (False, True):
                assert dataclasses.asdict(D.arch_train_config(
                    arch, shape, multi)) == pol[f"{name}/{multi}"]
    assert D.ANNS_CELLS == compiled["anns_cells"]


@pytest.mark.parametrize("name", ALL_CELLS)
def test_argument_bytes_equal_the_compiled_reference(compiled, name):
    """On (2, 4) and on one device: the census's argument bytes are XLA's
    exactly; its output bytes are XLA's less 8 bytes a leaf of the
    output tuple."""
    for mesh, key in ((MESH_2x4, "(2, 4)"), (ONE, "(1, 1)")):
        ref = compiled[f"{name}/{key}"]
        got = _census(name, mesh)["memory"]
        assert got["argument_size_in_bytes"] == \
            ref["memory"]["argument_size_in_bytes"], key
        assert got["output_size_in_bytes"] + 8 * ref["output_leaves"] == \
            ref["memory"]["output_size_in_bytes"], key


# hlo_costs' elementwise share of each cell's FLOPs on one device (one
# FLOP an element: converts, the softmax's passes, masks), from this
# test's own run: the gap beside the dot FLOPs the census counts
ELEMENTWISE_SHARE = {
    "tinyllama/train": 0.0764, "tinyllama/prefill": 0.0523,
    "tinyllama/decode": 0.3320, "dbrx/train": 0.0452,
    "hymba/decode": 0.3539, "whisper/prefill": 0.0695,
    "anns/serve": 0.3756, "anns/assign": 0.0193,
}


@pytest.mark.parametrize("name", ALL_CELLS)
def test_flops_against_hlo_costs(compiled, name):
    """On one device, ``hlo_costs.analyze``'s dot FLOPs are the census's
    with every (query, key) pair counted (the reference's jnp attention
    computes its masked chunks), but for two differences of formulation:
    XLA takes the aux loss's router product and the routing's (the same
    product) once in a train step's forward and in its recompute (2 of
    the 8 router products a layer), and the reference's SSD decode step
    takes its conv window as a dot (``2 B K C`` a layer; the port's is an
    elementwise product and sum). ``cost.flops`` is below the dot FLOPs
    by the masked pairs the kernel skips (causal halves), within 10% of
    them; the rest of ``analyze``'s total is its elementwise count,
    pinned."""
    ref = compiled[f"{name}/(1, 1)"]
    cost = _census(name, ONE)["cost"]
    materialised = cost["flops"] - cost.get("attention_flops", 0.0) \
        + cost.get("attention_flops_materialised", 0.0)
    if name.endswith("train"):
        materialised -= cost["by_part"].get("router", 0.0) / 4
    if name.endswith("decode"):
        cfg = get_config(CELLS[name][0], reduced=True)
        if cfg.ssm_state:
            materialised += 2 * CELLS[name][2] * cfg.ssm_conv * (
                cfg.d_inner + 2 * cfg.ssm_state) * cfg.n_layers
    assert materialised == ref["dot_flops"]
    assert abs(ref["dot_flops"] - cost["flops"]) <= 0.10 * ref["dot_flops"]
    share = (ref["flops"] - ref["dot_flops"]) / ref["flops"]
    assert abs(share - ELEMENTWISE_SHARE[name]) < 0.002, share


# ----------------------------------------------------- FlopCounterMode

FAMILY_ARCHS = ("tinyllama-1.1b", "kimi-k2-1t-a32b", "mamba2-370m",
                "hymba-1.5b", "whisper-small", "internvl2-76b", "dbrx-132b")


def _batch(cfg, b, s, dtype=torch.int64):
    g = torch.Generator().manual_seed(0)
    x = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                 dtype=dtype),
         "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                 dtype=dtype)}
    if cfg.family == "vlm":
        x["vision_embeds"] = torch.randn(b, cfg.vision_tokens, cfg.d_model,
                                         generator=g)
    if cfg.enc_layers:
        x["frames"] = torch.randn(b, cfg.enc_frames, cfg.d_model,
                                  generator=g)
    return x


@pytest.mark.parametrize("case", ["train", "prefill", "decode",
                                  "train: 2 microbatches, 48 tokens"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_flops_equal_the_flop_counter(arch, case):
    """The port's own step on REDUCED CPU tensors under
    ``FlopCounterMode``: its matmul-class FLOPs (mm, bmm and the rest it
    counts) are the census's, with the materialised attention of the
    plain version that runs on the CPU. The MoE experts run at their
    capacity; a train step's blocks are recomputed (remat), the last
    product of each block not (the checkpoint's recompute stops once its
    saved tensors are back); over two microbatches at 48 tokens the SSD
    runs two chunks (mamba2's chunk is 32)."""
    kind = case.split(":")[0]
    b, s, n = (4, 48, 2) if ":" in case else (2, 24, 1)
    cfg = get_config(arch, reduced=True)
    model = init_params(cfg, 0, "cpu")
    x = _batch(cfg, b, s)
    counter = FlopCounterMode(display=False)
    ocfg = D.arch_opt_config(arch)
    if kind == "train":
        model.requires_grad_()
        state = init_state(dict(model.named_parameters()), ocfg)
        step = make_train_step(cfg, ocfg, TrainConfig(microbatches=n))
        with counter:
            step(model, state, x)
    elif kind == "prefill":
        del x["labels"]
        with torch.no_grad(), counter:
            prefill(model, x, cfg)
    else:
        cache = init_cache(cfg, b, s, device="cpu")
        with torch.no_grad(), counter:
            decode_step(model, x["tokens"][:, :1], cache, s - 1, cfg)
    cost = D.lm_record(cfg, ShapeConfig(kind, s, b, kind), ONE, None, ocfg,
                       TrainConfig(microbatches=n))["cost"]
    assert counter.get_total_flops() == _materialised(cost)
    assert sum(cost["by_part"].values()) == cost["flops"]
    if kind == "train" and cfg.family in ("dense", "vlm"):
        assert cost["attention_flops"] < cost["attention_flops_materialised"]


def test_visible_pairs_follow_the_kernel_mask():
    from repro_torch.kernels.flash_attention import _hidden
    for sq, sk, causal, window, meta in ((7, 7, True, 0, 0),
                                         (5, 9, True, 0, 0),
                                         (4, 6, False, 0, 0),
                                         (40, 40, True, 8, 3),
                                         (33, 40, True, 16, 0),
                                         (40, 40, True, 64, 8)):
        hidden = _hidden(sq, sk, "cpu", causal, window, meta)
        want = sq * sk - (0 if hidden is None else int(hidden.sum()))
        assert D.visible_pairs(sq, sk, causal, window, meta) == want


def _materialised(cost):
    """The census's FLOPs with every (query, key) pair of the attention,
    as the plain version on the CPU computes them."""
    return cost["flops"] - cost["attention_flops"] \
        + cost["attention_flops_materialised"]


# --------------------------------------------------------- collectives

_WORLD = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import distributed as pd
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import mesh_context
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as pm
from repro_torch.models.model import decode_step, init_cache, init_params, \
    prefill
from repro_torch.models.moe import block_specs
from repro_torch.training.optimizer import init_state
from repro_torch.training.train_step import TrainConfig, make_train_step
from torch.utils.flop_counter import FlopCounterMode
torch.set_num_threads(1)
rank, out, cases, anns, flagged = int(sys.argv[1]), sys.argv[2], \
    json.loads(sys.argv[3]), json.loads(sys.argv[4]), json.loads(sys.argv[5])
changes = json.loads(sys.argv[6])

record = {"bytes": {}, "calls": 0, "dist_calls": 0}
def add(kind, nbytes):
    record["bytes"][kind] = record["bytes"].get(kind, 0) + nbytes
    record["calls"] += 1
def wrap(name, kind, size):
    fn = getattr(pd, name)
    def recorded(mesh, axis, t, *a):
        add(kind, size(mesh.shape[axis], t.numel() * t.element_size()))
        return fn(mesh, axis, t, *a)
    setattr(pd, name, recorded)
wrap("_gather", "all-gather", lambda n, b: n * b)
wrap("_sum_axis", "all-reduce", lambda n, b: b if n == 2 else n * b)
wrap("_reduce_scatter", "reduce-scatter", lambda n, b: n * b)
for name in ("all_gather", "all_reduce"):
    def counted(*a, _fn=getattr(dist, name), **kw):
        record["dist_calls"] += 1
        return _fn(*a, **kw)
    setattr(dist, name, counted)

def measured(fn):
    record["bytes"], record["calls"], record["dist_calls"] = {}, 0, 0
    fn()
    return dict(record)

res = {}
for world in (5, 4, 3, 2):
    if rank >= world:
        break
    compat.init_ranks("gloo", f"file://{out}/rendezvous{world}", rank, world)
    for name, (w, shape, kind, arch, b, s, n) in cases.items():
        if w != world:
            continue
        mesh = pm.make_mesh(shape, ("data", "model"))
        g = torch.Generator().manual_seed(0)
        if arch == "anns":
            z = D.anns_sizes(anns, mesh, 32, 64)
            d = anns["d"]
            if kind == "serve":
                q = torch.randn(anns["q"], d, generator=g)
                db = torch.randn(z["n_local"], d, generator=g)
                rows = torch.randint(0, z["n_local"], (anns["q"], z["rows"]),
                                     generator=g, dtype=torch.int32)
                step = pd.make_anns_serve_step(mesh, k=anns["k"])
                res[f"{name}/{rank}"] = measured(lambda: step(q, db, rows))
            else:
                r = torch.randn(z["res_local"], d, generator=g)
                a = torch.randn(z["agg_local"], d, generator=g)
                step = pd.make_anns_assign_step(mesh, k=D.ASSIGN_K,
                                                row_chunk=32, col_chunk=64)
                res[f"{name}/{rank}"] = measured(lambda: step(r, a))
            continue
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  **changes.get(name, {}))
        dist_cfg = shd.DistConfig(shard_head_dim_fallback=name in flagged)
        with mesh_context(mesh, dist_cfg):
            model = init_params(cfg, 0, "cpu")
        spec = shd.batch_spec(b, mesh)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=g, dtype=torch.int32),
                 "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=g, dtype=torch.int32)}
        if cfg.enc_layers:
            batch["frames"] = torch.randn(b, cfg.enc_frames, cfg.d_model,
                                          generator=g)
        block = {k: shd.local_block(v, shd.batch_spec(
            b, mesh, extra_dims=v.dim() - 1), mesh) for k, v in batch.items()}
        if kind == "train":
            model.requires_grad_()
            ocfg = D.arch_opt_config(arch)
            state = init_state(dict(model.named_parameters()), ocfg, mesh,
                               block_specs(model))
            step = make_train_step(cfg, ocfg, TrainConfig(microbatches=n))
            def run():
                with mesh_context(mesh, dist_cfg, batch=b):
                    step(model, state, block)
        elif kind == "prefill":
            del block["labels"]
            def run():
                with torch.no_grad(), mesh_context(mesh, dist_cfg, batch=b):
                    prefill(model, block, cfg)
        else:
            with mesh_context(mesh, dist_cfg):
                cache = init_cache(cfg, b, s, device="cpu")
            def run():
                with torch.no_grad(), mesh_context(mesh, dist_cfg, batch=b):
                    decode_step(model, block["tokens"][:, :1], cache, s - 1,
                                cfg)
        counter = FlopCounterMode(display=False)
        with counter:
            res[f"{name}/{rank}"] = measured(run)
        res[f"{name}/{rank}"]["flops"] = counter.get_total_flops()
    compat.shutdown()
with open(f"{out}/world{rank}.json", "w") as f:
    json.dump(res, f)
"""

# name: (world, mesh, kind, arch, batch, seq, microbatches); on (2, 2)
# DBRX's experts hold d over data (FSDP: gathered, their gradients
# reduce-scattered)
WORLD_CASES = {
    "pod serve, (2, 2)": (4, (2, 2), "serve", "anns", 0, 0, 1),
    "pod assign, (2, 2)": (4, (2, 2), "assign", "anns", 0, 0, 1),
    "tinyllama train, (4, 1), 2 microbatches": (
        4, (4, 1), "train", "tinyllama-1.1b", 8, 16, 2),
    "dbrx train, (2, 2)": (4, (2, 2), "train", "dbrx-132b", 4, 16, 1),
    "dbrx prefill, (2, 2)": (4, (2, 2), "prefill", "dbrx-132b", 4, 16, 1),
    "tinyllama train, (2, 1)": (2, (2, 1), "train", "tinyllama-1.1b", 4, 16,
                                1),
    "dbrx train, (1, 2)": (2, (1, 2), "train", "dbrx-132b", 4, 16, 1),
    "dbrx decode, (1, 2)": (2, (1, 2), "decode", "dbrx-132b", 4, 16, 1),
    "kimi-k2 train, (1, 2): shared experts": (
        2, (1, 2), "train", "kimi-k2-1t-a32b", 4, 16, 1),
    "mamba2 train, (2, 2): SSD heads split": (
        4, (2, 2), "train", "mamba2-370m", 4, 16, 1),
    "hymba decode, (1, 2)": (2, (1, 2), "decode", "hymba-1.5b", 4, 16, 1),
    "whisper prefill, (1, 2): encoder and cross-attention": (
        2, (1, 2), "prefill", "whisper-small", 4, 16, 1),
    # under DistConfig(shard_head_dim_fallback=True) (FLAGGED): qwen's 5
    # heads split their 12 dims (case H), TinyLlama's and hymba's 4 heads
    # split while their 2 kv heads split their 16 dims (case M)
    "qwen train, (1, 4): head dim split, case H": (
        4, (1, 4), "train", "qwen1.5-4b", 4, 16, 1),
    "tinyllama train, (1, 4): kv head dim split, case M": (
        4, (1, 4), "train", "tinyllama-1.1b", 4, 16, 1),
    "hymba decode, (1, 4): kv head dim split, case M": (
        4, (1, 4), "decode", "hymba-1.5b", 4, 16, 1),
    "qwen decode, (2, 2), batch of one: head dim split, case H": (
        4, (2, 2), "decode", "qwen1.5-4b", 1, 16, 1),
    # the SSD layouts of PLACED_CELLS' configs: case A, hymba's 10 SSD
    # heads split over 5 with in_proj and the conv whole; case B,
    # mamba2's conv cut across its parts on 3
    "hymba train, (1, 5): SSD heads over a whole in_proj": (
        5, (1, 5), "train", "hymba-1.5b", 4, 16, 1),
    "mamba2 train, (1, 3): conv cut across its parts": (
        3, (1, 3), "train", "mamba2-370m", 4, 16, 1),
}
# config changes of a world case
WORLD_CHANGES = {
    "hymba train, (1, 5): SSD heads over a whole in_proj": {"d_model": 80},
    "mamba2 train, (1, 3): conv cut across its parts": {"ssm_state": 8},
}
FLAGGED = [name for name in WORLD_CASES if "head dim split" in name]
HEAD_DIM = shd.DistConfig(shard_head_dim_fallback=True)
# anns-sift-10m's widths at a size the CPU scans at once (the assign step's
# chunks 32 x 64)
ANNS_SMALL = dict(D.ANNS_CELLS["anns-sift-10m"], n=32768, d=16, q=16, k=8,
                  cap=8, p_loc=1, p_agg=0.01)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each case's bytes by kind on every rank, recorded in gloo worlds of
    5, 4, 3 and then 2 CPU ranks."""
    out = tmp_path_factory.mktemp("census_worlds")
    (out / "world.py").write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(out / "world.py"), str(r), str(out),
         json.dumps(WORLD_CASES), json.dumps(ANNS_SMALL),
         json.dumps(FLAGGED), json.dumps(WORLD_CHANGES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(5)]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    res = {}
    for r in range(5):
        res.update(json.loads((out / f"world{r}.json").read_text()))
    return res


@pytest.mark.parametrize("name", list(WORLD_CASES))
def test_collectives_equal_the_recorded_bytes(worlds, name):
    """Every rank's bytes by kind equal the census's for the rank, and
    every ``torch.distributed`` collective the step makes went through
    the three recorded functions."""
    world, shape, kind, arch, b, s, n = WORLD_CASES[name]
    mesh = shd.MeshShape(("data", "model"), shape)
    if arch == "anns":
        want = D.anns_record(ANNS_SMALL, mesh, kind, 32, 64)["collectives"]
    else:
        want = _world_record(name)["collectives"]
    assert want["total"] > 0
    for rank in range(world):
        got = worlds[f"{name}/{rank}"]
        assert got["calls"] == got["dist_calls"], rank
        total = sum(got["bytes"].values())
        assert {**{k: float(v) for k, v in got["bytes"].items()},
                "total": float(total)} == want, rank


def _world_record(name):
    world, shape, kind, arch, b, s, n = WORLD_CASES[name]
    return D.lm_record(dataclasses.replace(get_config(arch, reduced=True),
                                           **WORLD_CHANGES.get(name, {})),
                       ShapeConfig(kind, s, b, kind),
                       shd.MeshShape(("data", "model"), shape),
                       HEAD_DIM if name in FLAGGED else None,
                       D.arch_opt_config(arch), TrainConfig(microbatches=n))


@pytest.mark.parametrize("name", FLAGGED)
def test_flops_under_the_head_dim_placement_equal_the_flop_counter(worlds,
                                                                  name):
    """``FlopCounterMode`` over the port's step on each rank under the
    head-dim placement counts the census's FLOPs for the rank: the
    projections of its head-dim blocks, the whole attention over every
    head (case H) or its heads (case M), and a decode's partial scores
    over its block of the head dim."""
    cost = _world_record(name)["cost"]
    for rank in range(WORLD_CASES[name][0]):
        assert worlds[f"{name}/{rank}"]["flops"] == _materialised(cost), \
            rank


# ------------------------------------------- the dry-run artifacts' checks

@pytest.fixture(scope="module")
def grid():
    """Every cell of the LM grid (by default, and under the head-dim
    placement: ``head_dim_fallback``) and the ANNS cells, on both meshes,
    computed here, and the seconds it took."""
    t0 = time.perf_counter()
    recs = list(D.grid()) + list(D.grid(anns=True))
    hd = list(D.grid(dist=HEAD_DIM))
    return {"seconds": time.perf_counter() - t0,
            "recs": {(r["mesh"], r["arch"], r["shape"]): r for r in recs},
            "head_dim_fallback": {(r["mesh"], r["arch"], r["shape"]): r
                                  for r in hd}}



def test_the_grid_runs_in_a_minute(grid):
    assert grid["seconds"] < 60, grid["seconds"]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cell_status(grid, mesh, arch, shape):
    _cell_status(grid["recs"][(mesh, arch, shape)], arch, shape)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cell_status_head_dim_split(grid, mesh, arch, shape):
    """Every cell OK under ``--shard-hd-fallback``."""
    _cell_status(grid["head_dim_fallback"][(mesh, arch, shape)], arch,
                 shape)


def _cell_status(rec, arch, shape):
    ok, reason = configs.cell_is_applicable(get_config(arch), SHAPES[shape])
    if not ok:
        assert rec["status"] == reason and reason.startswith("SKIP")
        return
    assert rec["status"] == "OK", rec["status"]
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["port_argument_bytes"] > 0


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_anns_cells(grid, mesh):
    cells = [r for (m, arch, _), r in grid["recs"].items()
             if m == mesh and arch.startswith("anns-")]
    assert len(cells) >= 6
    for rec in cells:
        assert rec["status"] == "OK", rec
        assert rec["collectives"]["all-gather"] > 0


def test_multi_pod_shards_pod_axis(grid):
    """The 512-rank mesh must reduce the per-rank FLOPs of a data-parallel
    train cell against the 256-rank mesh."""
    f1 = grid["recs"][("16x16", "tinyllama-1-1b", "train_4k")]["cost"]
    f2 = grid["recs"][("2x16x16", "tinyllama-1-1b", "train_4k")]["cost"]
    assert f2["flops"] < f1["flops"] * 0.75, (f1, f2)


def test_main_writes_its_own_directory(tmp_path, monkeypatch):
    """``main`` writes the reference's ``cell_path`` layout under
    ``artifacts/dryrun_torch`` (never the reference's
    ``artifacts/dryrun``), one record a cell, and exits 0 with no
    failure."""
    monkeypatch.chdir(tmp_path)
    assert D.OUT == "artifacts/dryrun_torch"
    for argv in (["--arch", "mamba2-370m", "--mesh", "both"],
                 ["--anns", "--mesh", "single"]):
        with pytest.raises(SystemExit) as e:
            D.main(argv)
        assert e.value.code == 0
    written = sorted(str(p.relative_to(tmp_path))
                     for p in tmp_path.rglob("*.json"))
    assert len(written) == 8 + 6
    assert all(p.startswith("artifacts/dryrun_torch/") for p in written)
    rec = json.loads((tmp_path / D.cell_path(
        D.OUT, "mamba2-370m", "long_500k", "2x16x16")).read_text())
    assert rec["status"] == "OK" and rec["mesh"] == "2x16x16"
    assert not (tmp_path / "artifacts" / "dryrun").exists()
