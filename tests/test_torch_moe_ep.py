"""Expert parallelism (``models/moe.py``'s ``moe_sharded`` under the mesh
context) against the reference's ``_moe_sharded`` (``shard_map``) and
its model under ``mesh_context``, on the same seeded numpy inputs.

The reference runs in one JAX subprocess on 8 forced host devices (meshes
of ``AxisType.Auto`` axes, as jax 0.4's were; the model's params placed by
``param_shardings``, its tokens by ``batch_spec``); the port in one set of
8 gloo rank processes (``file://`` rendezvous), each with its blocks cut
by ``sharding.local_block``: its tokens by ``batch_spec``, its experts by
``moe.expert_specs``, the model's weights by
``carry.lm_params_from_arrays(..., mesh=...)``. Meshes: (data 2, model 4)
and (pod 2, data 2, model 2), the second with default ``DistConfig`` (the
experts' ``d`` over data alone) and with ``fsdp_over_pod`` (over pod and
data: the two-axis gather order).

Float32 throughout. The layer's output is held within 1e-5 (rtol and
atol: f32 sums of a token's contributions grouped across ranks, and
XLA's and PyTorch's products), the logits within 1e-4 (rtol and atol, as
``tests/test_torch_moe.py`` holds the unsharded model).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.context import mesh_context  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
# name: (shape, axis names, DistConfig kwargs)
MESHES = {"2x4": ((2, 4), ("data", "model"), {}),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), {}),
          "2x2x2-fsdp_pod": ((2, 2, 2), ("pod", "data", "model"),
                             {"fsdp_over_pod": True})}
# layer cases: (arch REDUCED, config changes, B, S). DBRX REDUCED (4
# experts top-2, capacity 8: no drops); at capacity 1.0 (drops); Kimi-K2
# REDUCED (8 experts, a shared one); a batch of one, which the data axes
# cannot shard: replicated, at the reference's per-rank capacity
LAYER = {"dbrx": ("dbrx-132b", {}, 8, 16),
         "dbrx-drops": ("dbrx-132b", {"capacity_factor": 1.0}, 8, 16),
         "kimi": ("kimi-k2-1t-a32b", {}, 8, 16),
         "replicated": ("dbrx-132b", {"capacity_factor": 1.0}, 1, 16)}
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# model cases: (batch size at MODEL_S tokens, config changes). 4 is
# sharded over every mesh's data axes; 3 is divided by none of them:
# replicated, each rank holding all 3 rows at the reference's per-rank
# capacity, at capacity 1.0 so that the capacity drops tokens
MODEL_BATCH = {"sharded": (4, {}),
               "replicated": (3, {"capacity_factor": 1.0})}
MODEL_S = 16
# specs whose jax placement on the (2, 2, 2) mesh local_block must give
PLACEMENT = {"rows": (("pod", "data"), None, "model"),
             "mixed": ("model", "pod", "data"),
             "cols": (None, None, ("data", "pod", "model"))}
PLACEMENT_SHAPE = (8, 4, 16)


def _cfgs(arch, dtype="float32", **changes):
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype=dtype,
                                     **changes)
                 for get in (ref_get_config, get_config))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _inputs():
    x = {}
    for name, (arch, changes, b, s) in LAYER.items():
        rcfg, _ = _cfgs(arch, **changes)
        params = ref_moe.init_moe(jax.random.PRNGKey(len(x)), rcfg,
                                  jnp.float32)
        for k, v in params.items():
            x[f"layer/{name}/{k}"] = np.asarray(v)
        x[f"layer/{name}/x"] = np.random.default_rng(len(x)).standard_normal(
            (b, s, rcfg.d_model)).astype(np.float32)
    rcfg, _ = _cfgs("dbrx-132b")
    for k, v in _flatten(R.init_params(jax.random.PRNGKey(7), rcfg)).items():
        x[f"model/params/{k}"] = v
    rng = np.random.default_rng(8)
    for case, (b, _) in sorted(MODEL_BATCH.items()):
        x[f"model/{case}/tokens"] = rng.integers(
            0, rcfg.vocab_size, (b, MODEL_S)).astype(np.int32)
        x[f"model/{case}/next"] = rng.integers(
            0, rcfg.vocab_size, (b, 1)).astype(np.int32)
    return x


_REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import models as R
from repro.configs import get_config
from repro.distributed.context import mesh_context
from repro.distributed.sharding import DistConfig, batch_spec, param_shardings
from repro.models import moe
meshes, layer, batches, placement, shape = (eval(a) for a in sys.argv[1:6])
out = sys.argv[6]
x = dict(np.load(out + "/inputs.npz"))

def unflatten(prefix):
    tree = {}
    for k, v in x.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return tree

res = {}
cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                          dtype="float32")
params = unflatten("model/params/")
for m, (mshape, names, dist_kw) in meshes.items():
    mesh = jax.make_mesh(mshape, names,
                         axis_types=(AxisType.Auto,) * len(mshape))
    dist = DistConfig(**dist_kw)
    res[f"{m}/devices"] = np.vectorize(lambda d: d.id)(mesh.devices)
    with mesh_context(mesh, dist):
        for name, (arch, changes, bb, ss) in layer.items():
            lcfg = dataclasses.replace(get_config(arch, reduced=True),
                                       dtype="float32", **changes)
            lp = unflatten(f"layer/{name}/")
            xx = lp.pop("x")
            got = jax.jit(lambda p, v: moe._moe_sharded(
                p, v, lcfg, mesh, dist))(lp, xx)
            res[f"{m}/layer/{name}"] = np.asarray(got)
        p = jax.device_put(params, param_shardings(params, mesh, dist))
        for case, (_, changes) in batches.items():
            b, s = x[f"model/{case}/tokens"].shape
            ccfg = dataclasses.replace(cfg, **changes)
            tok = jax.device_put(x[f"model/{case}/tokens"],
                                 NamedSharding(mesh, P(*batch_spec(b, mesh))))
            logits, cache = jax.jit(lambda p, t: R.prefill(
                p, {"tokens": t}, ccfg, max_len=s + 1))(p, tok)
            step, _ = jax.jit(lambda p, n, c: R.decode_step(
                p, n, c, s, ccfg))(p, jnp.asarray(x[f"model/{case}/next"]),
                                  cache)
            res[f"{m}/{case}/prefill"] = np.asarray(logits)
            res[f"{m}/{case}/decode"] = np.asarray(step)
    if len(mshape) == 3:
        for key, spec in placement.items():
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
            res[f"{m}/placement/{key}"] = np.array(
                [[[sl.start or 0, sl.stop or n]
                  for sl, n in zip(idx[d], shape)]
                 for d in sorted(idx, key=lambda d: d.id)])
np.savez(out + "/reference.npz", **res)
"""

_PORT = r"""
import dataclasses, sys
import numpy as np
import torch
from repro_torch.carry import lm_params_from_arrays
from repro_torch.configs import get_config
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import mesh_context
from repro_torch.launch import mesh as pm
from repro_torch.models import decode_step, moe, prefill
from repro_torch.models.model import gather_vocab
rank, out = int(sys.argv[1]), sys.argv[2]
meshes, layer, batches = (eval(a) for a in sys.argv[3:6])
x = dict(np.load(out + "/inputs.npz"))

def unflatten(prefix):
    tree = {}
    for k, v in x.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree

res = {}
compat.init_ranks("gloo", f"file://{out}/rendezvous", rank, 8)
cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True),
                          dtype="float32")
for m, (mshape, names, dist_kw) in meshes.items():
    mesh = pm.make_mesh(mshape, names)
    dist = shd.DistConfig(**dist_kw)
    res[f"{m}/coords"] = np.array(mesh.coords)
    for name, (arch, changes, bb, ss) in layer.items():
        lcfg = dataclasses.replace(get_config(arch, reduced=True),
                                   dtype="float32", **changes)
        lp = {k: torch.from_numpy(v) for k, v in
              unflatten(f"layer/{name}/").items()}
        xx = shd.local_block(lp.pop("x"), shd.batch_spec(bb, mesh, dist, 2),
                             mesh)
        for k, spec in moe.expert_specs(lcfg, mesh, dist).items():
            lp[k] = shd.local_block(lp[k], spec, mesh)
        res[f"{m}/layer/{name}/shapes"] = np.array(
            [list(lp[k].shape) for k in moe.EXPERT_WEIGHTS])
        with mesh_context(mesh, dist, batch=bb):
            res[f"{m}/layer/{name}"] = moe.moe_sharded(lp, xx, lcfg, mesh,
                                                       dist).numpy()
    for case, (_, changes) in batches.items():
        ccfg = dataclasses.replace(cfg, **changes)
        model = lm_params_from_arrays(ccfg, unflatten("model/params/"),
                                      device="cpu", mesh=mesh, dist=dist)
        res[f"{m}/{case}/moe_shape"] = np.array(
            model.blocks[0].moe.w_gate.shape)
        b, s = x[f"model/{case}/tokens"].shape
        spec = shd.batch_spec(b, mesh, dist)
        tok, nxt = (shd.local_block(
            torch.from_numpy(x[f"model/{case}/{k}"]).long(), spec, mesh)
            for k in ("tokens", "next"))
        with mesh_context(mesh, dist, batch=b), torch.inference_mode():
            logits, cache = prefill(model, {"tokens": tok}, ccfg,
                                    max_len=s + 1)
            step, _ = decode_step(model, nxt, cache, s, ccfg)
            logits, step = (gather_vocab(model, t) for t in (logits, step))
        res[f"{m}/{case}/prefill"] = logits.numpy()
        res[f"{m}/{case}/decode"] = step.numpy()
compat.shutdown()
np.savez(out + f"/port{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides on every case: {"x", "ref", "port": [rank 0..7]}."""
    out = tmp_path_factory.mktemp("moe_ep")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    (out / "reference.py").write_text(_REFERENCE)
    (out / "port.py").write_text(_PORT)
    ref = subprocess.Popen(
        [sys.executable, str(out / "reference.py"), repr(MESHES),
         repr(LAYER), repr(MODEL_BATCH), repr(PLACEMENT),
         repr(PLACEMENT_SHAPE), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(r), str(out),
         repr(MESHES), repr(LAYER), repr(MODEL_BATCH)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in [ref] + procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return {"x": x, "ref": dict(np.load(out / "reference.npz")),
            "port": [dict(np.load(out / f"port{r}.npz"))
                     for r in range(WORLD)]}


def _block(whole, spec, coords, names, shape):
    mesh = Mesh(names, shape, tuple(int(c) for c in coords), {})
    return shd.local_block(torch.from_numpy(whole), spec, mesh).numpy()


@pytest.mark.parametrize("case", sorted(LAYER))
@pytest.mark.parametrize("m", sorted(MESHES))
def test_sharded_layer_matches_the_reference(runs, m, case):
    """Each rank's output is its block (by ``batch_spec``) of the
    reference's ``_moe_sharded``, and it holds E/mp experts with d over
    the data axes its spec names."""
    shape, names, dist_kw = MESHES[m]
    arch, changes, b, s = LAYER[case]
    want = runs["ref"][f"{m}/layer/{case}"]
    mesh = shd.MeshShape(names, shape)
    spec = shd.batch_spec(b, mesh, extra_dims=2)
    cfg = _cfgs(arch, **changes)[1]
    specs = moe.expert_specs(cfg, mesh, shd.DistConfig(**dist_kw))
    for port in runs["port"]:
        coords = port[f"{m}/coords"]
        np.testing.assert_allclose(port[f"{m}/layer/{case}"],
                                   _block(want, spec, coords, names, shape),
                                   **LAYER_TOL)
        full = moe.moe_param_shapes(cfg)
        for k, got in zip(moe.EXPERT_WEIGHTS,
                          port[f"{m}/layer/{case}/shapes"]):
            assert tuple(got) == tuple(
                n // shd.group_size(mesh, e) for n, e in zip(full[k],
                                                             specs[k]))
    # the ranks of a model line hold the same bits
    for port in runs["port"]:
        twin = [q for q in runs["port"]
                if (q[f"{m}/coords"][:-1] == port[f"{m}/coords"][:-1]).all()]
        for q in twin:
            np.testing.assert_array_equal(q[f"{m}/layer/{case}"],
                                          port[f"{m}/layer/{case}"])


def test_the_fsdp_gather_spans_the_axes_the_spec_names():
    """On the (2, 2, 2) mesh the experts' ``d`` goes over data alone by
    default and over (pod, data) with ``fsdp_over_pod``: the gathers, and
    the blocks the ranks hold, follow the spec."""
    cfg = _cfgs("dbrx-132b")[1]
    mesh = shd.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert moe.expert_specs(cfg, mesh, shd.DistConfig())["w_gate"] == (
        "model", "data", None)
    assert moe.expert_specs(cfg, mesh, shd.DistConfig(
        fsdp_over_pod=True))["w_down"] == ("model", None, ("pod", "data"))


def test_replicated_batch_takes_the_reference_per_rank_capacity(runs):
    """A batch of one on (data 2, model 4) is replicated, yet the
    reference's ``_moe_sharded`` sizes the capacity from (B S) // dp, half
    the local path's: more tokens drop than on one device (ROADMAP queue
    3). Both packages agree (the test above); here, that it differs from
    the unsharded layer."""
    arch, changes, b, s = LAYER["replicated"]
    cfg = _cfgs(arch, **changes)[1]
    params = {k.split("/")[-1]: torch.from_numpy(np.array(v))
              for k, v in runs["x"].items()
              if k.startswith("layer/replicated/")}
    xx = params.pop("x")
    local = moe.moe_forward(params, xx, cfg).numpy()
    got = runs["port"][0]["2x4/layer/replicated"]
    assert np.abs(got - local).max() > 1e-2
    assert moe.capacity(cfg, b * s // 2) < moe.capacity(cfg, b * s)


@pytest.mark.parametrize("case", sorted(MODEL_BATCH))
@pytest.mark.parametrize("m", sorted(MESHES))
def test_sharded_model_matches_the_reference_under_mesh_context(runs, m,
                                                                case):
    """DBRX REDUCED (f32) carried to each rank by
    ``lm_params_from_arrays(..., mesh=...)``: its prefill and one decode
    step on the rank's block of the batch, under ``mesh_context`` given
    the whole batch's size, are the rank's block of the reference's,
    jitted under ``mesh_context`` with ``param_specs`` placement, for a
    batch the data axes shard and for one they replicate (the per-rank
    capacity of the reference's ``_moe_sharded``); its MoE layers hold
    E/mp experts, d over the spec's data axes."""
    shape, names, dist_kw = MESHES[m]
    mesh = shd.MeshShape(names, shape)
    cfg = _cfgs("dbrx-132b")[1]
    spec = moe.expert_specs(cfg, mesh, shd.DistConfig(**dist_kw))["w_gate"]
    for port in runs["port"]:
        coords = port[f"{m}/coords"]
        for what in ("prefill", "decode"):
            want = runs["ref"][f"{m}/{case}/{what}"]
            bspec = shd.batch_spec(want.shape[0], mesh, extra_dims=2)
            np.testing.assert_allclose(
                port[f"{m}/{case}/{what}"], _block(want, bspec, coords,
                                                   names, shape),
                **LOGITS_TOL)
        assert tuple(port[f"{m}/{case}/moe_shape"]) == (
            cfg.n_experts // shape[-1],
            cfg.d_model // shd.group_size(mesh, spec[1]), cfg.d_ff)


@pytest.mark.parametrize("m", sorted(MESHES))
def test_mesh_rank_order_matches_jax_make_mesh(runs, m):
    devices = runs["ref"][f"{m}/devices"]
    for r, port in enumerate(runs["port"]):
        assert devices[tuple(port[f"{m}/coords"])] == r


@pytest.mark.parametrize("key", sorted(PLACEMENT))
def test_local_block_is_where_jax_places_the_block(runs, key):
    """For each device of the (2, 2, 2) mesh, the block ``local_block``
    cuts at its coordinates is the index ``NamedSharding`` gives it."""
    shape, names, _ = MESHES["2x2x2"]
    devices = runs["ref"]["2x2x2/devices"]
    bounds = runs["ref"][f"2x2x2/placement/{key}"]
    whole = np.arange(np.prod(PLACEMENT_SHAPE)).reshape(PLACEMENT_SHAPE)
    for d in range(WORLD):
        coords = np.argwhere(devices == d)[0]
        want = whole[tuple(slice(a, b) for a, b in bounds[d])]
        np.testing.assert_array_equal(
            _block(whole, PLACEMENT[key], coords, names, shape), want)


def test_dispatch_with_an_expert_offset_matches_the_reference():
    """Experts [2, 4) of 6 on one rank, capacity 3 (drops), ids of other
    ranks parked and never kept, against ``_dispatch_compute``."""
    rng = np.random.default_rng(3)
    t, d, f, e, k, cap, off = 40, 16, 24, 6, 2, 3, 2
    xf = rng.standard_normal((t, d)).astype(np.float32)
    gate_e = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    gate_w = rng.random((t, k)).astype(np.float32)
    w = [rng.standard_normal(sh).astype(np.float32) / 4
         for sh in ((2, d, f), (2, d, f), (2, f, d))]
    want = ref_moe._dispatch_compute(
        jnp.asarray(xf), jnp.asarray(gate_w), jnp.asarray(gate_e),
        *map(jnp.asarray, w), n_experts=e, top_k=k, cap=cap,
        expert_offset=off)
    got = moe.dispatch_compute(
        torch.from_numpy(xf), torch.from_numpy(gate_w),
        torch.from_numpy(gate_e).long(), *map(torch.from_numpy, w),
        n_experts=e, top_k=k, cap=cap, expert_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # tokens routed to no local expert get exactly zero
    none_here = ~((gate_e >= off) & (gate_e < off + 2)).any(1)
    assert none_here.any() and (got.numpy()[none_here] == 0).all()


def test_data_parallel_mesh_without_expert_parallelism_raises(monkeypatch):
    """6 experts over a model axis of 4 under data 2: the reference takes
    its local path over the whole batch. Without the whole batch's size
    the port raises, as ``moe_sharded`` does; given it, the local path
    runs at the whole batch's capacity, each rank's queues after the
    data ranks before it. Here the other rank's counts are this rank's
    (the count gather patched: both hold the same rows), so each rank's
    output is its half of the local path over the two blocks stacked. A
    layer built under a mesh refuses to run outside it."""
    cfg = dataclasses.replace(_cfgs("dbrx-132b")[1], n_experts=6,
                              capacity_factor=1.0)
    mesh = Mesh(("data", "model"), (2, 4), (0, 0), {})
    rng = np.random.default_rng(5)
    params = {n: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32) / 4) for n, sh in moe.moe_param_shapes(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((2, 4, cfg.d_model)).astype(
        np.float32))
    with mesh_context(mesh), pytest.raises(ValueError,
                                           match="whole batch's size"):
        moe.moe_forward(params, x, cfg)
    monkeypatch.setattr(moe, "gather_axis", lambda mesh_, ax, t, dim:
                        torch.cat([t] * mesh_.shape[ax], dim))
    whole = moe.moe_forward(params, torch.cat([x, x]), cfg)
    for coords in ((0, 0), (1, 0)):
        rank = Mesh(("data", "model"), (2, 4), coords, {})
        with mesh_context(rank, batch=4):
            got = moe.moe_forward(params, x, cfg)
        assert torch.equal(got, whole[2 * coords[0]:2 * coords[0] + 2])
    assert not torch.equal(whole[:2], whole[2:])   # the queues dropped
    # without data parallelism the local path runs, every expert whole
    one = Mesh(("data", "model"), (1, 4), (0, 0), {})
    with mesh_context(one):
        assert moe.moe_forward(params, x, cfg).shape == x.shape
    cfg4 = _cfgs("dbrx-132b")[1]
    with mesh_context(mesh):
        layer = moe.MoE(cfg4, torch.float32, "cpu")
    assert layer.w_gate.shape == (1, cfg4.d_model // 2, cfg4.d_ff)
    with pytest.raises(RuntimeError, match="mesh context"):
        layer(x)


def test_sharded_layer_needs_the_whole_batch_under_data_parallelism():
    """Two rows on a rank of (data 2, model 4) may be a block of a batch
    of 4 or a whole batch of 2 replicated: capacities that differ. Without
    the batch's size in the context the layer raises, and with a size
    the rows do not lay out."""
    cfg = _cfgs("dbrx-132b")[1]
    mesh = Mesh(("data", "model"), (2, 4), (0, 0), {})
    with mesh_context(mesh):
        params = dict(moe.MoE(cfg, torch.float32, "cpu").named_parameters())
    x = torch.zeros(2, 4, cfg.d_model)
    with mesh_context(mesh), pytest.raises(ValueError,
                                           match="whole batch's size"):
        moe.moe_sharded(params, x, cfg, mesh)
    with mesh_context(mesh, batch=3), pytest.raises(ValueError,
                                                    match="lay out"):
        moe.moe_sharded(params, x, cfg, mesh)
