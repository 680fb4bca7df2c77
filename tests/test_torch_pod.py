"""The pod-scale ANNS data plane (``core/distributed.py``'s serve and
assign steps on a ``launch.mesh.Mesh``) against the reference's
``shard_map`` steps, on the same seeded numpy inputs.

The reference runs in one JAX subprocess on 8 forced host devices; the
port in one set of 8 gloo rank processes (``file://`` rendezvous) with
the kernels' plain versions. Both run every case on the (data 4, model
2) and (pod 2, data 2, model 2) meshes; the three-axis hierarchical merge
and the ``("pod", "data")`` row spec exist only on the second.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import distributed as pd
from repro_torch.distributed import compat
from repro_torch.launch import mesh as port_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# serve cases: (k, C) and the data; "short" pools are narrower than k
# (short2: the final width world * C < k), "ties" has integer vectors and
# the same block on ranks r and r + 4, so candidates of different ranks
# tie exactly
SERVE = {"random": (8, 8), "short": (20, 3), "short2": (20, 2),
         "ties": (8, 8)}
ASSIGN = {"random": 4, "dup": 4}          # k; row_chunk 32, col_chunk 64
Q, D, N_LOC, N_RES, M_AGG = 16, 16, 64, 4 * 64, 2 * 128


def _inputs():
    rng = np.random.default_rng(0)
    x = {}
    for name, (k, c) in SERVE.items():
        if name == "ties":
            base = rng.integers(-3, 4, (4, N_LOC, D)).astype(np.float32)
            db = np.concatenate([base[r % 4] for r in range(WORLD)])
            q = rng.integers(-3, 4, (Q, D)).astype(np.float32)
        else:
            db = rng.standard_normal((WORLD * N_LOC, D)).astype(np.float32)
            q = rng.standard_normal((Q, D)).astype(np.float32)
        # drawn with replacement: a row may be probed twice
        rows = rng.integers(0, N_LOC, (Q, c)).astype(np.int32)
        x.update({f"serve/{name}/q": q, f"serve/{name}/db": db,
                  f"serve/{name}/rows": rows})
    for name in ASSIGN:
        if name == "dup":
            res = rng.integers(-3, 4, (N_RES, D)).astype(np.float32)
            agg = rng.integers(-3, 4, (M_AGG, D)).astype(np.float32)
            # the second model block repeats half of the first
            agg[M_AGG // 2::2] = agg[:M_AGG // 4]
        else:
            res = rng.standard_normal((N_RES, D)).astype(np.float32)
            agg = rng.standard_normal((M_AGG, D)).astype(np.float32)
        x.update({f"assign/{name}/res": res, f"assign/{name}/agg": agg})
    return x


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from repro.core.distributed import make_anns_assign_step, make_anns_serve_step
meshes, serve, assign, out = eval(sys.argv[1]), eval(sys.argv[2]), \
    eval(sys.argv[3]), sys.argv[4]
x = dict(np.load(out + "/inputs.npz"))
res = {}
for m, (shape, names) in meshes.items():
    mesh = jax.make_mesh(shape, names)
    res[f"{m}/devices"] = np.vectorize(lambda d: d.id)(mesh.devices)
    with mesh:
        for name, (k, c) in serve.items():
            p = f"serve/{name}/"
            ids, d2 = jax.jit(make_anns_serve_step(mesh, k=k))(
                x[p + "q"], x[p + "db"], x[p + "rows"])
            res[f"{m}/{p}ids"], res[f"{m}/{p}d2"] = np.asarray(ids), \
                np.asarray(d2)
        for name, k in assign.items():
            p = f"assign/{name}/"
            ids, d2 = jax.jit(make_anns_assign_step(
                mesh, k=k, row_chunk=32, col_chunk=64))(x[p + "res"],
                                                        x[p + "agg"])
            res[f"{m}/{p}ids"], res[f"{m}/{p}d2"] = np.asarray(ids), \
                np.asarray(d2)
np.savez(out + "/reference.npz", **res)
"""

_PORT = r"""
import sys
import numpy as np
import torch
from repro_torch.core import distributed as pd
from repro_torch.distributed import compat
from repro_torch.kernels import ops
from repro_torch.launch import mesh as pm
rank, out = int(sys.argv[1]), sys.argv[2]
meshes, serve, assign = eval(sys.argv[3]), eval(sys.argv[4]), \
    eval(sys.argv[5])
x = {k: torch.from_numpy(v) for k, v in np.load(out + "/inputs.npz").items()}
res = {}
compat.init_ranks("gloo", f"file://{out}/rendezvous", rank, 8)
for m, (shape, names) in meshes.items():
    mesh = (pm.make_local_mesh(model_axis=2) if m == "4x2"
            else pm.make_mesh(shape, names))
    res[f"{m}/coords"] = np.array(mesh.coords)
    res[f"{m}/sizes"] = np.array([mesh.shape[a] for a in names])
    r = pd.linear_rank(mesh)
    for name, (k, c) in serve.items():
        p = f"serve/{name}/"
        n_loc = x[p + "db"].shape[0] // 8
        ids, d2 = pd.make_anns_serve_step(mesh, k=k)(
            x[p + "q"], x[p + "db"][r * n_loc:(r + 1) * n_loc], x[p + "rows"])
        res[f"{m}/{p}ids"], res[f"{m}/{p}d2"] = ids.numpy(), d2.numpy()
    dp = 0
    for a in pm.data_axes(mesh):
        dp = dp * mesh.shape[a] + mesh.axis_index(a)
    n_dp = 8 // mesh.shape["model"]
    for name, k in assign.items():
        p = f"assign/{name}/"
        rb = x[p + "res"].shape[0] // n_dp
        mb = x[p + "agg"].shape[0] // mesh.shape["model"]
        mi = mesh.axis_index("model")
        ids, d2 = pd.make_anns_assign_step(mesh, k=k, row_chunk=32,
                                           col_chunk=64)(
            x[p + "res"][dp * rb:(dp + 1) * rb],
            x[p + "agg"][mi * mb:(mi + 1) * mb])
        res[f"{m}/{p}block"] = np.array([dp * rb, (dp + 1) * rb])
        res[f"{m}/{p}own_ids"], res[f"{m}/{p}own_d2"] = ids.numpy(), d2.numpy()
        ids, d2 = pd.gather_rows(mesh, ids, d2)
        res[f"{m}/{p}ids"], res[f"{m}/{p}d2"] = ids.numpy(), d2.numpy()
for multi_pod in (False, True):
    try:
        pm.make_production_mesh(multi_pod=multi_pod)
    except ValueError as e:
        res[f"production/{multi_pod}"] = np.array(str(e))
compat.shutdown()
if rank == 0:   # a world of one: the 1 x 1 mesh against the direct calls
    compat.init_ranks("gloo", f"file://{out}/rendezvous1", 0, 1)
    mesh = pm.make_local_mesh()
    p = "serve/random/"
    q, db, rows = x[p + "q"], x[p + "db"][:64], x[p + "rows"]
    res["one/serve"] = np.stack([t.numpy().view(np.int32) for t in
                                 pd.make_anns_serve_step(mesh, k=8)(q, db,
                                                                    rows)])
    d2, ids = ops.l2_topk_masked(q, db[rows.long()], rows, 8)
    res["one/serve_direct"] = np.stack([ids.numpy(),
                                        d2.numpy().view(np.int32)])
    p = "assign/random/"
    ids, d2 = pd.make_anns_assign_step(mesh, k=4, row_chunk=32,
                                       col_chunk=64)(x[p + "res"], x[p + "agg"])
    res["one/assign"] = np.stack([ids.numpy(), d2.numpy().view(np.int32)])
    d2, ids = ops.l2_topk(x[p + "res"], x[p + "agg"], 4)
    res["one/assign_direct"] = np.stack([ids.numpy(),
                                         d2.numpy().view(np.int32)])
    compat.shutdown()
np.savez(out + f"/port{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides on every case: {"ref": {...}, "port": [rank 0..7]}."""
    out = tmp_path_factory.mktemp("pod")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    (out / "reference.py").write_text(_REFERENCE)
    (out / "port.py").write_text(_PORT)
    specs = [repr(MESHES), repr(SERVE), repr(ASSIGN)]
    ref = subprocess.Popen([sys.executable, str(out / "reference.py"),
                            *specs, str(out)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    procs = [subprocess.Popen([sys.executable, str(out / "port.py"), str(r),
                               str(out), *specs], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    for p in [ref] + procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return {"x": x, "ref": dict(np.load(out / "reference.npz")),
            "port": [dict(np.load(out / f"port{r}.npz"))
                     for r in range(WORLD)]}


def _near_ties(got_ids, want_ids, got_d2, want_d2, atol):
    """Ids may differ only where the distances agree to the tolerance."""
    differ = got_ids != want_ids
    assert not (differ & (np.abs(got_d2 - want_d2) > atol)).any()
    return int(differ.sum())


@pytest.mark.parametrize("case", sorted(SERVE))
@pytest.mark.parametrize("m", sorted(MESHES))
def test_serve_step_matches_reference(runs, m, case):
    """Every rank returns the same (ids, d2); the width is the
    reference's, min(k, world * C); d2 within rtol 1e-5 and an atol from
    the norms (the expanded form against the reference's (x - q)^2), ids
    equal up to near-ties, and on exact ties equal outright."""
    p = f"{m}/serve/{case}/"
    want_ids, want_d2 = runs["ref"][p + "ids"], runs["ref"][p + "d2"]
    k, c = SERVE[case]
    assert want_ids.shape == (Q, min(k, WORLD * c))
    for port in runs["port"]:
        np.testing.assert_array_equal(port[p + "ids"],
                                      runs["port"][0][p + "ids"])
        np.testing.assert_array_equal(port[p + "d2"],
                                      runs["port"][0][p + "d2"])
    got_ids, got_d2 = runs["port"][0][p + "ids"], runs["port"][0][p + "d2"]
    assert got_ids.shape == want_ids.shape and got_ids.dtype == np.int32
    assert (got_ids >= 0).all()
    if case == "ties":
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_d2, want_d2)
        return
    x = runs["x"]
    atol = 1e-5 * float((x[f"serve/{case}/q"] ** 2).sum(-1).max()
                        + (x[f"serve/{case}/db"] ** 2).sum(-1).max())
    np.testing.assert_allclose(got_d2, want_d2, rtol=1e-5, atol=atol)
    _near_ties(got_ids, want_ids, got_d2, want_d2, atol + 1e-5 * want_d2)


def test_exact_ties_across_ranks_take_the_merge_order(runs):
    """The tie case has real cross-rank ties (ranks r and r + 4 hold one
    block), which the hierarchical merge breaks by mesh order: the flat
    rank order would pick other ids, so the equality above says more
    than the distances do."""
    x = runs["x"]
    q, db, rows = (x[f"serve/ties/{n}"] for n in ("q", "db", "rows"))
    want = runs["ref"]["2x2x2/serve/ties/ids"]
    d2 = ((db.reshape(WORLD, N_LOC, D)[:, rows] - q[:, None]) ** 2).sum(-1)
    flat = np.concatenate(list(d2), axis=1)             # [Q, 8 C] rank-major
    gids = np.concatenate([rows + r * N_LOC for r in range(WORLD)], axis=1)
    order = np.argsort(flat, axis=1, kind="stable")[:, :want.shape[1]]
    flat_ids = np.take_along_axis(gids, order, axis=1)
    assert (np.sort(np.take_along_axis(flat, order, 1), 1)
            == runs["ref"]["2x2x2/serve/ties/d2"]).all()
    assert (flat_ids != want).any()


@pytest.mark.parametrize("case", sorted(ASSIGN))
@pytest.mark.parametrize("m", sorted(MESHES))
def test_assign_step_matches_reference(runs, m, case):
    """Ids equal to the reference's (duplicate aggregation points in two
    model blocks go to the lower global id), d2 within 1e-5 relative
    (``cdist2``'s expanded form on both sides); each rank's block is its
    rows of the gathered result."""
    p = f"{m}/assign/{case}/"
    want_ids, want_d2 = runs["ref"][p + "ids"], runs["ref"][p + "d2"]
    for port in runs["port"]:
        np.testing.assert_array_equal(port[p + "ids"], want_ids)
        np.testing.assert_allclose(port[p + "d2"], want_d2, rtol=1e-5,
                                   atol=1e-5)
        lo, hi = port[p + "block"]
        np.testing.assert_array_equal(port[p + "own_ids"], want_ids[lo:hi])
        np.testing.assert_array_equal(port[p + "own_d2"],
                                      port[p + "d2"][lo:hi])
    if case == "dup":
        # point M/2 + 2j repeats point j: where a list holds both, the
        # lower id comes first, and some lists do
        both = 0
        for j, b in enumerate(range(M_AGG // 2, M_AGG, 2)):
            for row in want_ids:
                if j in row and b in row:
                    both += 1
                    assert list(row).index(j) < list(row).index(b)
        assert both > 0


@pytest.mark.parametrize("m", sorted(MESHES))
def test_mesh_rank_order_matches_jax_make_mesh(runs, m):
    """Rank r sits where ``jax.make_mesh`` puts device r, and the axis
    sizes agree (the (4, 2) mesh through ``make_local_mesh``)."""
    devices = runs["ref"][f"{m}/devices"]
    for r, port in enumerate(runs["port"]):
        assert devices[tuple(port[f"{m}/coords"])] == r
        np.testing.assert_array_equal(port[f"{m}/sizes"], devices.shape)


def test_production_mesh_refuses_a_world_of_the_wrong_size(runs):
    for port in runs["port"]:
        assert "256 ranks" in str(port["production/False"])
        assert "512 ranks" in str(port["production/True"])
    with pytest.raises(RuntimeError, match="init_ranks"):
        port_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="init_ranks"):
        port_mesh.make_local_mesh(2)


def test_a_world_of_one_equals_the_direct_kernel_calls(runs):
    """On a 1 x 1 gloo mesh the serve step is ``l2_topk_masked`` cut to
    min(k, C) columns and the assign step ``l2_topk``, bit for bit."""
    one = runs["port"][0]
    np.testing.assert_array_equal(one["one/serve"],
                                  one["one/serve_direct"][:, :, :8])
    np.testing.assert_array_equal(one["one/assign"], one["one/assign_direct"])


def test_stable_topk_keeps_jax_top_k_order():
    """Ties, repeated ids and a width below k, as ``jax.lax.top_k(-d2)``
    orders them."""
    rng = np.random.default_rng(1)
    d2 = rng.integers(0, 4, (32, 24)).astype(np.float32)
    ids = rng.integers(0, 100, (32, 24)).astype(np.int32)
    for k in (5, 24, 40):
        neg, pos = jax.lax.top_k(-d2, min(k, 24))
        got_d2, got_ids = pd.stable_topk(torch.from_numpy(d2),
                                         torch.from_numpy(ids), k)
        np.testing.assert_array_equal(got_d2.numpy(), -np.asarray(neg))
        np.testing.assert_array_equal(
            got_ids.numpy(), np.take_along_axis(ids, np.asarray(pos), 1))


def test_init_ranks_takes_a_named_backend_only():
    with pytest.raises(ValueError, match="backend"):
        compat.init_ranks("mpi", "file:///nonexistent", 0, 1)
    with pytest.raises(ValueError, match="own CUDA device"):
        compat.init_ranks("nccl", "file:///nonexistent", 0, 1,
                          device="cpu")
    compat.shutdown()   # nothing to leave: a no-op


def test_assign_step_keeps_the_reference_limits():
    """Chunks that do not divide their blocks, or a column chunk below k,
    are refused before any collective."""
    fake = port_mesh.Mesh(("data", "model"), (1, 1), (0, 0), {})
    res, agg = torch.zeros(48, 4), torch.zeros(64, 4)
    with pytest.raises(ValueError, match="divide"):
        pd.make_anns_assign_step(fake, k=4, row_chunk=32)(res, agg)
    with pytest.raises(ValueError, match="divide"):
        pd.make_anns_assign_step(fake, k=4, col_chunk=48)(res[:32], agg)
    with pytest.raises(ValueError, match="fewer than k"):
        pd.make_anns_assign_step(fake, k=8, col_chunk=4)(res[:32], agg)
