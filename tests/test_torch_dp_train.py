"""Training across ``torch.distributed`` ranks (``training/train_step.py``
under the mesh context, ``launch/train.py``'s setup on a process group)
against the reference's jitted ``make_train_step`` under ``mesh_context``,
on the same seeded numpy weights and batches.

The reference runs every case in one JAX subprocess on 8 forced host
devices (meshes of ``AxisType.Auto`` axes, the params placed by
``param_shardings``, the batch by ``batch_spec``); the port in one set of
gloo rank processes a world size (4 and 8, ``file://`` rendezvous), each
rank called with its ``batch_spec`` block of the batch and holding its
blocks of the experts (``carry.lm_params_from_arrays(..., mesh=)``).
Two steps a case; after each, every rank's loss, aux loss and
``grad_norm``, its block of every parameter (``lm_params_from_arrays``
of the reference's at the rank's coordinates) and of ``m`` and ``v``
(``opt_state_from_arrays(..., mesh=)``) are held to the reference's with
``tests/test_torch_train.py``'s tolerances and its one-in-a-thousand
rule. Float32.

Cases: TinyLlama REDUCED (dense) on (data 4, model 1) through
``launch/train.py``'s setup; DBRX REDUCED with a factored second moment
(``min_dim_size_to_factor`` 48: an expert block's ``d`` of 32 or 16
still factors, as the global 64 does) on (2, 2), (1, 4) and (2, 2, 2)
with and without ``fsdp_over_pod``; at capacity 1.0 (drops) on (2, 2)
and on (4, 1), the local path under data parallelism; two microbatches
on (2, 2); a batch of one (replicated); labels masked unevenly between
the data ranks (the global denominator).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_torch_train as base  # noqa: E402
from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch.carry import (  # noqa: E402
    lm_params_from_arrays,
    opt_state_from_arrays,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 24
STEPS = 2
OCFG = dict(lr=base.LR, warmup_steps=1, total_steps=10)
FACTORED = dict(factored=True, min_dim_size_to_factor=48)
D2 = ((2, 2), ("data", "model"))
# name: (world, (mesh shape, axis names), DistConfig kwargs, arch, config
# changes, B, microbatches, labels)
CASES = {
    "dense-4x1": (4, ((4, 1), ("data", "model")), {}, "tinyllama-1.1b",
                  {}, 4, 1, "even"),
    "dbrx-2x2": (4, D2, {}, "dbrx-132b", {}, 4, 1, "even"),
    "dbrx-1x4": (4, ((1, 4), ("data", "model")), {}, "dbrx-132b", {}, 4, 1,
                 "even"),
    "dbrx-2x2-drops": (4, D2, {}, "dbrx-132b", {"capacity_factor": 1.0}, 4,
                       1, "even"),
    "dbrx-4x1-drops": (4, ((4, 1), ("data", "model")), {}, "dbrx-132b",
                       {"capacity_factor": 1.0}, 4, 1, "even"),
    "dbrx-2x2-micro2": (4, D2, {}, "dbrx-132b", {}, 4, 2, "even"),
    "dbrx-2x2-replicated": (4, D2, {}, "dbrx-132b", {}, 1, 1, "even"),
    "dbrx-2x2-uneven": (4, D2, {}, "dbrx-132b", {}, 4, 1, "uneven"),
    "dbrx-2x2x2": (8, ((2, 2, 2), ("pod", "data", "model")), {},
                   "dbrx-132b", {}, 4, 1, "even"),
    "dbrx-2x2x2-fsdp_pod": (8, ((2, 2, 2), ("pod", "data", "model")),
                            {"fsdp_over_pod": True}, "dbrx-132b", {}, 4, 1,
                            "even"),
}
METRICS = ("loss", "aux_loss", "grad_norm", "total_loss", "lr")
# the reference's cases go to this many JAX processes at once (its
# compiles are most of the file's time)
REF_PROCS = 4


def _ocfg(arch):
    return dict(OCFG, **(FACTORED if arch == "dbrx-132b" else {}))


def _cfg(get, arch, changes):
    return dataclasses.replace(get(arch, reduced=True), dtype="float32",
                               **changes)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _inputs():
    """Each arch's weights (``test_torch_train._weights``: norms
    perturbed) and each case's STEPS batches, as flat numpy."""
    x = {}
    for arch in sorted({c[3] for c in CASES.values()}):
        x.update(_flatten(base._weights(_cfg(ref_get_config, arch, {})),
                          f"weights/{arch}/"))
    for name, (_, (shape, _), _, arch, changes, b, _, labels) in \
            CASES.items():
        cfg = _cfg(ref_get_config, arch, changes)
        for i in range(STEPS):
            batch = base._batch(cfg, b=b, s=S, seed=10 * i + len(name))
            if labels == "uneven":   # the first data block mostly masked
                batch["labels"][:b // shape[0], :S - 4] = -1
            x.update(_flatten(batch, f"batch/{name}/{i}/"))
    return x


_REFERENCE = r"""
import dataclasses, math, sys
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
import numpy as np
from repro.configs import get_config
from repro.distributed.context import mesh_context
from repro.distributed.sharding import DistConfig, batch_spec, param_shardings
from repro.training.optimizer import OptimizerConfig, init_state
from repro.training.train_step import TrainConfig, make_train_step
cases, ocfgs, steps, out, part = eval(sys.argv[1]), eval(sys.argv[2]), \
    int(sys.argv[3]), sys.argv[4], sys.argv[5]
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

def flatten(tree, prefix):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flatten(v, f"{prefix}{k}/"))
        else:
            res[prefix + k] = np.asarray(v)
    return res

res = {}
for name, (world, (shape, names), dist_kw, arch, changes, b, n, _) in \
        cases.items():
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", **changes)
    ocfg = OptimizerConfig(**ocfgs[arch])
    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:math.prod(shape)])
    dist = DistConfig(**dist_kw)
    with mesh_context(mesh, dist):
        params = unflatten(f"weights/{arch}/")
        params = jax.device_put(params, param_shardings(params, mesh, dist))
        state = init_state(params, ocfg)
        step = jax.jit(make_train_step(cfg, ocfg, TrainConfig(microbatches=n)))
        bs = NamedSharding(mesh, P(*batch_spec(b, mesh)))
        for i in range(steps):
            batch = {k: jax.device_put(v, bs)
                     for k, v in unflatten(f"batch/{name}/{i}/").items()}
            params, state, m = step(params, state, batch)
            res.update(flatten(m, f"{name}/{i}/metrics/"))
            res.update(flatten(params, f"{name}/{i}/p/"))
            res.update(flatten(state, f"{name}/{i}/state/"))
np.savez(out + f"/reference{part}.npz", **res)
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
from repro_torch.launch import train as trainer
from repro_torch.models.moe import block_specs
from repro_torch.training.optimizer import OptimizerConfig, init_state
from repro_torch.training.train_step import TrainConfig, make_train_step
torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cases, ocfgs, steps = eval(sys.argv[4]), eval(sys.argv[5]), int(sys.argv[6])
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

def batch_of(name, i):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v)
            for k, v in unflatten(f"batch/{name}/{i}/").items()}

res = {}
compat.init_ranks("gloo", f"file://{out}/rendezvous{world}", rank, world)
for name, (_, (shape, names), dist_kw, arch, changes, b, n, _) in \
        cases.items():
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", **changes)
    ocfg = ocfgs[arch]
    weights = unflatten(f"weights/{arch}/")
    if name.startswith("dense"):
        # launch/train.py's setup on the process group: its (data, model)
        # mesh, its step taking the whole batch; the reference's weights
        args = trainer.parser().parse_args([
            "--batch", str(b), "--seq", str(x[f"batch/{name}/0/tokens"]
                                            .shape[1]),
            "--steps", str(ocfg["total_steps"]), "--lr", str(ocfg["lr"]),
            "--microbatches", str(n), "--device", "cpu",
            "--model-axis", str(shape[-1])])
        _, _, model, state, step_fn = trainer.setup(args, cfg=cfg)
        carried = dict(lm_params_from_arrays(
            cfg, weights, "cpu", mesh=model.mesh, dist=model.dist)
            .named_parameters())
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(carried[k])
        run = lambda i: step_fn(model, state, batch_of(name, i))
    else:
        mesh = pm.make_mesh(shape, names)
        dist = shd.DistConfig(**dist_kw)
        model = lm_params_from_arrays(cfg, weights, "cpu", mesh=mesh,
                                      dist=dist).requires_grad_()
        oc = OptimizerConfig(**ocfg)
        state = init_state(dict(model.named_parameters()), oc, mesh,
                           block_specs(model))
        step = make_train_step(cfg, oc, TrainConfig(microbatches=n))
        spec = shd.batch_spec(b, mesh, dist)

        def run(i):
            block = {k: shd.local_block(v, spec, mesh)
                     for k, v in batch_of(name, i).items()}
            with mesh_context(mesh, dist, batch=b):
                return step(model, state, block)
    for i in range(steps):
        _, state, m = run(i)
        for k, v in m.items():
            res[f"{name}/{i}/metrics/{k}"] = np.asarray(float(v))
        for k, p in model.named_parameters():
            res[f"{name}/{i}/p/{k}"] = p.detach().numpy().copy()
        res[f"{name}/{i}/step"] = np.asarray(int(state["step"]))
        for what in ("m", "v"):
            for k, t in state[what].items():
                parts = t.items() if isinstance(t, dict) else [("", t)]
                for sub, u in parts:
                    key = f"{name}/{i}/{what}/{k}" + (f".{sub}" if sub
                                                      else "")
                    res[key] = u.detach().numpy().copy()
compat.shutdown()
np.savez(out + f"/port{world}_{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides on every case: {"x", "ref", "port": {world: [ranks]}}."""
    out = tmp_path_factory.mktemp("dp_train")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    (out / "reference.py").write_text(_REFERENCE)
    (out / "port.py").write_text(_PORT)
    ocfgs = {arch: _ocfg(arch) for arch in {c[3] for c in CASES.values()}}
    names = sorted(CASES)
    refs = [subprocess.Popen(
        [sys.executable, str(out / "reference.py"),
         repr({k: CASES[k] for k in names[j::REF_PROCS]}), repr(ocfgs),
         str(STEPS), str(out), str(j)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for j in range(REF_PROCS)]
    worlds = sorted({c[0] for c in CASES.values()})
    procs = [subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(r), str(w), str(out),
         repr({k: c for k, c in CASES.items() if c[0] == w}), repr(ocfgs),
         str(STEPS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for w in worlds for r in range(w)]
    for p in refs + procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    ref = {}
    for j in range(REF_PROCS):
        ref.update(np.load(out / f"reference{j}.npz"))
    return {"x": x, "ref": ref,
            "port": {w: [dict(np.load(out / f"port{w}_{r}.npz"))
                         for r in range(w)] for w in worlds}}


def _fake_mesh(shape, names, rank):
    """The mesh of ``rank`` (row-major, as ``launch.mesh`` lays ranks
    out), with no process groups: for the blocks' specs alone."""
    return Mesh(names, shape,
                tuple(int(c) for c in np.unravel_index(rank, shape)), {})


def _rank_trees(port, case, i):
    def pick(what):
        prefix = f"{case}/{i}/{what}/"
        return {k[len(prefix):]: v for k, v in port.items()
                if k.startswith(prefix)}
    return pick("p"), pick("m"), pick("v")


def _assemble(ranks, meshes, whole, spec_of):
    """Each tensor whole from the ranks' blocks ({name: [the rank's
    array]}), the ranks that hold the same block holding the same bits;
    ``spec_of(name)``: its spec (None: whole on every rank, taken from the
    first rank)."""
    out = {}
    for name, w in whole.items():
        spec = spec_of(name)
        if spec is None:
            out[name] = ranks[0][name]
            continue
        full = np.full(w.size, np.nan, np.float32)
        index = torch.arange(w.size).view(w.shape)
        for mesh, tree in zip(meshes, ranks):
            at = shd.local_block(index, spec, mesh).reshape(-1).numpy()
            got = tree[name].reshape(-1)
            seen = ~np.isnan(full[at])
            np.testing.assert_array_equal(full[at][seen], got[seen],
                                          err_msg=name)
            full[at] = got
        out[name] = full.reshape(w.shape)
    return out


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_on_ranks_matches_the_reference(runs, case, i):
    """After step i, each rank's metrics, and the parameters and moments
    assembled from the ranks' blocks (the ranks holding a block holding
    the same bits), are the reference's, the one-in-a-thousand rule over
    each whole array; the ranks hold the same bits of every whole
    parameter."""
    world, (shape, names), dist_kw, arch, changes, _, _, _ = CASES[case]
    cfg = _cfg(get_config, arch, changes)
    dist = shd.DistConfig(**dist_kw)
    ref = runs["ref"]
    want_p = _unflatten(ref, f"{case}/{i}/p/")
    want_state = _unflatten(ref, f"{case}/{i}/state/")
    ranks = runs["port"][world]
    for r, port in enumerate(ranks):
        for key in METRICS:
            np.testing.assert_allclose(
                port[f"{case}/{i}/metrics/{key}"],
                ref[f"{case}/{i}/metrics/{key}"],
                rtol=base.LOSS_RTOL if "loss" in key else 1e-4,
                atol=1e-7, err_msg=f"{case} rank {r} {key}")
        assert int(port[f"{case}/{i}/step"]) == i + 1
    meshes = [_fake_mesh(shape, names, r) for r in range(world)]
    blocks = moe.block_specs(lm_params_from_arrays(
        cfg, want_p, "cpu", mesh=meshes[0], dist=dist))
    want = base._port_flat(dict(lm_params_from_arrays(
        cfg, want_p, "cpu").named_parameters()))
    st = opt_state_from_arrays(cfg, want_state, "cpu")

    def spec_of(name):
        stem, _, sub = name.rpartition(".")
        if sub in ("row", "col") and stem in blocks:
            return shd.stat_spec(blocks[stem], sub)
        return blocks.get(name)
    trees = [_rank_trees(port, case, i) for port in ranks]
    for j, (what, whole, tol, kw) in enumerate((
            ("p", want, base.PARAM_TOL, base._param_outliers(i + 1)),
            ("m", base._port_flat(st["m"]), base.STEP_TOL,
             base.MOMENT_OUTLIERS),
            ("v", base._port_flat(st["v"]), base.STEP_TOL,
             base.MOMENT_OUTLIERS))):
        got = _assemble([t[j] for t in trees], meshes, whole, spec_of)
        base._assert_trees(got, whole, tol, f"{case} {what}", **kw)
    for r, (got_p, _, _) in enumerate(trees):
        for k, v in got_p.items():
            if k not in blocks:
                np.testing.assert_array_equal(
                    v, ranks[0][f"{case}/{i}/p/{k}"], err_msg=(r, k))


def test_the_expert_blocks_factor_where_the_global_weight_does(runs):
    """On (2, 2, 2) with ``fsdp_over_pod`` an expert block's ``d`` is 16,
    under ``min_dim_size_to_factor``; its second moment factors all the
    same, as the reference's global [4, 64, 96] does."""
    port = runs["port"][8][0]
    key = "dbrx-2x2x2-fsdp_pod/0/v/blocks.0.moe.w_gate"
    assert port[f"{key}.row"].shape == (2, 16)
    assert port[f"{key}.col"].shape == (2, 96)
    assert 16 < FACTORED["min_dim_size_to_factor"] <= 64


def test_opt_state_from_arrays_gives_each_rank_its_blocks():
    """The reference's factored AdamW state of DBRX REDUCED (random
    moments), carried to each rank of (data 2, model 2) with ``mesh=``:
    the blocks reassemble to the unsharded carry, m and the factored
    statistics alike."""
    rcfg = _cfg(ref_get_config, "dbrx-132b", {})
    cfg = _cfg(get_config, "dbrx-132b", {})
    params = R.init_params(jax.random.PRNGKey(0), rcfg)
    state = ref_opt.init_state(params, ref_opt.OptimizerConfig(
        **_ocfg("dbrx-132b")))
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda a: rng.random(np.shape(a)).astype(
        np.float32) if np.ndim(a) else np.asarray(a), state)
    whole = opt_state_from_arrays(cfg, state, "cpu")
    (shape, names), dist = D2, shd.DistConfig()
    meshes = [_fake_mesh(shape, names, r) for r in range(4)]
    ranks = [opt_state_from_arrays(cfg, state, "cpu", mesh=m)
             for m in meshes]
    specs = moe.block_specs(lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), "cpu", mesh=meshes[0]))
    assert any(".moe.w_" in n for n in specs) and "tok_embed" in specs
    for name, spec in specs.items():
        if isinstance(whole["v"][name], dict):
            # the reference's spec of each statistic is the block's
            leaf = shd.reference_path(name)[0]
            for sub in ("row", "col"):
                assert shd.stat_spec(spec, sub) == shd.spec_for_leaf(
                    leaf + (sub,), tuple(whole["v"][name][sub].shape),
                    meshes[0], dist, stacked=False), (name, sub)
            vs = [("v", sub, shd.stat_spec(spec, sub))
                  for sub in ("row", "col")]
        else:
            vs = [("v", None, spec)]
        for what, sub, sp in [("m", None, spec)] + vs:
            full = whole[what][name] if sub is None \
                else whole[what][name][sub]
            # each rank's block goes where its spec places it
            out = torch.full_like(full, float("nan"))
            index = torch.arange(full.numel()).view(full.shape)
            for mesh, st in zip(meshes, ranks):
                got = st[what][name] if sub is None else st[what][name][sub]
                out.view(-1)[shd.local_block(index, sp, mesh).reshape(-1)] \
                    = got.reshape(-1)
            assert torch.equal(out, full), (name, what, sub)
    for name in set(whole["m"]) - set(specs):
        for st in ranks:
            assert torch.equal(st["m"][name], whole["m"][name])
