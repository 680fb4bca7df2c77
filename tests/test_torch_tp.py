"""Tensor-parallel and FSDP placement of every family's weights and of
the decode cache (``models/model.py`` and ``models/ssm.py`` under
``mesh_context``) against the reference's jitted steps with its params
under ``param_shardings``, on the same seeded numpy weights and inputs.

The reference runs every case in one JAX subprocess on 8 forced host
devices (meshes of ``AxisType.Auto`` axes); the port in one set of gloo
rank processes, a world of 4 and then of 2 (``file://`` rendezvous),
each rank holding its blocks (``carry.lm_params_from_arrays(...,
mesh=)``) and called with its ``batch_spec`` block of the batch. All
float32 REDUCED configs.

Cases:
(a) a model seeded under a mesh holds, for every parameter, the block
    ``local_block`` cuts from the unsharded model of the same seed (the
    SSD's ``in_proj`` and conv per part: mamba2, hymba and whisper
    beside the dense, moe and vlm archs);
(b) forward logits (gathered over the vocabulary blocks) within 1e-5 of
    the reference's: TinyLlama on (1, 2) and (2, 2); qwen1.5-4b (5
    heads) on (1, 2), attention replicated over ``model``; DBRX with its
    experts on (2, 2); InternVL2 with vision embeddings on (1, 2);
    mamba2 on (1, 2) and (2, 2) (its 8 SSD heads split: case 1 of
    ``models/ssm.py``); hymba on (1, 2); whisper on (1, 2) with frames
    (the encoder and the cross-attention placed);
(c) a prefill and 4 greedy decode steps: heads and kv heads split
    (TinyLlama (1, 2)), heads split while the slots go over ``model``
    (TinyLlama (1, 4): 2 kv heads), attention replicated with the slots
    over ``model`` (qwen (1, 2)), and the slots over the data axes (a
    batch of one on (2, 1) and (2, 2)); mamba2 on (1, 2) (the SSD state
    by heads, the conv window by channels), hymba on (1, 4) (2 kv heads:
    its slots and 8 meta tokens over ``model``), whisper on (1, 2)
    (``xk``/``xv`` by their own spec) and hymba's batch of one on (2, 1):
    ``Engine.generate``'s tokens equal to the reference's greedy tokens,
    every step's logits (fed the reference's tokens) within 1e-5, the
    cache in ``cache_spec``'s layout;
(d) two train steps on (2, 2) (TinyLlama, a padded vocabulary of 500 in
    512; mamba2) and (1, 2) (qwen; hymba): loss and grad norm, and the
    parameters and moments gathered whole, held as
    ``tests/test_torch_dp_train.py`` holds them;
(e) the vocab-parallel loss and z-loss and their gradient against the
    whole-vocabulary ``cross_entropy``, padded vocabulary included;
(f) ``launch/train.py --ckpt-dir`` on (2, 2): a run resumed from step 2
    takes the step the unbroken run took, and the checkpoint loads whole
    into a model on one device;
(g) the SSD's case 2 (its heads whole, its channels split): hymba with
    ``d_model`` 48 and ``ssm_head_dim`` 32 (3 heads, an ``in_proj`` of
    211 columns, 112 conv channels) on (1, 2), forward and two train
    steps.

Only the train cases tell the SSD's backward rules apart (the forward
is the same either way): on a copy of the port, case (g)'s steps fail
without the ``copy_over`` on the normed output or on the conv's input,
or with the conv gather's gradient summed (``gather_axis`` for
``gather_own``); mamba2's (2, 2) steps fail without the ``copy_over``
of ``A_log``, ``D`` and ``dt_bias`` (case 1) or of the norm's sum of
squares (case 3).
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_torch_train as base  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro_torch.carry import (  # noqa: E402
    lm_params_from_arrays,
    opt_state_from_arrays,
)
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    OptimizerConfig,
    init_state,
)
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig,
    make_train_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 15
NEW = 5           # generated tokens: the prefill's and 4 decode steps'
SLOTS = S + NEW   # the cache's: 20 divide over 4 and 2 ranks
STEPS = 2
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
OCFG = dict(lr=base.LR, warmup_steps=1, total_steps=10)
HEADS3 = {"d_model": 48, "ssm_head_dim": 32}
# name: (kind, world, mesh shape (data, model), arch, config changes, B)
CASES = {
    "fwd/tinyllama-1x2": ("forward", 2, (1, 2), "tinyllama-1.1b", {}, 2),
    "fwd/tinyllama-2x2": ("forward", 4, (2, 2), "tinyllama-1.1b", {}, 4),
    "fwd/qwen-1x2": ("forward", 2, (1, 2), "qwen1.5-4b", {}, 2),
    "fwd/dbrx-2x2": ("forward", 4, (2, 2), "dbrx-132b", {}, 4),
    "fwd/internvl2-1x2": ("forward", 2, (1, 2), "internvl2-76b", {}, 2),
    "dec/tinyllama-1x2": ("decode", 2, (1, 2), "tinyllama-1.1b", {}, 2),
    "dec/tinyllama-1x4": ("decode", 4, (1, 4), "tinyllama-1.1b", {}, 2),
    "dec/qwen-1x2": ("decode", 2, (1, 2), "qwen1.5-4b", {}, 2),
    "dec/tinyllama-2x1-b1": ("decode", 2, (2, 1), "tinyllama-1.1b", {}, 1),
    "dec/tinyllama-2x2-b1": ("decode", 4, (2, 2), "tinyllama-1.1b", {}, 1),
    "train/tinyllama-2x2-v500": ("train", 4, (2, 2), "tinyllama-1.1b",
                                 {"vocab_size": 500}, 4),
    "train/qwen-1x2": ("train", 2, (1, 2), "qwen1.5-4b", {}, 2),
    # the ssm, hybrid and audio families: mamba2's 8 SSD heads split
    # (case 1), hymba's 4 query and 2 kv heads, whisper's encoder and
    # cross-attention
    "fwd/mamba2-1x2": ("forward", 2, (1, 2), "mamba2-370m", {}, 2),
    "fwd/mamba2-2x2": ("forward", 4, (2, 2), "mamba2-370m", {}, 4),
    "fwd/hymba-1x2": ("forward", 2, (1, 2), "hymba-1.5b", {}, 2),
    "fwd/whisper-1x2": ("forward", 2, (1, 2), "whisper-small", {}, 2),
    "dec/mamba2-1x2": ("decode", 2, (1, 2), "mamba2-370m", {}, 2),
    "dec/hymba-1x4": ("decode", 4, (1, 4), "hymba-1.5b", {}, 2),
    "dec/whisper-1x2": ("decode", 2, (1, 2), "whisper-small", {}, 2),
    "dec/hymba-2x1-b1": ("decode", 2, (2, 1), "hymba-1.5b", {}, 1),
    "train/mamba2-2x2": ("train", 4, (2, 2), "mamba2-370m", {}, 4),
    "train/hymba-1x2": ("train", 2, (1, 2), "hymba-1.5b", {}, 2),
    # case 2 on the CPU: 3 SSD heads (d_inner 96 of ssm_head_dim 32) do
    # not divide model 2, nor does in_proj (211 columns); the conv's 112
    # channels (96 + 8 + 8) and d_inner do
    "fwd/hymba-3heads-1x2": ("forward", 2, (1, 2), "hymba-1.5b",
                             HEADS3, 2),
    "train/hymba-3heads-1x2": ("train", 2, (1, 2), "hymba-1.5b", HEADS3,
                               2),
    # the factored second moment at REDUCED sizes: in_proj's column
    # statistic per part, and the stacked [L, d] vectors whose d the mesh
    # splits (conv_b per part, ssm_norm) factored across the layers
    "train/mamba2-2x2-factored": ("train", 4, (2, 2), "mamba2-370m", {}, 4),
}
# optimizer config changes of a case
OPT_CHANGES = {"train/mamba2-2x2-factored": {"factored": True,
                                             "min_dim_size_to_factor": 2}}
# (a): the archs seeded on every mesh of the port's worlds
SEEDED = ("tinyllama-1.1b", "qwen1.5-4b", "dbrx-132b", "kimi-k2-1t-a32b",
          "internvl2-76b", "command-r-plus-104b", "mamba2-370m",
          "hymba-1.5b", "whisper-small")
METRICS = ("loss", "grad_norm", "total_loss")


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
    """Each case's weights (``test_torch_train._weights``: norms and
    biases perturbed) and batches, as flat numpy."""
    x = {}
    for name, (kind, _, _, arch, changes, b) in CASES.items():
        cfg = _cfg(ref_get_config, arch, changes)
        x.update(_flatten(base._weights(cfg, seed=len(name)),
                          f"weights/{name}/"))
        for i in range(STEPS if kind == "train" else 1):
            batch = base._batch(cfg, b=b, s=S, seed=10 * i + len(name))
            if kind != "train":
                del batch["labels"]
            x.update(_flatten(batch, f"batch/{name}/{i}/"))
    return x


_REFERENCE = r"""
import dataclasses, math, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
import numpy as np
from repro import models as R
from repro.configs import get_config
from repro.distributed.context import mesh_context
from repro.distributed.sharding import batch_spec, param_shardings
from repro.training.optimizer import OptimizerConfig, init_state
from repro.training.train_step import TrainConfig, make_train_step
cases, ocfg, steps, new, out = eval(sys.argv[1]), eval(sys.argv[2]), \
    int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
S, opt_changes = int(sys.argv[6]), eval(sys.argv[7])
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
for name, (kind, _, shape, arch, changes, b) in cases.items():
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", **changes)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])
    with mesh_context(mesh):
        params = unflatten(f"weights/{name}/")
        params = jax.device_put(params, param_shardings(params, mesh))

        def put(batch):
            return {k: jax.device_put(v, NamedSharding(mesh, P(*batch_spec(
                b, mesh, extra_dims=v.ndim - 1)))) for k, v in batch.items()}
        if kind == "forward":
            batch = put(unflatten(f"batch/{name}/0/"))
            res[f"{name}/logits"] = np.asarray(jax.jit(
                lambda p, bt: R.forward(p, bt, cfg))(params, batch))
        elif kind == "decode":
            batch = put(unflatten(f"batch/{name}/0/"))
            logits, cache = jax.jit(lambda p, bt: R.prefill(
                p, bt, cfg, max_len=S + new))(params, batch)
            step = jax.jit(lambda p, t, c, pos: R.decode_step(p, t, c, pos,
                                                              cfg))
            tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], -1)
            toks, outs = [tok], []
            for i in range(new - 1):
                logits, cache = step(params, tok, cache,
                                     jnp.asarray(S + i, jnp.int32))
                outs.append(np.asarray(logits))
                tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], -1)
                toks.append(tok)
            res[f"{name}/tokens"] = np.concatenate(
                [np.asarray(t) for t in toks], 1)
            res[f"{name}/step_logits"] = np.stack(outs)
        else:
            oc = OptimizerConfig(**ocfg, **opt_changes.get(name, {}))
            state = init_state(params, oc)
            step = jax.jit(make_train_step(cfg, oc, TrainConfig()))
            for i in range(steps):
                batch = put(unflatten(f"batch/{name}/{i}/"))
                params, state, m = step(params, state, batch)
                res.update(flatten(m, f"{name}/{i}/metrics/"))
                res.update(flatten(params, f"{name}/{i}/p/"))
                res.update(flatten(state, f"{name}/{i}/state/"))
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
from repro_torch.launch import train as trainer
from repro_torch.models.model import (decode_step, forward, gather_vocab,
                                      init_params, prefill)
from repro_torch.models.moe import block_specs
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.training.optimizer import OptimizerConfig, init_state
from repro_torch.training.train_step import (TrainConfig, cross_entropy,
                                             make_train_step)
torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
cases, ocfg, steps, new, seeded = (eval(a) for a in sys.argv[3:8])
S, opt_changes = int(sys.argv[8]), eval(sys.argv[9])
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

def tensors(prefix):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in unflatten(prefix).items()}

def block(batch, b, mesh):
    return {k: shd.local_block(v, shd.batch_spec(b, mesh,
                                                 extra_dims=v.dim() - 1),
                               mesh) for k, v in batch.items()}

res = {}
for world in (4, 2):
    if rank >= world:
        break
    compat.init_ranks("gloo", f"file://{out}/rendezvous{world}", rank, world)
    meshes = {}
    for name, (kind, w, shape, arch, changes, b) in cases.items():
        if w != world:
            continue
        if shape not in meshes:
            meshes[shape] = pm.make_mesh(shape, ("data", "model"))
        mesh = meshes[shape]
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32", **changes)
        model = lm_params_from_arrays(cfg, unflatten(f"weights/{name}/"),
                                      "cpu", mesh=mesh)
        if kind == "forward":
            batch = block(tensors(f"batch/{name}/0/"), b, mesh)
            with mesh_context(mesh, batch=b), torch.no_grad():
                res[f"{name}/logits"] = gather_vocab(
                    model, forward(model, batch, cfg)).numpy()
        elif kind == "decode":
            batch = block(tensors(f"batch/{name}/0/"), b, mesh)
            ref_tokens = block({"t": torch.from_numpy(
                x[f"ref/{name}/tokens"]).long()}, b, mesh)["t"]
            with mesh_context(mesh, batch=b):
                res[f"{name}/tokens"] = Engine(cfg, model, ServeConfig(
                    max_new_tokens=new)).generate(batch)
                with torch.no_grad():
                    _, cache = prefill(model, batch, cfg, max_len=S + new)
                    outs = []
                    for i in range(new - 1):
                        logits, cache = decode_step(
                            model, ref_tokens[:, i:i + 1], cache, S + i, cfg)
                        outs.append(gather_vocab(model, logits).numpy())
                res[f"{name}/step_logits"] = np.stack(outs)
                for key, first, axes in (
                        ("k", cache.first_slot, cache.seq_axes),
                        ("xk", cache.x_first_slot, cache.x_seq_axes)):
                    if key in cache:
                        res[f"{name}/cache/{key}"] = np.array(
                            [first, *cache[key].shape[2:4]])
                        res[f"{name}/seq_axes/{key}"] = np.array(
                            ",".join(axes))
                if "h" in cache:
                    res[f"{name}/cache/ssm"] = np.array(
                        [cache["h"].shape[2], cache["conv"].shape[3]])
        else:
            model.requires_grad_()
            oc = OptimizerConfig(**ocfg, **opt_changes.get(name, {}))
            specs = block_specs(model)
            state = init_state(dict(model.named_parameters()), oc, mesh,
                               specs)
            step = make_train_step(cfg, oc, TrainConfig())
            for i in range(steps):
                batch = block(tensors(f"batch/{name}/{i}/"), b, mesh)
                with mesh_context(mesh, batch=b):
                    _, state, m = step(model, state, batch)
                for k, v in m.items():
                    res[f"{name}/{i}/metrics/{k}"] = np.asarray(float(v))
                p, st = trainer.whole_state(dict(model.named_parameters()),
                                            state, specs, mesh)
                for k, t in p.items():
                    res[f"{name}/{i}/p/{k}"] = t.detach().numpy().copy()
                for what in ("m", "v"):
                    for k, t in st[what].items():
                        for sub, u in (t.items() if isinstance(t, dict)
                                       else [("", t)]):
                            key = f"{name}/{i}/{what}/{k}" + (
                                f".{sub}" if sub else "")
                            res[key] = u.detach().numpy().copy()
    # (a) the seeded model's blocks
    for shape, mesh in meshes.items():
        for arch in seeded:
            cfg = get_config(arch, reduced=True)
            whole = dict(init_params(cfg, 3, "cpu").named_parameters())
            with mesh_context(mesh):
                placed = init_params(cfg, 3, "cpu")
            specs = block_specs(placed)
            ok = all(torch.equal(p, shd.local_block(whole[n], specs[n], mesh)
                                 if n in specs else whole[n])
                     for n, p in placed.named_parameters())
            res[f"seeded/{arch}/{shape}"] = np.array(
                [ok, len(specs), len(whole)])
    if world == 2:   # (e) the vocab-parallel loss on (1, 2)
        mesh = meshes[(1, 2)]
        g = torch.Generator().manual_seed(5)
        vocab, vpad = 500, 512
        logits = torch.randn(3, 7, vpad, generator=g) * 3
        logits[..., vocab:] = -1e30
        labels = torch.randint(-1, vocab, (3, 7), generator=g)
        n = vpad // 2
        v0 = mesh.axis_index("model") * n
        for z in (0.0, 1e-4, 0.1):
            whole = logits.clone().requires_grad_()
            want = cross_entropy(whole, labels, vpad, z)
            want.backward()
            part = logits[..., v0:v0 + n].clone().requires_grad_()
            got = cross_entropy(part, labels, vpad, z, vocab=(mesh, v0))
            got.backward()
            res[f"loss/{z}"] = np.array([float(got), float(want)])
            res[f"loss/{z}/grad"] = (part.grad - whole.grad[
                ..., v0:v0 + n]).abs().max().numpy()
    if world == 4:   # (f) checkpoints through launch/train.py on (2, 2)
        args = trainer.parser().parse_args([
            "--arch", "tinyllama-1.1b", "--steps", "3", "--batch", "4",
            "--seq", str(S), "--device", "cpu", "--model-axis", "2",
            "--ckpt-dir", f"{out}/ckpt", "--ckpt-every", "2"])
        for run in ("unbroken", "resumed"):
            m = trainer.train(args)
            for k, v in m.items():
                res[f"ckpt/{run}/{k}"] = np.asarray(v)
    compat.shutdown()
np.savez(out + f"/port{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides: {"x", "ref", "port": [rank 0..3], "out"}."""
    out = tmp_path_factory.mktemp("tp")
    x = _inputs()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    np.savez(out / "inputs.npz", **x)
    (out / "reference.py").write_text(_REFERENCE)
    (out / "port.py").write_text(_PORT)
    ref = subprocess.run(
        [sys.executable, str(out / "reference.py"), repr(CASES), repr(OCFG),
         str(STEPS), str(NEW), str(out), str(S), repr(OPT_CHANGES)],
        env=env,
        capture_output=True,
        text=True, timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = dict(np.load(out / "reference.npz"))
    # the port's decode steps are fed the reference's greedy tokens
    x.update({f"ref/{k}": v for k, v in want.items()
              if k.endswith("/tokens")})
    np.savez(out / "inputs.npz", **x)
    procs = [subprocess.Popen(
        [sys.executable, str(out / "port.py"), str(r), str(out),
         repr(CASES), repr(OCFG), str(STEPS), str(NEW), repr(SEEDED),
         str(S), repr(OPT_CHANGES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return {"x": x, "ref": want, "out": out,
            "port": [dict(np.load(out / f"port{r}.npz")) for r in range(4)]}


def _ranks(runs, name):
    return runs["port"][:CASES[name][1]]


def _rows(want, b, shape, rank):
    """The rows of the whole batch rank ``rank`` of ``shape`` holds
    (``batch_spec``: a block where the data axes divide B, else all)."""
    dp = shape[0]
    if b % dp:
        return want
    i = rank // shape[1]
    return want[i * (b // dp):(i + 1) * (b // dp)]


@pytest.mark.parametrize("arch", SEEDED)
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 2), (2, 1)])
def test_a_seeded_model_holds_the_blocks_of_the_unsharded_one(runs, arch,
                                                              shape):
    world = math.prod(shape)
    for port in runs["port"][:world]:
        ok, n_blocks, n = port[f"seeded/{arch}/{shape}"]
        assert ok and n_blocks > 0, (arch, shape, n_blocks, n)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("fwd/")])
def test_forward_matches_the_reference_sharded(runs, name):
    _, _, shape, _, _, b = CASES[name]
    want = runs["ref"][f"{name}/logits"]
    for r, port in enumerate(_ranks(runs, name)):
        np.testing.assert_allclose(port[f"{name}/logits"],
                                   _rows(want, b, shape, r), **LOGITS_TOL,
                                   err_msg=f"rank {r}")


# the decode cases' cache layouts (``cache_spec``): {"k" or "xk": (slots
# in all, slots a rank, kv heads a rank, the axes splitting the slots),
# "ssm": (the SSD state's heads a rank, the conv window's channels a
# rank)}; hymba's 8 meta tokens take slots ahead of the tokens', and its
# conv's 144 channels are 128 + 8 + 8
META = 8
LAYOUTS = {"dec/tinyllama-1x2": {"k": (SLOTS, SLOTS, 1, "")},
           "dec/tinyllama-1x4": {"k": (SLOTS, SLOTS // 4, 2, "model")},
           "dec/qwen-1x2": {"k": (SLOTS, SLOTS // 2, 5, "model")},
           "dec/tinyllama-2x1-b1": {"k": (SLOTS, SLOTS // 2, 2, "data")},
           "dec/tinyllama-2x2-b1": {"k": (SLOTS, SLOTS // 2, 1, "data")},
           "dec/mamba2-1x2": {"ssm": (4, 80)},
           "dec/hymba-1x4": {"k": (SLOTS + META, (SLOTS + META) // 4, 2,
                                   "model"), "ssm": (2, 36)},
           "dec/whisper-1x2": {"k": (SLOTS, SLOTS, 2, ""),
                               "xk": (30, 30, 2, "")},
           "dec/hymba-2x1-b1": {"k": (SLOTS + META, (SLOTS + META) // 2, 2,
                                      "data"), "ssm": (8, 144)}}


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("dec/")])
def test_greedy_decode_matches_the_reference_sharded(runs, name):
    """Equal greedy tokens from ``Engine.generate``; every decode step's
    logits (fed the reference's tokens) within 1e-5; the cache in the
    layout ``cache_spec`` gives (the slots over ``model`` or the data
    axes, or the kv heads over ``model``)."""
    _, _, shape, _, _, b = CASES[name]
    ref = runs["ref"]
    for r, port in enumerate(_ranks(runs, name)):
        np.testing.assert_array_equal(
            port[f"{name}/tokens"],
            _rows(ref[f"{name}/tokens"], b, shape, r), err_msg=f"rank {r}")
        np.testing.assert_allclose(
            port[f"{name}/step_logits"],
            np.stack([_rows(s, b, shape, r)
                      for s in ref[f"{name}/step_logits"]]),
            **LOGITS_TOL, err_msg=f"rank {r}")
    port = _ranks(runs, name)
    for key, layout in LAYOUTS[name].items():
        if key == "ssm":
            assert tuple(port[0][f"{name}/cache/ssm"]) == layout
            continue
        total, slots, heads, axes = layout
        assert str(port[0][f"{name}/seq_axes/{key}"]) == axes
        assert tuple(port[0][f"{name}/cache/{key}"][1:]) == (slots, heads)
        firsts = sorted({int(p[f"{name}/cache/{key}"][0]) for p in port})
        assert firsts == list(range(0, total, slots))
    assert {f"{name}/cache/{key}" for key in LAYOUTS[name]} == {
        k for k in port[0] if k.startswith(f"{name}/cache/")}


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("train/")])
def test_train_step_matches_the_reference_sharded(runs, name, i):
    """Each rank's loss and grad norm, and the parameters and moments
    gathered whole on rank 0, are the reference's after step i, with
    ``tests/test_torch_train.py``'s tolerances and its
    one-in-a-thousand rule; qwen's key biases to the outlier bound in
    every element, as ``tests/test_torch_modal_train.py`` holds them."""
    check_train_step(runs, CASES, name, i)


def check_train_step(runs, cases, name, i):
    """Case ``name`` of ``cases`` after step i: each rank's metrics, and
    rank 0's parameters and moments gathered whole, against the
    reference's (``test_train_step_matches_the_reference_sharded``'s
    rules)."""
    _, world, _, arch, changes, _ = cases[name]
    cfg = _cfg(get_config, arch, changes)
    ref = runs["ref"]
    for r, port in enumerate(runs["port"][:world]):
        for key in METRICS:
            np.testing.assert_allclose(
                port[f"{name}/{i}/metrics/{key}"],
                ref[f"{name}/{i}/metrics/{key}"],
                rtol=base.LOSS_RTOL if "loss" in key else 1e-4, atol=1e-7,
                err_msg=f"rank {r} {key}")
    port = runs["port"][0]

    def pick(what):
        prefix = f"{name}/{i}/{what}/"
        return {k[len(prefix):]: v for k, v in port.items()
                if k.startswith(prefix)}
    want_p = dict(lm_params_from_arrays(cfg, _unflatten(
        ref, f"{name}/{i}/p/"), "cpu").named_parameters())
    st = opt_state_from_arrays(cfg, _unflatten(ref, f"{name}/{i}/state/"),
                               "cpu")
    got_p, want_p = pick("p"), base._port_flat(want_p)
    bound = base._param_outliers(i + 1)["outlier_atol"]
    for key in [k for k in want_p if k.endswith(".bk")]:
        # a key bias's gradient cancels: Adam turns each package's f32
        # noise into steps of up to lr (tests/test_torch_modal_train.py)
        err = np.abs(got_p.pop(key) - want_p.pop(key))
        assert (err <= bound).all(), (key, float(err.max()))
    base._assert_trees(got_p, want_p, base.PARAM_TOL, f"{name} p",
                       **base._param_outliers(i + 1))
    for what in ("m", "v"):
        base._assert_trees(pick(what), base._port_flat(st[what]),
                           base.STEP_TOL, f"{name} {what}",
                           **base.MOMENT_OUTLIERS)


@pytest.mark.parametrize("z", [0.0, 1e-4, 0.1])
def test_vocab_parallel_loss_equals_the_whole_vocabulary_loss(runs, z):
    for port in runs["port"][:2]:
        got, want = port[f"loss/{z}"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert float(port[f"loss/{z}/grad"]) < 1e-7


def test_checkpoint_on_a_mesh_resumes_and_loads_whole(runs):
    """Resumed from the step-2 checkpoint the (2, 2) run takes the step
    the unbroken run took, on every rank; the checkpoint, gathered whole
    by rank 0, loads into the model and optimizer state of one device,
    whose next step there agrees with the mesh's to the bf16 rounding of
    the REDUCED config (the batch is ``batch_at``'s step 2)."""
    for port in runs["port"]:
        for key in ("loss", "grad_norm", "total_loss"):
            assert port[f"ckpt/resumed/{key}"] == \
                port[f"ckpt/unbroken/{key}"], key
    args = trainer.parser().parse_args([
        "--arch", "tinyllama-1.1b", "--steps", "3", "--batch", "4",
        "--seq", str(S), "--device", "cpu"])
    cfg, dcfg, model, opt, step = trainer.setup(args)
    params = dict(model.named_parameters())
    ckpt = str(runs["out"] / "ckpt")
    _, saved, _ = load_checkpoint(ckpt + "/p", like=params)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(saved[name])
    _, opt, _ = load_checkpoint(ckpt + "/o", like=opt)
    assert int(opt["step"]) == 2
    _, _, m = step(model, opt, batch_at(dcfg, cfg, 2, device="cpu"))
    np.testing.assert_allclose(float(m["loss"]),
                               runs["port"][0]["ckpt/unbroken/loss"],
                               rtol=2e-2)
