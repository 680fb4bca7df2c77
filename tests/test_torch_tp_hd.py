"""The head-dim placement of attention (``DistConfig(
shard_head_dim_fallback=True)``, ``models/model.py:Attention``) against
the reference's jitted steps under the same ``DistConfig``, its params
under ``param_shardings``, on the same seeded numpy weights and inputs.

``tests/test_torch_tp.py``'s harness, under the flag: one JAX subprocess
on 8 forced host devices runs the reference; one set of gloo rank
processes, a world of 8, then of 4 and of 2, runs the port (each rank holding
its blocks, ``carry.lm_params_from_arrays(..., mesh=, dist=)``). All
float32 REDUCED configs. Two layouts:

* case H, the query heads do not divide ``model``: every attention leaf
  split over the head dim (qwen1.5-4b's 5 heads of 12 dims, with q/k/v
  biases, on (1, 4), (1, 2) and (2, 2); a whisper-small of 3 heads and 3
  kv heads of 16 dims on (1, 4), its encoder and cross-attention too);
* case M, the query heads divide ``model`` and the kv heads do not: ``wq``
  and ``wo`` split over the heads, ``wk``/``wv`` over the head dim
  (TinyLlama's and hymba's 4 heads and 2 kv heads on (1, 4); a TinyLlama
  of 8 heads and 4 kv heads of 16 dims on (1, 8), the layout
  TinyLlama-1.1B's 32 / 4 heads take at model 8; hymba with
  its 8 meta tokens and window of 32; InternVL2's with vision
  embeddings and DBRX's beside its experts, forward only).

Cases: forward logits within 1e-5 (a forward's, or a decode case's
prefill's); a prefill and 4 greedy decode steps
(``Engine.generate``'s tokens the reference's, every step's logits fed
the reference's tokens within 1e-5, the cache in ``cache_spec``'s
head-dim layout), a batch of one on (2, 2) among them (the slots over
``data``, the head dim over ``model``); two train steps (qwen on (2, 2),
TinyLlama on (1, 4)) under ``tests/test_torch_tp.py``'s rules; a seeded
model's blocks; ``launch/train.py --ckpt-dir --shard-hd-fallback`` on
(2, 2) resumed and loaded whole.

The RoPE pin: the rotary embedding pairs column i with i + hd/2, which
another rank holds, so a rank cannot rotate its block alone
(``test_rotating_a_head_dim_block_on_its_own_rank_is_not_rope``). On a
copy of the port that rotates each head-dim block on its own (as a head
of the block's width) instead of the gathered heads, every forward,
decode and train case here fails. Only the train cases tell the backward
rules apart: with the head-dim gather's gradient unsummed (``gather_own``
for ``gather_axis``) both train cases fail, and without the
``copy_over`` of x in case H qwen's train and checkpoint cases fail.
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

import test_torch_tp as tp  # noqa: E402
from test_torch_tp import base  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.layers import apply_rope as ref_apply_rope  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import batch_at  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_cos_sin  # noqa: E402

S, NEW, SLOTS, STEPS = tp.S, tp.NEW, tp.SLOTS, tp.STEPS
HEADS3 = {"n_heads": 3, "n_kv_heads": 3, "head_dim": 16}
HEADS8 = {"n_heads": 8, "n_kv_heads": 4, "head_dim": 16}
WORLD = 8   # rank processes: a world of 8, then of 4 and of 2
# name: (kind, world, mesh shape (data, model), arch, config changes, B)
# (a decode case's prefill logits are held as a forward case's)
CASES = {
    "fwd/qwen-1x2": ("forward", 2, (1, 2), "qwen1.5-4b", {}, 2),
    # case M in the vlm overlay and the moe archs' attention
    "fwd/internvl2-1x4": ("forward", 4, (1, 4), "internvl2-76b", {}, 2),
    "fwd/dbrx-1x4": ("forward", 4, (1, 4), "dbrx-132b", {}, 2),
    "dec/qwen-1x4": ("decode", 4, (1, 4), "qwen1.5-4b", {}, 2),
    "dec/tinyllama-1x4": ("decode", 4, (1, 4), "tinyllama-1.1b", {}, 2),
    "dec/hymba-1x4": ("decode", 4, (1, 4), "hymba-1.5b", {}, 2),
    "dec/whisper3-1x4": ("decode", 4, (1, 4), "whisper-small", HEADS3, 2),
    # case M at model 8, as TinyLlama-1.1B's 32 / 4 heads take it: 8 query
    # heads split by heads, 4 kv heads of 16 dims by their head dim
    "dec/tinyllama8-1x8": ("decode", 8, (1, 8), "tinyllama-1.1b",
                           HEADS8, 2),
    "dec/qwen-2x2-b1": ("decode", 4, (2, 2), "qwen1.5-4b", {}, 1),
    "train/qwen-2x2": ("train", 4, (2, 2), "qwen1.5-4b", {}, 4),
    "train/tinyllama-1x4": ("train", 4, (1, 4), "tinyllama-1.1b", {}, 4),
}
CKPT_ARCH = "qwen1.5-4b"


def _derived(script, edits):
    """``script`` with each (old, new) edit made, every old text found."""
    for old, new in edits:
        assert old in script, old
        script = script.replace(old, new)
    return script


# the reference's and the port's scripts of tests/test_torch_tp.py, under
# DistConfig(shard_head_dim_fallback=True); the port's checkpoint run on
# qwen (its 5 heads split the head dim on (2, 2))
_REFERENCE = _derived(tp._REFERENCE, [
    ("from repro.distributed.sharding import batch_spec, param_shardings",
     "from repro.distributed.sharding import (DistConfig, batch_spec,\n"
     "                                        param_shardings)\n"
     "DIST = DistConfig(shard_head_dim_fallback=True)"),
    ("with mesh_context(mesh):", "with mesh_context(mesh, DIST):"),
    ("param_shardings(params, mesh)", "param_shardings(params, mesh, DIST)"),
    ("p, bt, cfg, max_len=S + new))(params, batch)",
     "p, bt, cfg, max_len=S + new))(params, batch)\n"
     '            res[f"{name}/logits"] = np.asarray(logits)')])
_PORT = _derived(tp._PORT, [
    ("from repro_torch.distributed import sharding as shd",
     "from repro_torch.distributed import sharding as shd\n"
     "DIST = shd.DistConfig(shard_head_dim_fallback=True)"),
    ('"cpu", mesh=mesh)', '"cpu", mesh=mesh, dist=DIST)'),
    ("mesh_context(mesh, batch=b)", "mesh_context(mesh, DIST, batch=b)"),
    ("with mesh_context(mesh):", "with mesh_context(mesh, DIST):"),
    ("cache[key].shape[2:4]", "cache[key].shape[2:5]"),
    ("_, cache = prefill(model, batch, cfg, max_len=S + new)",
     "logits, cache = prefill(model, batch, cfg, max_len=S + new)\n"
     '                    res[f"{name}/logits"] = gather_vocab(\n'
     "                        model, logits).numpy()"),
    ('"--arch", "tinyllama-1.1b"', f'"--arch", "{CKPT_ARCH}"'),
    ('"--ckpt-every", "2"])', '"--ckpt-every", "2",\n'
     '            "--shard-hd-fallback"])'),
    # whether the attention kernel's inputs are contiguous, as the CUDA
    # kernel takes them (its plain version here takes any strides)
    ("torch.set_num_threads(1)\n",
     "torch.set_num_threads(1)\n"
     "from repro_torch.kernels import ops as kernel_ops\n"
     "contiguous, kernel_call = [], kernel_ops.flash_attention\n"
     "def recorded(q, k, v, *a, **kw):\n"
     "    contiguous.append(all(t.is_contiguous() for t in (q, k, v)))\n"
     "    return kernel_call(q, k, v, *a, **kw)\n"
     "kernel_ops.flash_attention = recorded\n"),
    ('np.savez(out + f"/port{rank}.npz", **res)',
     'res["kernel_inputs_contiguous"] = np.array(contiguous)\n'
     'np.savez(out + f"/port{rank}.npz", **res)'),
    # case M on (1, 8) in a world of 8 before the others; the seeded blocks
    # on the worlds of 4 and 2 alone
    ("for world in (4, 2):", "for world in (8, 4, 2):"),
    ("        for arch in seeded:", "        for arch in (seeded if world < 8 else ()):")])


def _inputs():
    x = {}
    for name, (kind, _, _, arch, changes, b) in CASES.items():
        cfg = tp._cfg(ref_get_config, arch, changes)
        x.update(tp._flatten(base._weights(cfg, seed=len(name)),
                             f"weights/{name}/"))
        for i in range(STEPS if kind == "train" else 1):
            batch = base._batch(cfg, b=b, s=S, seed=10 * i + len(name))
            if kind != "train":
                del batch["labels"]
            x.update(tp._flatten(batch, f"batch/{name}/{i}/"))
    return x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides: {"x", "ref", "port": [rank 0..7], "out"}. The
    reference's forward, decode and train cases run in three JAX
    subprocesses side by side (each compiles its own steps)."""
    out = tmp_path_factory.mktemp("tp_hd")
    x = _inputs()
    env = dict(os.environ, PYTHONPATH=os.path.join(tp.ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    np.savez(out / "inputs.npz", **x)
    (out / "reference.py").write_text(_REFERENCE)
    (out / "port.py").write_text(_PORT)
    refs = []
    for kind in ("train", "decode", "forward"):
        d = out / kind
        d.mkdir()
        (d / "inputs.npz").symlink_to(out / "inputs.npz")
        cases = {k: v for k, v in CASES.items() if v[0] == kind}
        refs.append((d, subprocess.Popen(
            [sys.executable, str(out / "reference.py"), repr(cases),
             repr(tp.OCFG), str(STEPS), str(NEW), str(d), str(S), "{}"],
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
         repr(CASES), repr(tp.OCFG), str(STEPS), str(NEW), repr(tp.SEEDED),
         str(S), "{}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return {"x": x, "ref": want, "out": out,
            "port": [dict(np.load(out / f"port{r}.npz"))
                     for r in range(WORLD)]}


def _ranks(runs, name):
    return runs["port"][:CASES[name][1]]


@pytest.mark.parametrize("arch", tp.SEEDED)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 2)])
def test_a_model_seeded_under_the_flag_holds_the_unsharded_blocks(
        runs, arch, shape):
    for port in runs["port"][:math.prod(shape)]:
        ok, n_blocks, n = port[f"seeded/{arch}/{shape}"]
        assert ok and n_blocks > 0, (arch, shape, n_blocks, n)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(
    ("fwd/", "dec/"))])
def test_forward_matches_the_reference_head_dim_split(runs, name):
    _, _, shape, _, _, b = CASES[name]
    want = runs["ref"][f"{name}/logits"]
    for r, port in enumerate(_ranks(runs, name)):
        np.testing.assert_allclose(port[f"{name}/logits"],
                                   tp._rows(want, b, shape, r),
                                   **tp.LOGITS_TOL, err_msg=f"rank {r}")


# the decode cases' cache layouts: {"k" or "xk": (slots in all, slots a
# rank, kv heads a rank, head-dim columns a rank, the axes splitting the
# slots), "ssm": as tests/test_torch_tp.py's}; hymba's 8 meta tokens take
# slots ahead of the tokens'
META = tp.META
LAYOUTS = {"dec/qwen-1x4": {"k": (SLOTS, SLOTS, 5, 3, "")},
           "dec/tinyllama-1x4": {"k": (SLOTS, SLOTS, 2, 4, "")},
           "dec/hymba-1x4": {"k": (SLOTS + META, SLOTS + META, 2, 4, ""),
                             "ssm": (2, 36)},
           "dec/whisper3-1x4": {"k": (SLOTS, SLOTS, 3, 4, ""),
                                "xk": (30, 30, 3, 4, "")},
           "dec/tinyllama8-1x8": {"k": (SLOTS, SLOTS, 4, 2, "")},
           "dec/qwen-2x2-b1": {"k": (SLOTS, SLOTS // 2, 5, 6, "data")}}


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("dec/")])
def test_greedy_decode_matches_the_reference_head_dim_split(runs, name):
    """Equal greedy tokens from ``Engine.generate``; every decode step's
    logits (fed the reference's tokens) within 1e-5; the cache holding
    the rank's block of the head dim (and its slots over ``data`` for a
    batch of one on (2, 2))."""
    _, _, shape, _, _, b = CASES[name]
    ref = runs["ref"]
    for r, port in enumerate(_ranks(runs, name)):
        np.testing.assert_array_equal(
            port[f"{name}/tokens"],
            tp._rows(ref[f"{name}/tokens"], b, shape, r),
            err_msg=f"rank {r}")
        np.testing.assert_allclose(
            port[f"{name}/step_logits"],
            np.stack([tp._rows(s, b, shape, r)
                      for s in ref[f"{name}/step_logits"]]),
            **tp.LOGITS_TOL, err_msg=f"rank {r}")
    port = _ranks(runs, name)
    for key, layout in LAYOUTS[name].items():
        if key == "ssm":
            assert tuple(port[0][f"{name}/cache/ssm"]) == layout
            continue
        total, slots, heads, cols, axes = layout
        assert str(port[0][f"{name}/seq_axes/{key}"]) == axes
        assert tuple(port[0][f"{name}/cache/{key}"][1:]) == (slots, heads,
                                                             cols)
        firsts = sorted({int(p[f"{name}/cache/{key}"][0]) for p in port})
        assert firsts == list(range(0, total, slots))
    assert {f"{name}/cache/{key}" for key in LAYOUTS[name]} == {
        k for k in port[0] if k.startswith(f"{name}/cache/")}


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("train/")])
def test_train_step_matches_the_reference_head_dim_split(runs, name, i):
    """Each rank's loss and grad norm, and the parameters and moments
    gathered whole on rank 0, are the reference's after step i, under
    ``tests/test_torch_tp.py``'s rules (qwen's key biases to the outlier
    bound in every element)."""
    tp.check_train_step(runs, CASES, name, i)


def test_checkpoint_under_the_flag_resumes_and_loads_whole(runs):
    """``launch/train.py --shard-hd-fallback`` on (2, 2), qwen's attention
    split over the head dim: resumed from the step-2 checkpoint the run
    takes the step the unbroken run took, on every rank; the checkpoint
    (the blocks gathered whole by spec) loads into a model and optimizer
    state on one device, whose next step agrees with the mesh's to the
    bf16 rounding of the REDUCED config."""
    for port in runs["port"][:4]:    # the world of 4's
        for key in tp.METRICS:
            assert port[f"ckpt/resumed/{key}"] == \
                port[f"ckpt/unbroken/{key}"], key
    args = trainer.parser().parse_args([
        "--arch", CKPT_ARCH, "--steps", "3", "--batch", "4", "--seq",
        str(S), "--device", "cpu"])
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


@pytest.mark.parametrize("rank", range(WORLD))
def test_the_attention_kernel_gets_contiguous_inputs(runs, rank):
    """Every ``flash_attention`` call of every case on the rank (case M's
    kv heads of the rank's query heads included: a slice of the gathered
    heads) passes contiguous q, k and v, as the CUDA kernel requires."""
    got = runs["port"][rank]["kernel_inputs_contiguous"]
    assert got.size > 0 and got.all(), (int((~got).sum()), got.size)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "hymba-1.5b"])
def test_rotating_a_head_dim_block_on_its_own_rank_is_not_rope(arch):
    """The RoPE pin, on (1, 4): a rank's head-dim block of the rotated q
    (the reference's ``apply_rope``) is not the block rotated on its own
    (as a head of the block's width), at any rank, while the blocks
    gathered, rotated whole and cut again are it (what
    ``Attention._proj`` and ``cache_block`` do)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    hd, m = cfg.resolved_head_dim, 4
    n = hd // m
    g = np.random.default_rng(0)
    q = g.standard_normal((2, 9, cfg.n_heads, hd)).astype(np.float32)
    pos = torch.arange(9)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)
    want = np.asarray(ref_apply_rope(jax.numpy.asarray(q), jax.numpy.asarray(
        cos.numpy()), jax.numpy.asarray(sin.numpy())))
    whole = apply_rope(torch.from_numpy(q), cos, sin).numpy()
    np.testing.assert_allclose(whole, want, rtol=1e-6, atol=1e-6)
    for r in range(m):
        cols = slice(r * n, (r + 1) * n)
        if n % 2:   # an odd block has no halves to rotate: the rank
            continue   # holds one side of some pairs and not the other
        bc, bs = rope_cos_sin(pos, n, cfg.rope_theta)
        alone = apply_rope(torch.from_numpy(q[..., cols]), bc, bs).numpy()
        assert np.abs(alone - want[..., cols]).max() > 0.1, r
    # the block r of the rotation reads the columns of other blocks: the
    # same block of q with the rest of q changed rotates differently
    other = q.copy()
    other[..., n:] = g.standard_normal(other[..., n:].shape)
    moved = apply_rope(torch.from_numpy(other), cos, sin).numpy()
    assert np.abs(moved[:, 1:, :, :n] - whole[:, 1:, :, :n]).max() > 0.1
