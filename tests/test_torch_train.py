"""The port's training path against the reference on the same weights and
tokens: the loss and every gradient, the optimizer and the train step
(plain AdamW, factored with bf16 state, microbatched), gradient
compression, checkpoints of parameters and optimizer state, and the
trainer's checkpoint/resume.

Weights are the reference's ``init_params`` (norms perturbed so that
their gradients and ``1 + scale`` matter), carried into the port with
``lm_params_from_arrays``; optimizer state after reference steps is
carried with ``opt_state_from_arrays``; tokens and labels are numpy from
a seed (``batch_at`` streams differ between the packages). REDUCED
configs in float32, where the packages differ only in the order of f32
sums: loss to 1e-5 relative, gradients to 1e-4 relative and 1e-6
absolute, moments after 1 and 3 steps to 1e-4 relative and 1e-6
absolute, parameters to 1e-4 relative and 1e-5 absolute (a thousandth of
the learning rate of 1e-2). Up to one element in a thousand of a tensor
may fall outside those, within a bound: an element whose gradient is a
near-cancelled sum, at Adam's eps or below, moves by lr g / (|g| + eps),
which turns the f32 noise of g into a difference at the scale of lr
(measured: one element of the 32,768 of ``tok_embed`` 0.0087 apart after
three steps), and a moment stored in bf16 can round one bf16 step apart
from an f32 difference in the last bits. So parameters hold such an
outlier within 3 lr per step, moments within 2^-7 of their value.
The bf16 case holds the loss to
2e-2 (about three bf16 steps of the logits, as the serving tests find)
and each gradient to 2^-3 of its largest magnitude.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.training import compression as ref_comp  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_step as ref_ts  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import (  # noqa: E402
    lm_params_from_arrays,
    opt_state_from_arrays,
)
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.training import compression as comp  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-2
# the leaves _weights perturbs beside the norms: the qkv biases and the
# audio family's feed-forward biases
BIASES = ("['bq']", "['bk']", "['bv']", "['b_fc']", "['b_out']")
# the few elements Adam's eps or the bf16 state flips (see the docstring)
MOMENT_OUTLIERS = dict(outlier_atol=1e-6, outlier_rtol=2 ** -7)


def _param_outliers(n_steps):
    """An Adam update moves an element by at most a few lr a step."""
    return dict(outlier_atol=3 * LR * n_steps)


def _configs(arch="tinyllama-1.1b", dtype="float32"):
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype=dtype)
                 for get in (ref_get_config, get_config))


def _weights(cfg, seed=0):
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or name.endswith(BIASES):
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, params)


def _batch(cfg, b=4, s=24, seed=1):
    """Numpy tokens and next-token labels, -1 at the end and at a few
    random places; then the family's modality stub, f32 standard normal:
    the audio family's ``frames`` [b, enc_frames, d], the vlm family's
    ``vision_embeds`` [b, vision_tokens, d] (its labels -1 under them, as
    ``batch_at`` draws them)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1))
    labels = tokens[:, 1:].copy()
    labels[rng.random((b, s)) < 0.1] = -1
    labels[:, -1] = -1
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": labels.astype(np.int32)}
    if cfg.enc_layers:
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        batch["labels"][:, :cfg.vision_tokens] = -1
    return batch


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    """Integer entries as int64 tensors, the stubs' floats as they are."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in batch.items()}


def _per_layer(tree):
    """A reference tree of numpy arrays by the port's names (the stacked
    leaves under each of ``optimizer.STACKS``: ``blocks``,
    ``dense_blocks`` and ``encoder``, split into layers; factored leaves
    as name.row; a factored stacked [L, d] leaf's column, shared by the
    layers, under each layer's name)."""
    out = {}

    def walk(t, prefix):
        stack, dot, rest = prefix.partition(".")
        stacked = bool(dot) and stack in opt.STACKS
        for key, val in t.items():
            if isinstance(val, dict) and stacked \
                    and set(val) == {"row", "col"} \
                    and np.ndim(val["row"]) == 1:
                for i, row in enumerate(np.asarray(val["row"], np.float32)):
                    name = f"{stack}.{i}.{rest}{key}"
                    out[f"{name}.row"] = row
                    out[f"{name}.col"] = np.asarray(val["col"], np.float32)
            elif isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            elif stacked:
                for i, layer in enumerate(np.asarray(val, np.float32)):
                    out[f"{stack}.{i}.{rest}{key}"] = layer
            else:
                out[prefix + key] = np.asarray(val, np.float32)
    walk(tree, "")
    return out


def _port_flat(tree):
    out = {}
    for name, val in tree.items():
        if isinstance(val, dict):
            for key, t in val.items():
                out[f"{name}.{key}"] = t.detach().float().numpy()
        else:
            out[name] = val.detach().float().numpy()
    return out


def _assert_trees(got, want, tol, what, outlier_atol=None,
                  outlier_rtol=0.0):
    """Every array of ``got`` within ``tol`` of ``want``'s. With
    ``outlier_atol``, up to one element in a thousand of an array may lie
    outside ``tol`` if it lies within ``outlier_atol + outlier_rtol |want|``."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for name in sorted(want):
        g, w = got[name], want[name]
        if outlier_atol is None:
            np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **tol)
            continue
        err = np.abs(g - w)
        out = err > tol["atol"] + tol["rtol"] * np.abs(w)
        assert out.sum() <= w.size // 1000, (what, name, int(out.sum()))
        bound = outlier_atol + outlier_rtol * np.abs(w)
        assert (err <= bound).all(), (what, name, float(err.max()))


# ------------------------------------------------------------ loss, grads


def test_cross_entropy_matches_reference_with_ignored_labels_and_z_loss():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 40)) * 3).astype(np.float32)
    labels = rng.integers(-1, 33, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4, 0.1):
        got = ts.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), 40, z)
        want = ref_ts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    40, z)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = -np.ones_like(labels)   # every label ignored: 0, not NaN
    assert float(ts.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(none), 40, 1e-4)) == 0.0


def _loss_and_grads(arch, dtype):
    rcfg, tcfg = _configs(arch, dtype)
    np_params = _weights(rcfg)
    batch = _batch(rcfg)
    train = ts.TrainConfig(z_loss_weight=1e-3)
    (r_total, r_aux), r_grads = jax.value_and_grad(
        ref_ts.loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, np_params),
                                      _ref(batch), rcfg,
                                      ref_ts.TrainConfig(z_loss_weight=1e-3))
    model = lm_params_from_arrays(tcfg, np_params,
                                  device="cpu").requires_grad_()
    total, aux = ts.loss_fn(model, _port(batch), tcfg, train)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params)
    return (float(total.detach()), float(r_total), aux, r_aux,
            {n: g.float().numpy() for n, g in zip(names, grads)},
            _per_layer(jax.tree.map(np.asarray, r_grads)))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-4b"])
def test_loss_and_every_gradient_match_reference(arch):
    """REDUCED float32, z-loss on; qwen1.5 adds qkv biases and D = 12."""
    total, r_total, aux, r_aux, grads, r_grads = _loss_and_grads(
        arch, "float32")
    np.testing.assert_allclose(total, r_total, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["loss"].detach()),
                               float(r_aux["loss"]),
                               rtol=LOSS_RTOL)
    assert float(aux["aux_loss"]) == float(r_aux["aux_loss"]) == 0.0
    _assert_trees(grads, r_grads, GRAD_TOL, "grad")


def test_loss_and_gradients_in_bf16():
    total, r_total, _, _, grads, r_grads = _loss_and_grads("tinyllama-1.1b",
                                                           "bfloat16")
    assert abs(total - r_total) <= 2e-2, (total, r_total)
    assert set(grads) == set(r_grads)
    for name, g in grads.items():
        w = r_grads[name]
        bound = 2 ** -3 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, name


def test_forward_return_aux_is_a_zero_f32_scalar_for_the_dense_family():
    _, tcfg = _configs()
    model = T.init_params(tcfg, device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.long)
    logits, aux = T.forward(model, {"tokens": tokens}, tcfg, return_aux=True)
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == 0
    assert torch.equal(logits, T.forward(model, {"tokens": tokens}, tcfg))


# ------------------------------------------------------ optimizer and step


def test_schedule_at_warmup_mid_and_end():
    cfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=110)
    rcfg = ref_opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=110)
    for step in (0, 1, 5, 10, 60, 110, 200):
        got = float(opt.schedule(cfg, step))
        want = float(ref_opt.schedule(rcfg, jnp.asarray(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert float(opt.schedule(cfg, 110)) == pytest.approx(1e-4, rel=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    arrays = {f"w{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate([(3, 4), (5,), (2, 3, 4)])}
    got = opt.global_norm({k: torch.from_numpy(v) for k, v in arrays.items()})
    want = ref_opt.global_norm({k: jnp.asarray(v) for k, v in arrays.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# (optimizer config, train config) of the three step variants
STEP_VARIANTS = {
    "adamw": (dict(), dict()),
    "factored-bf16-state": (dict(factored=True, min_dim_size_to_factor=16,
                                 state_dtype="bfloat16"), dict()),
    "microbatches-2": (dict(), dict(microbatches=2)),
}


def _run_steps(variant, n_steps, start=0, arch="tinyllama-1.1b", seq=24,
               opt_changes=None, **cfg_changes):
    """The reference and the port from the same weights of ``arch``
    REDUCED (float32, with ``cfg_changes``) and ``seq``-token batches,
    the variant's optimizer config with ``opt_changes``,
    ``start`` reference steps carried into the port through
    ``opt_state_from_arrays``, then ``n_steps`` steps each on the same
    batches. Returns (port params, port state, port metrics, ref params,
    ref state, ref metrics), the trees by the port's names."""
    okw, tkw = STEP_VARIANTS[variant]
    rcfg, tcfg = (dataclasses.replace(c, **cfg_changes)
                  for c in _configs(arch))
    ocfg = dict(dict(lr=LR, warmup_steps=2, total_steps=10, **okw),
                **(opt_changes or {}))
    r_step = jax.jit(ref_ts.make_train_step(
        rcfg, ref_opt.OptimizerConfig(**ocfg), ref_ts.TrainConfig(**tkw)))
    t_step = ts.make_train_step(tcfg, opt.OptimizerConfig(**ocfg),
                                ts.TrainConfig(**tkw))
    params = jax.tree.map(jnp.asarray, _weights(rcfg))
    state = ref_opt.init_state(params, ref_opt.OptimizerConfig(**ocfg))
    batches = [_batch(rcfg, s=seq, seed=s) for s in range(start + n_steps)]
    for s in range(start):
        params, state, _ = r_step(params, state, _ref(batches[s]))
    model = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu").requires_grad_()
    t_state = opt_state_from_arrays(tcfg, jax.tree.map(np.asarray, state),
                                    device="cpu")
    if start == 0:   # the port's own init_state is what the carry gives
        fresh = opt.init_state(dict(model.named_parameters()),
                               opt.OptimizerConfig(**ocfg))
        assert _port_flat(fresh["m"]).keys() == _port_flat(t_state["m"]).keys()
        assert _port_flat(fresh["v"]).keys() == _port_flat(t_state["v"]).keys()
    for s in range(start, start + n_steps):
        params, state, r_metrics = r_step(params, state, _ref(batches[s]))
        model, t_state, t_metrics = t_step(model, t_state, _port(batches[s]))
    return (dict(model.named_parameters()), t_state, t_metrics,
            jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), r_metrics)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_train_steps_match_reference(variant, n_steps):
    p, st, m, rp, rst, rm = _run_steps(variant, n_steps)
    assert int(st["step"]) == int(rst["step"]) == n_steps
    _assert_trees(_port_flat(p), _per_layer(rp), PARAM_TOL, "param",
                  **_param_outliers(n_steps))
    _assert_trees(_port_flat(st["m"]), _per_layer(rst["m"]), STEP_TOL, "m",
                  **MOMENT_OUTLIERS)
    _assert_trees(_port_flat(st["v"]), _per_layer(rst["v"]), STEP_TOL, "v",
                  **MOMENT_OUTLIERS)
    for key in ("loss", "aux_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    if variant == "factored-bf16-state":
        assert st["m"]["tok_embed"].dtype == torch.bfloat16
        assert set(st["v"]["blocks.0.mlp.w_gate"]) == {"row", "col"}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_a_step_from_carried_reference_state_matches(variant):
    """Two reference steps, their params and optimizer state carried into
    the port, then one more step on each."""
    p, st, m, rp, rst, _ = _run_steps(variant, 1, start=2)
    assert int(st["step"]) == 3
    _assert_trees(_port_flat(p), _per_layer(rp), PARAM_TOL, "param",
                  **_param_outliers(1))
    _assert_trees(_port_flat(st["m"]), _per_layer(rst["m"]), STEP_TOL, "m",
                  **MOMENT_OUTLIERS)
    _assert_trees(_port_flat(st["v"]), _per_layer(rst["v"]), STEP_TOL, "v",
                  **MOMENT_OUTLIERS)


def test_weight_decay_follows_the_reference_leaf_rank():
    """A layer's norm scale [d] is the stacked [L, d] leaf of the
    reference and decays; the final norm [d] does not; matrices do."""
    w = torch.zeros(4)
    assert opt.reference_ndim("blocks.0.attn_norm", w) == 2
    assert opt.reference_ndim("final_norm", w) == 1
    assert opt.reference_ndim("tok_embed", torch.zeros(3, 4)) == 2


# ---------------------------------------- the reference's training checks


def _port_setup(ocfg, seed=0):
    _, tcfg = _configs(dtype="bfloat16")
    model = T.init_params(tcfg, seed=seed, device="cpu").requires_grad_()
    return tcfg, model, opt.init_state(dict(model.named_parameters()), ocfg)


def test_loss_decreases():
    ocfg = opt.OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    cfg, model, state = _port_setup(ocfg)
    dcfg = DataConfig(seed=0, batch_size=8, seq_len=64)
    step = ts.make_train_step(cfg, ocfg, ts.TrainConfig())
    losses = []
    for s in range(30):
        model, state, m = step(model, state, batch_at(dcfg, cfg, s,
                                                      device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_microbatch_equivalence():
    """microbatches=2 gives (nearly) the update of microbatches=1 on the
    same global batch (bf16 parameters, reordered sums)."""
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cfg, m1, s1 = _port_setup(ocfg)
    _, m2, s2 = _port_setup(ocfg)
    batch = batch_at(DataConfig(seed=3, batch_size=8, seq_len=32), cfg, 0,
                     device="cpu")
    ts.make_train_step(cfg, ocfg, ts.TrainConfig(microbatches=1))(m1, s1,
                                                                  batch)
    ts.make_train_step(cfg, ocfg, ts.TrainConfig(microbatches=2))(m2, s2,
                                                                  batch)
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(m1.parameters(), m2.parameters())]
    assert max(diffs) < 5e-2, max(diffs)


def test_factored_optimizer_trains():
    ocfg = opt.OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=50,
                               factored=True, min_dim_size_to_factor=32,
                               state_dtype="bfloat16")
    cfg, model, state = _port_setup(ocfg)
    n_v = sum(t.size for t in _port_flat(state["v"]).values())
    n_p = sum(p.numel() for p in model.parameters())
    assert n_v < n_p
    dcfg = DataConfig(seed=1, batch_size=8, seq_len=64)
    step = ts.make_train_step(cfg, ocfg, ts.TrainConfig())
    losses = []
    for s in range(20):
        model, state, m = step(model, state, batch_at(dcfg, cfg, s,
                                                      device="cpu"))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


# ------------------------------------------------------------- compression


def test_quantize_and_dequantize_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 127.4]   # ties to even, clipping
    for scale in (np.float32(0.01), np.float32(0.5), np.float32(3.0)):
        got = comp.quantize(torch.from_numpy(x), torch.tensor(scale))
        want = np.asarray(ref_comp.quantize(jnp.asarray(x),
                                            jnp.asarray(scale)))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            comp.dequantize(got, torch.tensor(scale)).numpy(),
            np.asarray(ref_comp.dequantize(jnp.asarray(want),
                                           jnp.asarray(scale))))


def _grads_of_rank(rank):
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal((32, 48)) * (1 + rank)).astype(np.float32)


_TORCH_PSUM = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.training.compression import compressed_psum_tree
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
g = {{"w": torch.from_numpy(np.load(out + f"/in{{rank}}.npy"))}}
res = compressed_psum_tree(g)["w"]
np.save(out + f"/torch{{rank}}.npy", res.numpy())
dist.destroy_process_group()
"""

_JAX_PSUM = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.compat import shard_map
from repro.training.compression import compressed_psum
out = sys.argv[1]
x = np.stack([np.load(out + f"/in{r}.npy") for r in range(2)])
mesh = jax.make_mesh((2,), ("data",))
f = shard_map(lambda a: compressed_psum(a[0], "data")[None], mesh=mesh,
              in_specs=P("data"), out_specs=P("data"), check_vma=False)
np.save(out + "/jax.npy", np.asarray(f(jnp.asarray(x))))
"""


def test_compressed_psum_at_world_size_two_equals_reference(tmp_path):
    """Two gloo ranks (``file://`` init) against the reference's
    ``compressed_psum`` under ``shard_map`` on two forced host devices,
    each in its own processes. The int8 sums are exact and the scale is
    one f32 division, so the results are equal bit for bit."""
    for r in range(2):
        np.save(tmp_path / f"in{r}.npy", _grads_of_rank(r))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = tmp_path / "torch_psum.py"
    script.write_text(_TORCH_PSUM.format())
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    jax_script = tmp_path / "jax_psum.py"
    jax_script.write_text(_JAX_PSUM)
    ref = subprocess.run([sys.executable, str(jax_script), str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = np.load(tmp_path / "jax.npy")
    g = [_grads_of_rank(r) for r in range(2)]
    # each rank's rounding is at most half a step of the shared scale
    scale = max(np.abs(g[0]).max(), np.abs(g[1]).max()) / 127
    for r in range(2):
        got = np.load(tmp_path / f"torch{r}.npy")
        np.testing.assert_array_equal(got, want[r])
        assert np.abs(got - (g[0] + g[1])).max() <= scale * 1.0001


# -------------------------------------------------------------- checkpoints


def test_bf16_tensors_round_trip_through_a_checkpoint(tmp_path):
    """bf16 has no numpy dtype: it is stored as its uint16 bits, tagged,
    and read back as torch.bfloat16, bit for bit."""
    w = torch.randn(5, 3).bfloat16()
    save_checkpoint(str(tmp_path), 1, {"w": w, "f": torch.arange(4.0)})
    step, flat, _ = load_checkpoint(str(tmp_path))
    assert step == 1 and flat["w"].dtype == torch.bfloat16
    assert torch.equal(flat["w"], w)
    np.testing.assert_array_equal(flat["f"], np.arange(4.0, dtype=np.float32))


def test_params_and_nested_optimizer_state_round_trip(tmp_path):
    ocfg = opt.OptimizerConfig(factored=True, min_dim_size_to_factor=32,
                               state_dtype="bfloat16")
    cfg, model, state = _port_setup(ocfg)
    batch = batch_at(DataConfig(seed=0, batch_size=2, seq_len=16), cfg, 0,
                     device="cpu")
    _, state, _ = ts.make_train_step(cfg, ocfg)(model, state, batch)
    params = dict(model.named_parameters())
    save_checkpoint(str(tmp_path / "p"), 1, params)
    save_checkpoint(str(tmp_path / "o"), 1, state)
    _, flat, _ = load_checkpoint(str(tmp_path / "o"))
    assert "v/blocks.0.mlp.w_gate/row" in flat and "step" in flat
    _, p2, _ = load_checkpoint(str(tmp_path / "p"), like=params)
    _, s2, _ = load_checkpoint(str(tmp_path / "o"), like=state)
    for name, p in params.items():
        assert p2[name].dtype == p.dtype and torch.equal(p2[name], p)
    assert _port_flat(s2["v"]).keys() == _port_flat(state["v"]).keys()
    assert isinstance(s2["v"]["blocks.0.mlp.w_gate"], dict)
    for (n, a), b in zip(_port_flat(state["v"]).items(),
                         _port_flat(s2["v"]).values()):
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert int(s2["step"]) == 1 and s2["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path / "o"), like={"step": state["step"]})


def test_trainer_resume_reproduces_an_uninterrupted_run(tmp_path):
    """``launch/train.py --device cpu`` for 4 REDUCED steps with a
    checkpoint every 2; then, with the step-4 checkpoints removed (as if
    the run had stopped after step 2), the same command resumes from step
    2 and ends on exactly the parameters and optimizer state of the
    uninterrupted run."""
    d = str(tmp_path)
    args = ["--device", "cpu", "--batch", "4", "--seq", "32", "--steps",
            "4", "--ckpt-every", "2", "--ckpt-dir", d]
    trainer.main(args)
    whole = {sub: load_checkpoint(f"{d}/{sub}", 4)[1] for sub in "po"}
    for sub in "po":
        shutil.rmtree(f"{d}/{sub}/step_00000004")
    trainer.main(args)
    for sub in "po":
        step, resumed, _ = load_checkpoint(f"{d}/{sub}")
        assert step == 4 and resumed.keys() == whole[sub].keys()
        for k, a in whole[sub].items():
            assert torch.equal(torch.as_tensor(a),
                               torch.as_tensor(resumed[k])), (sub, k)


def test_trainer_resume_loads_the_latest_step(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]
    trainer.main(args + ["--steps", "1"])
    out = trainer.main(args + ["--steps", "2"])
    assert "resumed at step 1" in capsys.readouterr().out
    assert np.isfinite(out["loss"]) and out["lr"] > 0


# ----------------------------------------------------------------- defaults


def test_trainer_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs()
    for call in (lambda: trainer.main(["--steps", "1"]),
                 lambda: trainer.setup(trainer.parser().parse_args([])),
                 lambda: opt_state_from_arrays(cfg, {"step": 0, "m": {},
                                                     "v": {}})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
