"""Training of the audio (whisper-small) and vlm (internvl2-76b) families
in the port against the reference, on the same weights, tokens and
modality stubs.

The helpers and tolerances are ``tests/test_torch_train.py``'s: the
reference's ``init_params`` (norms and biases perturbed) carried with
``lm_params_from_arrays``, its optimizer state with
``opt_state_from_arrays``; numpy tokens, labels, whisper's ``frames``
[B, 30, d] and internvl2's ``vision_embeds`` [B, 8, d] from a seed (the
labels -1 under the vision tokens, as ``batch_at`` draws them); REDUCED
configs, remat on in both packages (their default). Whisper's 30-frame
encoder is under the reference's 512-key chunk, so none of the zero keys
its chunked full attention pads with arises. Checked:

* the loss and every gradient (encoder layers, ``enc_norm``, the decoder's
  ``xattn`` and ``xattn_norm``, the biases) against
  ``jax.value_and_grad`` of the reference's ``loss_fn``: float32 to
  ``GRAD_TOL`` (1e-4 relative, 1e-6 absolute), bfloat16 to 2^-3 of each
  gradient's largest magnitude and the loss to 2e-2;
* parameters and moments after 1 and 3 steps of the reference's
  ``make_train_step`` with plain AdamW and with a factored f32 second
  moment (``min_dim_size_to_factor`` 16), also with the update run in
  row blocks (``optimizer.UPDATE_BLOCK`` cut to 1024 elements, so that
  every matrix is updated a block at a time), one step from the
  reference's carried state (the ``encoder`` moments split into layers),
  and two microbatches (``frames`` and ``vision_embeds`` split with the
  tokens), each to ``tests/test_torch_train.py``'s tolerances, but for
  whisper's key biases (``BIAS_K``): the gradient of a key bias cancels,
  exactly in the cross-attention (no rotary embedding: adding q.bk to
  every score of a query's row leaves its softmax as it was) and nearly
  in the self-attention's slowly turning rotary pairs, so Adam's step
  there, lr g / (|g| + eps), turns each package's f32 noise into a
  difference of up to lr a step (measured: 60 of the 64 elements of
  ``blocks.0.xattn.bk`` after three steps): those parameters are held to
  the outlier bound (3 lr a step) in every element, their moments to the
  tolerances; in float32 the cross-attention's key-bias gradient is held
  to 0 within ``GRAD_TOL``'s 1e-6, in bfloat16 (where it is noise of
  5e-5) under 2^-3 of its layer's query-bias gradient in both
  packages;
* two microbatches against one batch in the port, gradients to
  ``GRAD_TOL``;
* weight decay: each parameter's rank is its reference leaf's;
* the encoder under remat, its gradients against ``jax.grad`` of the
  reference's ``_encode`` (each layer under ``jax.checkpoint``);
* the vision overlay: ``tok_embed`` takes no gradient from the overlaid
  positions in either package, and the loss and gradients do not change
  when the tokens there are redrawn;
* ``launch/train.py`` steps each family on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import test_torch_train as base  # noqa: E402
from repro import models as R  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.training import train_step as ref_ts  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.data.lm import batch_at  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCHS = ("whisper-small", "internvl2-76b")
FACTORED = dict(factored=True, min_dim_size_to_factor=16)
# the step variants held here: (base.STEP_VARIANTS key, optimizer changes)
VARIANTS = {"adamw": ("adamw", None),
            "factored-f32-state": ("adamw", FACTORED)}
# an update block small enough that every matrix of the REDUCED configs
# is updated in several blocks of rows
SMALL_BLOCK = 1 << 10
# the key biases, whose gradient cancels (see the module docstring)
BIAS_K = ".bk"


def _assert_step(got, n_steps, want_step):
    p, st, m, rp, rst, rm = got
    params, want = base._port_flat(p), base._per_layer(rp)
    bound = base._param_outliers(n_steps)["outlier_atol"]
    for name in [n for n in want if n.endswith(BIAS_K)]:
        err = np.abs(params.pop(name) - want.pop(name))
        assert (err <= bound).all(), (name, float(err.max()))
    base._assert_trees(params, want, base.PARAM_TOL, "param",
                       **base._param_outliers(n_steps))
    for key in ("m", "v"):
        base._assert_trees(base._port_flat(st[key]),
                           base._per_layer(rst[key]), base.STEP_TOL, key,
                           **base.MOMENT_OUTLIERS)
    assert int(st["step"]) == int(rst["step"]) == want_step
    for key in ("loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


# ------------------------------------------------------------ loss, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    total, r_total, aux, r_aux, grads, r_grads = base._loss_and_grads(
        arch, "float32")
    np.testing.assert_allclose(total, r_total, rtol=base.LOSS_RTOL)
    np.testing.assert_allclose(float(aux["loss"].detach()),
                               float(r_aux["loss"]), rtol=base.LOSS_RTOL)
    base._assert_trees(grads, r_grads, base.GRAD_TOL, "grad")
    if arch == "whisper-small":
        for name in ("encoder.1.attn.wk", "encoder.0.mlp.b_fc", "enc_norm",
                     "blocks.1.xattn.wv", "blocks.0.xattn_norm",
                     "blocks.1.attn.bq"):
            assert np.abs(grads[name]).max() > 1e-4, name
        for i in range(2):   # a key bias of cross-attention: no gradient
            assert np.abs(grads[f"blocks.{i}.xattn.bk"]).max() <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_in_bf16(arch):
    total, r_total, _, _, grads, r_grads = base._loss_and_grads(arch,
                                                                "bfloat16")
    assert abs(total - r_total) <= 2e-2, (total, r_total)
    assert set(grads) == set(r_grads)
    for name, g in grads.items():
        w = r_grads[name]
        if name.endswith("xattn" + BIAS_K):   # 0 but for rounding
            bound = 2 ** -3 * float(np.abs(
                r_grads[name.replace(BIAS_K, ".bq")]).max())
            assert max(np.abs(g).max(), np.abs(w).max()) <= bound, name
            continue
        bound = 2 ** -3 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, name


def test_encoder_under_remat_matches_reference_grad():
    """The mean of encode(frames) * w (a loss's scale, at which GRAD_TOL's
    absolute 1e-6 was set) through the port's encoder with each layer
    recomputed in the backward, against ``jax.grad`` of the reference's
    ``_encode`` (``jax.checkpoint`` over each layer): every encoder leaf,
    ``enc_norm`` and the frames, float32 to GRAD_TOL; the same gradients
    without remat, bit for bit."""
    rcfg, tcfg = base._configs("whisper-small")
    np_params = base._weights(rcfg)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, rcfg.enc_frames, rcfg.d_model)) \
        .astype(np.float32)
    w = rng.standard_normal(frames.shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, np_params)

    def ref_fn(enc, enc_norm, x):
        p = dict(params, encoder=enc, enc_norm=enc_norm)
        return jnp.mean(ref_model._encode(p, rcfg, x) * w)
    r_enc, r_norm, r_x = jax.grad(ref_fn, argnums=(0, 1, 2))(
        params["encoder"], params["enc_norm"], jnp.asarray(frames))
    want = base._per_layer({"encoder": jax.tree.map(np.asarray, r_enc),
                            "enc_norm": np.asarray(r_norm)})
    want["frames"] = np.asarray(r_x)

    grads = []
    for remat in (True, False):
        model = lm_params_from_arrays(tcfg, np_params,
                                      device="cpu").requires_grad_()
        x = torch.from_numpy(frames).requires_grad_()
        (model.encode(x, remat=remat) * torch.from_numpy(w)).mean() \
            .backward()
        got = {n: p.grad.numpy() for n, p in model.named_parameters()
               if n.startswith(("encoder.", "enc_norm"))}
        got["frames"] = x.grad.numpy()
        grads.append(got)
    base._assert_trees(grads[0], want, base.GRAD_TOL, "encoder grad")
    for name, g in grads[0].items():
        np.testing.assert_array_equal(g, grads[1][name], err_msg=name)


# ------------------------------------------------------ optimizer and step


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, variant, n_steps):
    key, changes = VARIANTS[variant]
    got = base._run_steps(key, n_steps, arch=arch, opt_changes=changes)
    _assert_step(got, n_steps, n_steps)
    if changes:
        st = got[1]
        assert set(st["v"]["tok_embed"]) == {"row", "col"}
        assert st["m"]["tok_embed"].dtype == torch.float32


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_in_row_blocks_match_reference(arch, variant, monkeypatch):
    """Three steps with each matrix updated in blocks of rows of at most
    SMALL_BLOCK elements (a factored matrix's column statistic summed
    over the blocks) against the reference's whole-leaf update."""
    monkeypatch.setattr(opt, "UPDATE_BLOCK", SMALL_BLOCK)
    key, changes = VARIANTS[variant]
    _assert_step(base._run_steps(key, 3, arch=arch, opt_changes=changes),
                 3, 3)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_from_carried_reference_state_matches(arch, variant):
    """Two reference steps, their params and optimizer state (whisper's
    ``encoder`` moments, factored ones included) carried into the port,
    then one more step on each."""
    key, changes = VARIANTS[variant]
    got = base._run_steps(key, 1, start=2, arch=arch, opt_changes=changes)
    _assert_step(got, 1, 3)
    if arch == "whisper-small":
        names = base._port_flat(got[1]["m"])
        assert {f"encoder.{i}.attn.wq" for i in range(2)} <= set(names)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_microbatches_match_reference(arch):
    """The reference's step splits every leaf of the batch into
    microbatches: the port's splits ``frames`` and ``vision_embeds`` with
    the tokens."""
    _assert_step(base._run_steps("microbatches-2", 1, arch=arch), 1, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_microbatches_equal_one_batch(arch, monkeypatch):
    """The port's accumulated gradients of two microbatches (``frames``
    and ``vision_embeds`` split with the tokens), as the step hands them
    to the optimizer, against one batch's, and the losses; float32,
    GRAD_TOL. Each microbatch's loss is the mean over its own labels, so
    every row takes as many (all but the vision tokens' and the last)."""
    rcfg, tcfg = base._configs(arch)
    batch = base._batch(tcfg, b=4, s=24, seed=7)
    batch["labels"] = np.concatenate(
        [batch["tokens"][:, 1:], -np.ones((4, 1), np.int32)], 1)
    batch["labels"][:, :tcfg.vision_tokens] = -1
    np_params = base._weights(rcfg)
    seen = []

    def keep_grads(params, grads, state, cfg):
        seen.append({k: g.numpy().copy() for k, g in grads.items()})
        return params, state, {}
    monkeypatch.setattr(ts, "apply_updates", keep_grads)
    losses = []
    for n in (1, 2):
        model = lm_params_from_arrays(tcfg, np_params,
                                      device="cpu").requires_grad_()
        ocfg = opt.OptimizerConfig()
        step = ts.make_train_step(tcfg, ocfg, ts.TrainConfig(microbatches=n))
        _, _, m = step(model, opt.init_state(dict(model.named_parameters()),
                                             ocfg), base._port(batch))
        losses.append(float(m["total_loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=base.LOSS_RTOL)
    base._assert_trees(seen[1], seen[0], base.GRAD_TOL, "microbatch grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_follows_the_reference_leaf_rank(arch):
    """Every parameter's ``reference_ndim`` is the rank of the reference
    leaf holding it: whisper's encoder layers' norm scales and biases and
    the decoder's ``xattn_norm`` and biases are stacked ``[L, ...]`` there
    and decay; ``enc_norm`` and ``final_norm`` do not."""
    rcfg, tcfg = base._configs(arch)
    ref = jax.tree.map(np.asarray,
                       R.init_params(jax.random.PRNGKey(0), rcfg))
    ndim = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] in opt.STACKS:
            for i in range(leaf.shape[0]):
                ndim[".".join([keys[0], str(i)] + keys[1:])] = leaf.ndim
        else:
            ndim[".".join(keys)] = leaf.ndim
    model = T.init_params(tcfg, device="cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(ndim)
    for name, p in params.items():
        assert opt.reference_ndim(name, p) == ndim[name], name
    decays = {n for n, p in params.items() if opt.reference_ndim(n, p) >= 2}
    assert "final_norm" not in decays
    if arch == "whisper-small":
        assert "enc_norm" not in decays
        assert {"encoder.0.attn_norm", "encoder.1.mlp.b_out",
                "blocks.0.xattn_norm", "blocks.1.attn.bq",
                "blocks.0.mlp.b_fc"} <= decays


# ------------------------------------------------------- the vision overlay


def test_tok_embed_takes_no_gradient_from_the_overlaid_positions():
    """Tokens under the vision embeddings (ids of their own, found nowhere
    else) leave their ``tok_embed`` rows' gradient exactly zero in both
    packages, where a text token's row has one; redrawing those tokens
    leaves the loss and every gradient of the port unchanged, bit for bit
    (their labels are -1 and their embeddings overlaid)."""
    rcfg, tcfg = base._configs("internvl2-76b")
    vt = rcfg.vision_tokens
    np_params = base._weights(rcfg)
    batch = base._batch(rcfg, b=2, s=24, seed=4)
    rng = np.random.default_rng(5)
    batch["tokens"] = rng.integers(100, rcfg.vocab_size, (2, 24)) \
        .astype(np.int32)
    batch["tokens"][:, :vt] = np.arange(2 * vt).reshape(2, vt)
    assert (batch["labels"][:, :vt] == -1).all()
    own = np.arange(2 * vt)

    def port(b):
        model = lm_params_from_arrays(tcfg, np_params,
                                      device="cpu").requires_grad_()
        total, _ = ts.loss_fn(model, base._port(b), tcfg, ts.TrainConfig())
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(total, params)
        return float(total.detach()), {n: g.numpy()
                                       for n, g in zip(names, grads)}

    total, grads = port(batch)
    (r_total, _), r_grads = jax.value_and_grad(ref_ts.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params), base._ref(batch), rcfg,
        ref_ts.TrainConfig())
    r_embed = np.asarray(r_grads["tok_embed"])
    for g in (grads["tok_embed"], r_embed):
        assert (g[own] == 0).all()
        assert np.abs(g[batch["tokens"][0, vt]]).max() > 0
    np.testing.assert_allclose(total, float(r_total), rtol=base.LOSS_RTOL)

    redrawn = dict(batch, tokens=batch["tokens"].copy())
    redrawn["tokens"][:, :vt] = rng.integers(0, rcfg.vocab_size, (2, vt))
    total2, grads2 = port(redrawn)
    assert total2 == total
    for name, g in grads.items():
        if name != "tok_embed":
            np.testing.assert_array_equal(grads2[name], g, err_msg=name)
    keep = np.setdiff1d(np.arange(rcfg.vocab_padded),
                        np.concatenate([own, redrawn["tokens"][:, :vt]
                                        .ravel()]))
    np.testing.assert_array_equal(grads2["tok_embed"][keep],
                                  grads["tok_embed"][keep])


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("arch", ARCHS)
def test_the_trainer_steps_the_family_on_the_cpu(arch):
    """``launch/train.py``'s own setup and step on REDUCED (its bf16,
    ``batch_at``'s frames or vision embeddings): three steps, every loss
    and gradient norm finite, and ``main`` runs to its last step."""
    args = trainer.parser().parse_args([
        "--arch", arch, "--device", "cpu", "--steps", "3", "--batch", "4",
        "--seq", "32"])
    cfg, dcfg, model, state, step = trainer.setup(args)
    assert cfg.family == {"whisper-small": "audio",
                          "internvl2-76b": "vlm"}[arch]
    for s in range(3):
        batch = batch_at(dcfg, cfg, s, device="cpu")
        assert {"frames", "vision_embeds"} & set(batch)
        model, state, m = step(model, state, batch)
        assert np.isfinite(float(m["loss"])), (s, m)
        assert np.isfinite(float(m["grad_norm"])), (s, m)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    out = trainer.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16"])
    assert np.isfinite(out["loss"])
