"""Training of the ssm (mamba2-370m) and hybrid (hymba-1.5b) families in
the port against the reference, on the same weights and tokens.

The helpers and tolerances are ``tests/test_torch_train.py``'s: the
reference's ``init_params`` (norms perturbed) carried with
``lm_params_from_arrays``, its optimizer state with
``opt_state_from_arrays``, numpy tokens from a seed, REDUCED configs in
float32. Batches are 72 tokens long: past mamba2's 32-token SSD chunk
(ragged: 2 chunks and 8 tokens) and, with hymba's 8 meta tokens, 80 slots
past its 32-key window, so the window masks in the forward and in the
backward (layer 1; layer 0 is global). Checked:

* the loss and every gradient against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` (the SSD's backward is autograd's; hymba's
  attention backward is ``flash_attention_bwd_plain`` with the window and
  meta tokens, through ``FlashAttention``);
* parameters and moments after 1 and 3 steps, and one step from carried
  reference state, for every step variant (plain AdamW, factored with
  bf16 state at ``min_dim_size_to_factor`` 16, two microbatches). With
  bf16 state, consecutive steps of the two packages drift apart by
  rounding flips (an f32 difference in the last bits of a moment rounds
  to the other bf16 neighbour, and the next step carries it: measured
  after three steps, up to 56 of the 32,768 ``tok_embed`` first-moment
  elements one bf16 step, 1.5e-5, apart, and up to 5 of the 4,096 of
  hymba's layer-0 ``wq`` 5.5e-5 apart, over the one in a thousand the
  tolerances allow), so its third step is held from the reference's
  state after two, as ``tests/test_torch_moe.py`` holds its steps, and
  the three consecutive steps are held element by element to the
  outlier bounds;
* at 16 layers the factored moment of a per-layer vector spans the
  layers, as the reference's stacked leaf does;
* the SSD's gradients against ``jax.grad`` of the reference's
  ``ssd_forward``, at a ragged and a whole number of chunks;
* 15 steps through ``launch/train.py``'s own setup that stay finite (the
  port's counterpart of ``tests/test_train_loop.py``'s
  ``test_mamba_trains_stably``), for both families.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import test_torch_train as base  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.training import train_step as ref_ts  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.data.lm import batch_at  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCHS = ("mamba2-370m", "hymba-1.5b")
SEQ = 72
# the SSD alone: within this share of each gradient's largest magnitude
# (tests/test_torch_ssm.py's float32 bound for the forward)
SSD_GRAD_REL = 1e-4
BF16_STATE = "factored-bf16-state"


def _assert_step(got, want, n_steps):
    """Parameters and both moments as test_torch_train holds them."""
    p, st, _, rp, rst, _ = got
    base._assert_trees(base._port_flat(p), base._per_layer(rp),
                       base.PARAM_TOL, "param",
                       **base._param_outliers(n_steps))
    for key in ("m", "v"):
        base._assert_trees(base._port_flat(st[key]),
                           base._per_layer(rst[key]), base.STEP_TOL, key,
                           **base.MOMENT_OUTLIERS)
    assert int(st["step"]) == int(rst["step"]) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    rcfg, tcfg = base._configs(arch)
    np_params = base._weights(rcfg)
    batch = base._batch(rcfg, s=SEQ)
    (r_total, r_aux), r_grads = jax.value_and_grad(
        ref_ts.loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, np_params), base._ref(batch), rcfg,
            ref_ts.TrainConfig(z_loss_weight=1e-3))
    model = lm_params_from_arrays(tcfg, np_params,
                                  device="cpu").requires_grad_()
    total, aux = ts.loss_fn(model, base._port(batch), tcfg,
                            ts.TrainConfig(z_loss_weight=1e-3))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params)
    np.testing.assert_allclose(float(total.detach()), float(r_total),
                               rtol=base.LOSS_RTOL)
    np.testing.assert_allclose(float(aux["loss"].detach()),
                               float(r_aux["loss"]), rtol=base.LOSS_RTOL)
    base._assert_trees({n: g.numpy() for n, g in zip(names, grads)},
                       base._per_layer(jax.tree.map(np.asarray, r_grads)),
                       base.GRAD_TOL, "grad")


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("variant", list(base.STEP_VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, variant, n_steps):
    """Steps 1 .. n_steps from the weights; with bf16 state, step n_steps
    from the reference's state before it (see the module docstring)."""
    start = n_steps - 1 if variant == BF16_STATE else 0
    got = base._run_steps(variant, n_steps - start, start=start, arch=arch,
                          seq=SEQ)
    _assert_step(got, n_steps, n_steps - start)
    for key in ("loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[2][key]), float(got[5][key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("variant", list(base.STEP_VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_from_carried_reference_state_matches(arch, variant):
    """Two reference steps, their params and optimizer state (factored
    moments included) carried into the port, then one more on each."""
    _assert_step(base._run_steps(variant, 1, start=2, arch=arch, seq=SEQ),
                 3, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_state_drifts_over_consecutive_steps_by_rounding_flips(arch):
    """Three consecutive steps with bf16 state: every parameter within the
    outlier bound of three steps (3 lr a step) and every moment within
    2^-7 of its value plus 1e-6 of the reference's, element by element
    (how many elements flip is what the module docstring measures)."""
    p, st, _, rp, rst, _ = base._run_steps(BF16_STATE, 3, arch=arch, seq=SEQ)
    bounds = [(base._port_flat(p), base._per_layer(rp),
               base._param_outliers(3)["outlier_atol"], 0.0)]
    bounds += [(base._port_flat(st[key]), base._per_layer(rst[key]),
                base.MOMENT_OUTLIERS["outlier_atol"],
                base.MOMENT_OUTLIERS["outlier_rtol"]) for key in ("m", "v")]
    for got, want, atol, rtol in bounds:
        assert got.keys() == want.keys()
        for name, w in want.items():
            err = np.abs(got[name] - w)
            assert (err <= atol + rtol * np.abs(w)).all(), \
                (name, float(err.max()))


def test_factored_moments_span_the_layers_of_a_stacked_vector():
    """At 16 layers and ``min_dim_size_to_factor`` 16 the reference
    factors its stacked [16, d] vector leaves (norm scales, ``conv_b``,
    ``ssm_norm``): one row entry a layer, one column over the layers.
    mamba2, f32 state (so that no bf16 rounding flip enters): one step
    from zero state, and one from the carried state of two reference
    steps. (Two consecutive steps at 16 layers and lr 1e-2 differ in
    thousands of near-eps elements even with plain AdamW.)"""
    kw = dict(arch="mamba2-370m", seq=SEQ, n_layers=16,
              opt_changes=dict(state_dtype="float32"))
    got = base._run_steps(BF16_STATE, 1, **kw)
    _assert_step(got, 1, 1)
    st = got[1]
    v = st["v"]["blocks.3.ssm.ssm_norm"]
    assert v["row"].shape == () and v["col"].shape == (128,)
    assert torch.equal(v["col"], st["v"]["blocks.11.ssm.ssm_norm"]["col"])
    assert not torch.equal(v["row"], st["v"]["blocks.11.ssm.ssm_norm"]["row"])
    _assert_step(base._run_steps(BF16_STATE, 1, start=2, **kw), 3, 1)


def test_weight_decay_and_factoring_follow_the_reference_leaves():
    """An SSD's [H] vectors and hymba's meta tokens decay (the reference's
    [L, H] and [128, d] leaves); per-layer vectors are factored together
    only where the stacked leaf reaches ``min_dim_size_to_factor`` in both
    dims."""
    h = torch.zeros(8)
    for name in ("blocks.0.ssm.A_log", "blocks.1.ssm.D",
                 "blocks.1.ssm.dt_bias"):
        assert opt.reference_ndim(name, h) == 2
    assert opt.reference_ndim("meta_tokens", torch.zeros(8, 64)) == 2
    params = {f"blocks.{i}.{n}": torch.zeros(d) for i in range(16)
              for n, d in (("ssm.A_log", 8), ("ssm.ssm_norm", 128))}
    params["final_norm"] = torch.zeros(64)
    cfg = opt.OptimizerConfig(factored=True, min_dim_size_to_factor=16)
    groups = opt.stacked_vectors(params, cfg)
    assert list(groups) == ["blocks.ssm.ssm_norm"]
    assert groups["blocks.ssm.ssm_norm"] == [f"blocks.{i}.ssm.ssm_norm"
                                             for i in range(16)]
    assert opt.stacked_vectors(params, opt.OptimizerConfig()) == {}


@pytest.mark.parametrize("s", [75, 256])
def test_ssd_gradients_match_reference_grad(s):
    """mamba2 REDUCED's SSD layer (32-token chunks: 75 is two chunks and
    a ragged 11, 256 eight whole ones) in float32: every weight's and the
    input's gradient of <ssd_forward(x), dy> by autograd against
    ``jax.grad`` of the reference's ``ssd_forward``."""
    rcfg, tcfg = base._configs("mamba2-370m")
    rng = np.random.default_rng(s)
    p = jax.tree.map(np.asarray, ref_ssm.init_ssm(jax.random.PRNGKey(s), rcfg,
                                                  jnp.float32))
    p = {k: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
         if k in ("conv_b", "ssm_norm") else a for k, a in p.items()}
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)

    def ref_fn(params, x_):
        return jnp.sum(ref_ssm.ssd_forward(params, x_, rcfg) * dy)
    r_gp, r_gx = jax.grad(ref_fn, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(a.copy()).requires_grad_() for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (ssm.ssd_forward(tp, tx, tcfg) * torch.from_numpy(dy)).sum().backward()
    got = {k: t.grad for k, t in tp.items()} | {"x": tx.grad}
    want = {k: np.asarray(g) for k, g in r_gp.items()} | {"x": r_gx}
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        assert err <= SSD_GRAD_REL * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_trains_stably_through_the_trainer_setup(arch):
    """15 steps of ``launch/train.py``'s own setup and step on REDUCED
    (the config's bf16, lr 1e-3, B=8 x S=64, ``batch_at``): the loss and
    the gradient norm stay finite at every step, as the reference's
    ``test_mamba_trains_stably`` requires of mamba2."""
    args = trainer.parser().parse_args([
        "--arch", arch, "--device", "cpu", "--steps", "30", "--batch", "8",
        "--seq", "64", "--lr", "1e-3"])
    cfg, dcfg, model, state, step = trainer.setup(args)
    assert cfg.family in ("ssm", "hybrid")
    for s in range(15):
        model, state, m = step(model, state,
                               batch_at(dcfg, cfg, s, device="cpu"))
        assert np.isfinite(float(m["loss"])), (s, m)
        assert np.isfinite(float(m["grad_norm"])), (s, m)
    assert all(torch.isfinite(p).all() for p in model.parameters())
