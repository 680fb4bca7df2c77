"""The port's Mamba-2 SSD (``repro_torch.models.ssm``) and the ssm family
(mamba2-370m) against the reference on the same weights and inputs.

Weights come from the reference's ``init_ssm`` / ``init_params`` (the
zero-initialised ``conv_b`` and norms perturbed, so that they matter),
as numpy, carried into the port; inputs are numpy from a seed. Float32
results agree to 1e-4 of the largest magnitude (the two packages sum in
other orders: the SSD's einsums, the cumulative sum of dA, the decode's
conv window), with identical greedy tokens; bfloat16 results to 2^-5 of
the largest magnitude (XLA and PyTorch round bf16 products and casts at
other places; a few bf16 steps of the output).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCH = "mamba2-370m"
F32_REL = 1e-4
BF16_REL = 2 ** -5
DTYPES = ("float32", "bfloat16")


def _configs(dtype="float32", arch=ARCH, **changes):
    """(reference cfg, port cfg) of ``arch`` REDUCED with ``changes``."""
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype=dtype,
                                     **changes)
                 for get in (ref_get_config, get_config))


def _perturb(params, seed=0):
    """Numpy params with every norm and ``conv_b`` redrawn (they start at
    zero)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "conv_b" in name:
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, jax.tree.map(np.asarray, params))


def _layer(dtype, arch=ARCH, seed=0, **changes):
    """(ref cfg, port cfg, one SSD layer's reference params as numpy)."""
    rcfg, tcfg = _configs(dtype, arch, **changes)
    params = ref_ssm.init_ssm(jax.random.PRNGKey(seed), rcfg,
                              jnp.dtype(dtype))
    return rcfg, tcfg, _perturb(params, seed)


def _pair(dtype="float32", arch=ARCH, **changes):
    """(ref cfg, ref params, port cfg, port model) on the same weights."""
    rcfg, tcfg = _configs(dtype, arch, **changes)
    np_params = _perturb(R.init_params(jax.random.PRNGKey(0), rcfg))
    return (rcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            lm_params_from_arrays(tcfg, np_params, device="cpu"))


def _t(a):
    """numpy (bf16 included) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(shape, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.dtype(dtype)))


def _close(got, want, dtype, what=""):
    """Within 1e-4 (f32) or 2^-5 (bf16) of the largest magnitude of
    ``want``; dtypes equal."""
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == want.dtype.name, what
    want = want.astype(np.float32)
    rel = F32_REL if dtype == "float32" else BF16_REL
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_the_reference(reduced):
    ref = ref_get_config(ARCH, reduced=reduced)
    got = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for attr in ("d_inner", "ssm_heads", "is_attention_free",
                 "sub_quadratic", "vocab_padded"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()


# -------------------------------------------------------------- the layer

@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype):
    rcfg, _, p = _layer(dtype)
    xbc = _x((2, 11, rcfg.d_inner + 2 * rcfg.ssm_state), dtype)
    want = ref_ssm._causal_conv(jnp.asarray(xbc), jnp.asarray(p["conv_w"]),
                                jnp.asarray(p["conv_b"]))
    got = ssm._causal_conv(_t(xbc), _t(p["conv_w"]), _t(p["conv_b"]))
    _close(got, want, dtype)


# S < K - 1; S < chunk (32); ragged over three chunks; a whole number
SEQS = [2, 20, 75, 64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", SEQS)
def test_ssd_forward_matches_reference(s, dtype):
    rcfg, tcfg, p = _layer(dtype)
    x = _x((2, s, rcfg.d_model), dtype)
    want = ref_ssm.ssd_forward(_j(p), jnp.asarray(x), rcfg)
    got = ssm.ssd_forward({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(got, want, dtype, f"S={s}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", SEQS)
def test_ssd_forward_state_matches_reference(s, dtype):
    rcfg, tcfg, p = _layer(dtype)
    x = _x((2, s, rcfg.d_model), dtype)
    want, want_st = ref_ssm.ssd_forward(_j(p), jnp.asarray(x), rcfg,
                                        return_state=True)
    got, st = ssm.ssd_forward({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                              return_state=True)
    _close(got, want, dtype, f"S={s} out")
    assert st["h"].dtype == torch.float32
    assert tuple(st["conv"].shape) == want_st["conv"].shape
    _close(st["h"], want_st["h"], dtype, f"S={s} h")
    # the raw conv inputs are the in_proj output: equal up to its rounding
    _close(st["conv"], want_st["conv"], dtype, f"S={s} conv")
    if s < rcfg.ssm_conv - 1:   # left-padded with zeros
        assert (st["conv"][:, :rcfg.ssm_conv - 1 - s] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step_matches_reference(dtype):
    rcfg, tcfg, p = _layer(dtype)
    rng = np.random.default_rng(4)
    shapes = ssm.ssm_cache_shapes(tcfg, 3)
    assert shapes == ref_ssm.ssm_cache_shapes(rcfg, 3)
    h = rng.standard_normal(shapes["h"]).astype(np.float32)
    conv = _x(shapes["conv"], dtype, seed=5)
    rcache = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    tcache = {"h": _t(h), "conv": _t(conv)}
    tp = {k: _t(v) for k, v in p.items()}
    for step in range(3):
        x = _x((3, 1, rcfg.d_model), dtype, seed=10 + step)
        want, rcache = ref_ssm.ssd_decode_step(_j(p), jnp.asarray(x), rcache,
                                               rcfg)
        got, tcache = ssm.ssd_decode_step(tp, _t(x), tcache, tcfg)
        _close(got, want, dtype, f"step {step} y")
        _close(tcache["h"], rcache["h"], dtype, f"step {step} h")
        _close(tcache["conv"], rcache["conv"], dtype, f"step {step} conv")


def test_decode_steps_continue_the_chunked_forward():
    """Within the port, in f32: a prefix's ``ssd_forward`` state, then
    one ``ssd_decode_step`` a token, gives the full sequence's chunked
    output (ragged chunks and the inter-chunk recurrence included)."""
    _, tcfg, p = _layer("float32")
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(_x((2, 70, tcfg.d_model), "float32"))
    full = ssm.ssd_forward(tp, x, tcfg)
    _, state = ssm.ssd_forward(tp, x[:, :40], tcfg, return_state=True)
    steps = []
    for t in range(40, 70):
        y, state = ssm.ssd_decode_step(tp, x[:, t:t + 1], state, tcfg)
        steps.append(y)
    got = torch.cat(steps, 1)
    want = full[:, 40:]
    assert float((got - want).abs().max()) \
        <= F32_REL * float(want.abs().max())


def test_ssd_forward_is_finite_with_finite_gradients_under_large_dA():
    """dt * A of order -1e3 a step makes the upper triangle's exponent
    +1e5: the mask clamps the exponent, so nothing overflows, in the
    forward or the gradient."""
    _, tcfg, p = _layer("float32")
    tp = {k: _t(v) for k, v in p.items()}
    tp["A_log"] = torch.full_like(tp["A_log"], np.log(1e3))
    tp["dt_bias"] = torch.full_like(tp["dt_bias"], 5.0)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    x = _t(_x((2, 75, tcfg.d_model), "float32")).requires_grad_()
    out, state = ssm.ssd_forward(tp, x, tcfg, return_state=True)
    assert torch.isfinite(out).all() and torch.isfinite(state["h"]).all()
    (out.square().sum() + state["h"].sum()).backward()
    for name, t in [("x", x), *tp.items()]:
        assert torch.isfinite(t.grad).all(), name


def test_init_ssm_follows_the_reference_init():
    _, tcfg = _configs("bfloat16", ARCH)
    layer = ssm.SSM(tcfg, torch.bfloat16, "cpu")
    ssm.init_ssm(layer, torch.Generator().manual_seed(0))
    want = ref_ssm.init_ssm(jax.random.PRNGKey(0), tcfg, jnp.bfloat16)
    for name, w in layer.named_parameters():
        assert tuple(w.shape) == want[name].shape, name
        assert str(w.dtype).split(".")[-1] == want[name].dtype.name, name
    a = torch.exp(layer.A_log)
    assert ((a >= 1.0) & (a < 16.0)).all()
    dt = torch.nn.functional.softplus(layer.dt_bias)
    assert ((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all()
    assert (layer.D == 1).all() and (layer.conv_b == 0).all() \
        and (layer.ssm_norm == 0).all()
    assert float(layer.in_proj.float().std()) == pytest.approx(
        tcfg.d_model ** -0.5, rel=0.1)


# -------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def mamba_f32():
    return _pair()


def test_forward_matches_reference(mamba_f32):
    rcfg, rparams, tcfg, model = mamba_f32
    tok = _tokens(rcfg, 2, 75)
    want = R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, "float32")


def test_prefill_and_decode_match_reference(mamba_f32):
    rcfg, rparams, tcfg, model = mamba_f32
    tok = _tokens(rcfg, 2, 37)
    rl, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok)}, rcfg,
                           max_len=42)
    tl, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok)}, tcfg,
                           max_len=42)
    _close(tl, rl, "float32", "prefill logits")
    assert set(tcache) == set(rcache) == {"h", "conv"}
    for key in rcache:
        _close(tcache[key], rcache[key], "float32", key)
    nxt = np.asarray(jnp.argmax(rl[:, -1:, :rcfg.vocab_size], -1))
    for t in range(4):
        rl, rcache = R.decode_step(rparams, jnp.asarray(nxt), rcache, 37 + t,
                                   rcfg)
        tl, tcache = T.decode_step(model, torch.from_numpy(nxt), tcache,
                                   37 + t, tcfg)
        _close(tl, rl, "float32", f"step {t}")
        nxt = np.asarray(jnp.argmax(rl[:, :, :rcfg.vocab_size], -1))
        assert (tl[:, :, :tcfg.vocab_size].argmax(-1).numpy() == nxt).all()


def test_engine_generate_matches_reference(mamba_f32):
    rcfg, rparams, tcfg, model = mamba_f32
    tok = _tokens(rcfg, 3, 40)
    want = RefEngine(rcfg, rparams, RefServeConfig(max_new_tokens=6)) \
        .generate({"tokens": jnp.asarray(tok)})
    got = Engine(tcfg, model, ServeConfig(max_new_tokens=6)).generate(
        {"tokens": torch.from_numpy(tok)})
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bf16_forward_and_decode_within_bf16_tolerance():
    rcfg, rparams, tcfg, model = _pair("bfloat16")
    tok = _tokens(rcfg, 2, 75)
    want = R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    _close(T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg), want,
           "bfloat16")
    rl, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok)}, rcfg,
                           max_len=80)
    tl, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok)}, tcfg,
                           max_len=80)
    assert tcache["h"].dtype == torch.float32
    assert tcache["conv"].dtype == torch.bfloat16
    nxt = np.asarray(jnp.argmax(rl[:, -1:, :rcfg.vocab_size], -1))
    want, _ = R.decode_step(rparams, jnp.asarray(nxt), rcache, 75, rcfg)
    got, _ = T.decode_step(model, torch.from_numpy(nxt), tcache, 75, tcfg)
    _close(got, want, "bfloat16", "decode step")


def test_init_cache_matches_reference():
    rcfg, tcfg = _configs("bfloat16")
    want = R.init_cache(rcfg, 3, 20)
    got = T.init_cache(tcfg, 3, 20, device="cpu")
    assert set(got) == set(want) == {"h", "conv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == want[key].dtype.name


def test_init_params_has_the_reference_layout():
    rcfg, tcfg = _configs("bfloat16")
    want = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0),
                                                  rcfg))
    model = T.init_params(tcfg, seed=0, device="cpu")
    again = lm_params_from_arrays(tcfg, want, device="cpu")
    for (name, w), (_, c) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert w.shape == c.shape and w.dtype == c.dtype, name
    assert model.blocks[1].ssm.A_log.dtype == torch.float32
    assert model.blocks[1].ssm.in_proj.dtype == torch.bfloat16
    assert not hasattr(model.blocks[0], "attn")
    assert torch.equal(T.init_params(tcfg, seed=0, device="cpu")
                       .blocks[1].ssm.conv_w, model.blocks[1].ssm.conv_w)


def test_carry_keeps_the_f32_leaves_and_refuses_a_missing_ssm_leaf():
    rcfg, tcfg = _configs("bfloat16")
    params = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    model = lm_params_from_arrays(tcfg, params, device="cpu")
    np.testing.assert_array_equal(model.blocks[1].ssm.A_log.numpy(),
                                  params["blocks"]["ssm"]["A_log"][1])
    np.testing.assert_array_equal(
        model.blocks[0].ssm.out_proj.float().numpy(),
        params["blocks"]["ssm"]["out_proj"][0].astype(np.float32))
    missing = {k: dict(v) if isinstance(v, dict) else v
               for k, v in params.items()}
    missing["blocks"]["ssm"] = dict(missing["blocks"]["ssm"])
    del missing["blocks"]["ssm"]["dt_bias"]
    with pytest.raises(ValueError, match="dt_bias"):
        lm_params_from_arrays(tcfg, missing, device="cpu")
    wrong = {k: dict(v) if isinstance(v, dict) else v
             for k, v in params.items()}
    wrong["blocks"]["ssm"] = dict(wrong["blocks"]["ssm"],
                                  D=np.zeros((rcfg.n_layers, 3), np.float32))
    with pytest.raises(ValueError, match="D"):
        lm_params_from_arrays(tcfg, wrong, device="cpu")


def test_batch_at_serves_the_ssm_family():
    _, tcfg = _configs()
    batch = batch_at(DataConfig(batch_size=2, seq_len=9), tcfg, 0,
                     device="cpu")
    assert batch["tokens"].shape == (2, 9)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, reduced=True)
    for call in (lambda: T.init_params(cfg), lambda: T.init_cache(cfg, 1, 4),
                 lambda: lm_params_from_arrays(cfg, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
