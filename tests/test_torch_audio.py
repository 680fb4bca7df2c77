"""The audio family (whisper-small) against the reference: ``layer_norm``,
the sinusoidal table, the fc-GELU-fc feed-forward, the encoder, the
cross-attention, the model's forward, prefill (its ``xk``/``xv`` cache),
decode and ``Engine.generate``, the parameter layout and the carry of the
``encoder`` and ``xattn`` leaves (training:
``tests/test_torch_modal_train.py``).

Weights come from the reference's ``init_params`` (norms and biases
perturbed so that ``1 + scale`` and the biases matter), carried into the
port with ``repro_torch.carry.lm_params_from_arrays``; tokens and frame
embeddings are numpy from a seed. In float32 the two packages differ
only in the order of float32 sums (and the reference's chunked online
softmax against one softmax): logits within 1e-4 absolute (``F32_TOL``)
and identical greedy tokens. In bfloat16 the logits are held to 0.1
absolute, the dense family's bound (``tests/test_torch_lm.py``); they
measured 0.031 apart.

The reference's chunked attention pads K and V with zeros to a multiple
of its chunk (512) and only a causal mask hides them, so its encoder's
full attention over a ragged last chunk attends to zero keys; the port
attends to the real keys only. At ``enc_frames = 516`` the port's encoder
equals the reference's computed through ``attention_reference`` and
differs from the reference's own by what the four zero keys carry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCH = "whisper-small"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.1
BIASES = ("['bq']", "['bk']", "['bv']", "['b_fc']", "['b_out']")


def _configs(dtype="float32", **changes):
    return tuple(dataclasses.replace(get(ARCH, reduced=True), dtype=dtype,
                                     **changes)
                 for get in (ref_get_config, get_config))


def _weights(cfg, seed=0):
    """The reference's params as numpy, norms and biases perturbed."""
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or name.endswith(BIASES):
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, params)


def _pair(dtype="float32", **changes):
    """(ref cfg, ref params, port cfg, port model) on the same weights."""
    rcfg, tcfg = _configs(dtype, **changes)
    np_params = _weights(rcfg)
    return (rcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            lm_params_from_arrays(tcfg, np_params, device="cpu"))


def _batch(cfg, b, s, seed=1):
    """numpy {"tokens" [b, s], "frames" [b, enc_frames, d] f32}."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "frames": rng.standard_normal((b, cfg.enc_frames, cfg.d_model))
            .astype(np.float32)}


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def f32():
    return _pair()


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """f32 inside, ``1 + scale`` and the bias, rounded once to the input's
    dtype: 1e-6 in float32; in bfloat16 the two round the same f32 value
    (within 1e-6) to bf16, at most one bf16 step apart (2^-7 relative)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 48)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(48).astype(np.float32) * 0.1
                   for _ in range(2))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    got = tlayers.layer_norm(tx, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    want = np.asarray(ref_layers.layer_norm(jx, jnp.asarray(scale),
                                            jnp.asarray(bias)), np.float32)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("length,dim", [(1500, 768), (30, 64), (516, 16)])
def test_sinusoidal_embedding_is_the_reference_table_bit_for_bit(length,
                                                                 dim):
    got = tlayers.sinusoidal_embedding(length, dim)
    want = ref_layers.sinusoidal_embedding(length, dim)
    assert got.dtype == np.float32 and got.shape == (length, dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_gelu_mlp_matches_reference_only_with_the_tanh_gelu(f32, gelu):
    """``jax.nn.gelu`` is the tanh approximation: the port's ``GeluMLP``
    agrees to 1e-5; the same MLP with torch's default (erf) GELU is more
    than 1e-4 off, so this test tells the two apart."""
    rcfg, rparams, _, model = f32
    x = np.random.default_rng(2).standard_normal((2, 9, rcfg.d_model)) \
        .astype(np.float32) * 2
    p = jax.tree.map(lambda a: a[0], rparams["blocks"])["mlp"]
    want = np.asarray(ref_model._mlp(p, jnp.asarray(x), rcfg))
    mlp = model.blocks[0].mlp
    tx = torch.from_numpy(x)
    if gelu == "tanh":
        np.testing.assert_allclose(mlp(tx).numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    else:
        h = torch.nn.functional.gelu(tx @ mlp.w_fc + mlp.b_fc)
        erf = (h @ mlp.w_out + mlp.b_out).numpy()
        assert np.abs(erf - want).max() > 1e-4


# ------------------------------------------------------ encoder, cross-attn

def test_encoder_matches_reference(f32):
    rcfg, rparams, tcfg, model = f32
    frames = _batch(rcfg, 2, 4)["frames"]
    want = ref_model._encode(rparams, rcfg, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    assert got.shape == (2, rcfg.enc_frames, rcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_cross_attention_matches_reference(f32):
    """Layer 1's cross-attention of a normed decoder stream over an
    encoder output: the residual sum and the keys and values the decode
    cache keeps."""
    rcfg, rparams, _, model = f32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, rcfg.enc_frames, rcfg.d_model)) \
        .astype(np.float32)
    p = jax.tree.map(lambda a: a[1], rparams["blocks"])
    h = ref_layers.rms_norm(jnp.asarray(x), p["xattn_norm"], rcfg.norm_eps)
    xo, (xk, xv) = ref_model._xattn_full(p["xattn"], h, jnp.asarray(enc),
                                         rcfg)
    got, gk, gv = model.blocks[1].cross(torch.from_numpy(x),
                                        torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), x + np.asarray(xo), **F32_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(xk), **F32_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(xv), **F32_TOL)


def _reference_attention_oracle(q, k, v, *, q_pos=None, k_pos=None,
                                causal=True, **kw):
    """The reference's ``attention`` signature over its unchunked
    ``attention_reference``."""
    return ref_attn.attention_reference(q, k, v, causal=causal, **kw)


def test_encoder_attends_to_the_real_keys_of_a_ragged_last_chunk(
        monkeypatch):
    """At 516 frames (one 512-frame chunk and a ragged one) the port's
    encoder equals the reference's ``_encode`` through its unchunked
    oracle, and the reference's own ``_encode`` is off by what its four
    zero keys carry: 0.952 at most (0.174 on average) in an output of
    unit RMS, against f32 rounding of 1e-5."""
    rcfg, rparams, tcfg, model = _pair(enc_frames=516)
    frames = _batch(rcfg, 1, 4, seed=5)["frames"]
    got = model.encode(torch.from_numpy(frames)).numpy()
    padded = np.asarray(ref_model._encode(rparams, rcfg,
                                          jnp.asarray(frames)))
    monkeypatch.setattr(ref_model, "attention", _reference_attention_oracle)
    want = np.asarray(ref_model._encode(rparams, rcfg, jnp.asarray(frames)))
    np.testing.assert_allclose(got, want, **F32_TOL)
    err = np.abs(got - padded)
    assert 0.5 < err.max() < 2 and 0.05 < err.mean() < 0.3


# -------------------------------------------------------------------- model

def test_forward_matches_reference(f32):
    rcfg, rparams, tcfg, model = f32
    batch = _batch(rcfg, 2, 37)
    want = np.asarray(R.forward(rparams, _ref(batch), rcfg))
    got = T.forward(model, _port(batch), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_bf16_forward_within_bf16_tolerance():
    rcfg, rparams, tcfg, model = _pair("bfloat16")
    batch = _batch(rcfg, 2, 24, seed=6)
    want = np.asarray(R.forward(rparams, _ref(batch), rcfg))
    got = T.forward(model, _port(batch), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_prefill_and_four_decode_steps_match_reference(f32):
    """The prefill's logits and cache (``k``, ``v``, and the
    cross-attention's ``xk``, ``xv`` over the encoder's output), then four
    decode steps in turn, each against the reference's step and against
    the teacher-forced forward at the same position."""
    rcfg, rparams, tcfg, model = f32
    b, s, extra = 2, 16, 4
    batch = _batch(rcfg, b, s + extra, seed=2)
    prompt = dict(batch, tokens=batch["tokens"][:, :s])
    rlog, rcache = R.prefill(rparams, _ref(prompt), rcfg, max_len=s + extra)
    tlog, tcache = T.prefill(model, _port(prompt), tcfg, max_len=s + extra)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)
    assert set(tcache) == set(rcache) == {"k", "v", "xk", "xv"}
    for key in tcache:
        assert tcache[key].shape == rcache[key].shape, key
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(rcache[key]), **F32_TOL)
    full = T.forward(model, _port(batch), tcfg)
    tok = batch["tokens"]
    for t in range(extra):
        step = tok[:, s + t: s + t + 1]
        rlog, rcache = R.decode_step(rparams, jnp.asarray(step), rcache,
                                     s + t, rcfg)
        tlog, tcache = T.decode_step(model, torch.from_numpy(step), tcache,
                                     s + t, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)
        np.testing.assert_allclose(tlog[:, 0], full[:, s + t], **F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(rcache[key]), **F32_TOL)


def test_engine_generate_matches_reference(f32):
    rcfg, rparams, tcfg, model = f32
    prompt = _batch(rcfg, 3, 21, seed=4)
    want = RefEngine(rcfg, rparams, RefServeConfig(max_new_tokens=8)) \
        .generate(_ref(prompt))
    got = Engine(tcfg, model, ServeConfig(max_new_tokens=8)) \
        .generate(prompt)   # numpy arrays, moved to the model's device
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    # the frames reach the prefill: other frames, other tokens
    other = dict(prompt, frames=prompt["frames"][::-1].copy())
    assert not np.array_equal(
        Engine(tcfg, model, ServeConfig(max_new_tokens=8)).generate(other),
        got)


# ------------------------------------------------------- weights, data, trainer

def test_init_params_has_the_reference_layout():
    rcfg, tcfg = _configs("bfloat16")
    shapes = jax.eval_shape(lambda: R.init_params(jax.random.PRNGKey(0),
                                                  rcfg))
    flat = {jax.tree_util.keystr(p): s.shape for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = T.init_params(tcfg, seed=0, device="cpu")
    got = dict(model.named_parameters())
    stacks = {"blocks": rcfg.n_layers, "encoder": rcfg.enc_layers}
    want = {}
    for name, shape in flat.items():
        parts = [p.strip("[]'") for p in name.split("][")]
        for i in range(stacks.get(parts[0], 0)):
            want[".".join([parts[0], str(i)] + parts[1:])] = shape[1:]
        if parts[0] not in stacks:
            want[".".join(parts)] = shape
    assert {n: tuple(t.shape) for n, t in got.items()} == want
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    blk = model.blocks[0]
    assert (blk.mlp.b_fc == 0).all() and (blk.xattn.bq == 0).all()
    assert blk.xattn.wq.float().std() > 0 and model.encoder[1].mlp.w_out \
        .float().std() > 0


@pytest.mark.parametrize("leaf", [("encoder", "attn", "wq"), ("enc_norm",),
                                  ("blocks", "xattn", "wk"),
                                  ("blocks", "xattn_norm")])
def test_carry_refuses_a_missing_encoder_or_cross_attention_leaf(leaf):
    rcfg, tcfg = _configs()
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(0), rcfg))
    node = params
    for key in leaf[:-1]:
        node = node[key]
    del node[leaf[-1]]
    with pytest.raises(ValueError, match="missing: .*" + leaf[-1]):
        lm_params_from_arrays(tcfg, params, device="cpu")


def test_batch_at_draws_frames_after_the_tokens():
    cfg = get_config(ARCH, reduced=True)
    dcfg = DataConfig(seed=3, batch_size=2, seq_len=20)
    a = batch_at(dcfg, cfg, 5, device="cpu")
    assert set(a) == {"tokens", "labels", "frames"}
    assert a["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
    assert a["frames"].dtype == torch.float32
    assert abs(float(a["frames"].std()) - 1) < 0.05
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    dense = batch_at(dcfg, get_config("tinyllama-1.1b", reduced=True), 5,
                     device="cpu")   # the same vocabulary and stream
    assert torch.equal(a["tokens"], dense["tokens"])
    assert torch.equal(a["frames"],
                       batch_at(dcfg, cfg, 5, device="cpu")["frames"])
