"""The hybrid family (hymba-1.5b) against the reference: the sliding
window and meta-token attention mask (the plain windowed attention
against the reference's ``attention_reference`` and its chunked jnp
``attention``, and ``decode_attention``), the model's forward, prefill,
decode and ``Engine.generate``, the per-layer global flags, the analytic
parameter counts of the ssm and hybrid configs, and the carry of the
``ssm`` and ``meta_tokens`` leaves.

Weights come from the reference's ``init_params`` (norms and ``conv_b``
perturbed), inputs are numpy from a seed. Float32 results agree to 1e-4
of the largest magnitude with identical greedy tokens; bfloat16 results
to 2^-5 of the largest magnitude (as ``tests/test_torch_ssm.py``).
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
from repro.models import model as ref_model  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCH = "hymba-1.5b"
F32_REL = 1e-4
BF16_REL = 2 ** -5
# the attention oracle against the plain version: f32 sums in other orders
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(dtype="float32", **changes):
    return tuple(dataclasses.replace(get(ARCH, reduced=True), dtype=dtype,
                                     **changes)
                 for get in (ref_get_config, get_config))


def _weights(cfg, seed=0):
    """The reference's params as numpy, norms and ``conv_b`` perturbed."""
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "conv_b" in name:
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, params)


def _pair(dtype="float32", **changes):
    rcfg, tcfg = _configs(dtype, **changes)
    np_params = _weights(rcfg)
    return (rcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            lm_params_from_arrays(tcfg, np_params, device="cpu"))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(got, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    rel = F32_REL if dtype == "float32" else BF16_REL
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _qkv(b, sq, sk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


# ----------------------------------------------------------------- the mask

# (Sq, Sk, window, meta_tokens, disable_window): Sq = Sk and Sq < Sk;
# windows of 1 key, shorter than the reference's chunk, and at least Sk
MASKS = [(40, 40, 1, 0, False), (40, 40, 5, 3, False), (40, 40, 16, 0, False),
         (40, 40, 16, 3, False), (40, 40, 16, 3, True), (13, 40, 7, 3, False),
         (13, 40, 7, 0, False), (1, 40, 9, 4, False), (13, 40, 7, 3, True),
         (40, 40, 64, 3, False)]


@pytest.mark.parametrize("sq,sk,window,meta,dw", MASKS)
def test_windowed_attention_matches_reference(sq, sk, window, meta, dw):
    q, k, v = _qkv(2, sq, sk, 10, 2, 16)
    kw = dict(causal=True, window=window, meta_tokens=meta)
    flag = jnp.asarray(dw)
    want = ref_attn.attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), disable_window=flag, **kw)
    chunked = ref_attn.attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 chunk=8, disable_window=flag, **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for got in (tattn.attention(tq, tk, tv, disable_window=dw, **kw),
                tattn.attention_reference(tq, tk, tv, disable_window=dw,
                                          **kw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(chunked),
                                   **ATTN_TOL)


def test_a_window_of_at_least_sk_is_causal_attention_exactly():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 30, 50, 4, 4, 16))
    causal = fa.flash_attention_plain(q, k, v)
    for window, meta in ((50, 0), (50, 7), (77, 3)):
        assert torch.equal(fa.flash_attention_plain(
            q, k, v, window=window, meta_tokens=meta), causal)
    # and a smaller one does mask something
    assert not torch.equal(fa.flash_attention_plain(q, k, v, window=49),
                           causal)


def test_window_refusals():
    x = torch.zeros((1, 4, 2, 16))
    for kw in (dict(causal=False, window=8), dict(window=-1),
               dict(window=4, meta_tokens=-2)):
        with pytest.raises(ValueError):
            ops.flash_attention(x, x, x, **kw)
        with pytest.raises(ValueError):
            fa.flash_attention_plain(x, x, x, **kw)


@pytest.mark.parametrize("window,meta,dw", [(6, 0, False), (6, 4, False),
                                            (6, 4, True), (0, 4, False)])
def test_decode_attention_matches_reference(window, meta, dw):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 10, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    for cur in (0, 5, 17, 39):
        got = tattn.decode_attention(
            *(torch.from_numpy(a) for a in (q, kc, vc)),
            k_pos=torch.arange(40), cur_pos=cur, window=window,
            meta_tokens=meta, disable_window=dw)
        want = ref_attn.decode_attention(
            *(jnp.asarray(a) for a in (q, kc, vc)), k_pos=jnp.arange(40),
            cur_pos=jnp.int32(cur), window=window, meta_tokens=meta,
            disable_window=jnp.asarray(dw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ["mamba2-370m", ARCH])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_matches_reference(arch, reduced):
    ref = ref_get_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert (got.sub_quadratic, got.is_attention_free) \
        == (ref.sub_quadratic, ref.is_attention_free)


@pytest.mark.parametrize("reduced", [False, True])
def test_global_flags_land_on_global_layers(reduced):
    cfg = get_config(ARCH, reduced=reduced)
    model = tmodel.LM(cfg, device="meta")
    flags = [blk.is_global for blk in model.blocks]
    assert flags == [i in cfg.global_layers for i in range(cfg.n_layers)]
    assert flags == np.asarray(ref_model._global_flags(
        ref_get_config(ARCH, reduced=reduced), cfg.n_layers)).tolist()
    assert any(flags) and not all(flags)


# -------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def hymba_f32():
    return _pair()


def test_forward_matches_reference(hymba_f32):
    rcfg, rparams, tcfg, model = hymba_f32
    # 45 tokens + 8 meta tokens: past the window of 32
    tok = _tokens(rcfg, 2, 45)
    want = R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    assert got.shape == want.shape == (2, 45, rcfg.vocab_padded)
    _close(got, want, "float32")


def test_prefill_and_decode_match_reference(hymba_f32):
    rcfg, rparams, tcfg, model = hymba_f32
    s, steps = 20, 20   # decode slides the window past the first keys
    tok = _tokens(rcfg, 2, s)
    rl, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok)}, rcfg,
                           max_len=s + steps)
    tl, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok)}, tcfg,
                           max_len=s + steps)
    _close(tl, rl, "float32", "prefill logits")
    assert set(tcache) == set(rcache) == {"k", "v", "h", "conv"}
    for key in rcache:
        assert tuple(tcache[key].shape) == rcache[key].shape, key
        _close(tcache[key], rcache[key], "float32", key)
    assert tcache["k"].shape[2] == s + steps + rcfg.meta_tokens
    assert s + steps + rcfg.meta_tokens > rcfg.attn_window + 8
    nxt = np.asarray(jnp.argmax(rl[:, -1:, :rcfg.vocab_size], -1))
    for t in range(steps):
        rl, rcache = R.decode_step(rparams, jnp.asarray(nxt), rcache, s + t,
                                   rcfg)
        tl, tcache = T.decode_step(model, torch.from_numpy(nxt.copy()),
                                   tcache, s + t, tcfg)
        _close(tl, rl, "float32", f"step {t}")
        nxt = np.asarray(jnp.argmax(rl[:, :, :rcfg.vocab_size], -1))
        assert (tl[:, :, :tcfg.vocab_size].argmax(-1).numpy() == nxt).all()
    for key in rcache:
        _close(tcache[key], rcache[key], "float32", key)


def test_engine_generate_matches_reference(hymba_f32):
    rcfg, rparams, tcfg, model = hymba_f32
    tok = _tokens(rcfg, 3, 30)
    want = RefEngine(rcfg, rparams, RefServeConfig(max_new_tokens=8)) \
        .generate({"tokens": jnp.asarray(tok)})
    got = Engine(tcfg, model, ServeConfig(max_new_tokens=8)).generate(
        {"tokens": torch.from_numpy(tok)})
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bf16_forward_and_decode_within_bf16_tolerance():
    rcfg, rparams, tcfg, model = _pair("bfloat16")
    tok = _tokens(rcfg, 2, 45)
    want = R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    _close(T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg), want,
           "bfloat16")
    rl, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok)}, rcfg,
                           max_len=50)
    tl, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok)}, tcfg,
                           max_len=50)
    nxt = np.asarray(jnp.argmax(rl[:, -1:, :rcfg.vocab_size], -1))
    want, _ = R.decode_step(rparams, jnp.asarray(nxt), rcache, 45, rcfg)
    got, _ = T.decode_step(model, torch.from_numpy(nxt.copy()), tcache, 45,
                           tcfg)
    _close(got, want, "bfloat16", "decode step")


def test_init_cache_matches_reference():
    rcfg, tcfg = _configs("bfloat16")
    want = R.init_cache(rcfg, 3, 20)
    got = T.init_cache(tcfg, 3, 20, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == want[key].dtype.name


def test_init_params_has_the_reference_layout():
    rcfg, tcfg = _configs("bfloat16")
    params = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    carried = lm_params_from_arrays(tcfg, params, device="cpu")
    model = T.init_params(tcfg, seed=0, device="cpu")
    got = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    assert got == {n: (tuple(p.shape), p.dtype)
                   for n, p in carried.named_parameters()}
    assert got["meta_tokens"] == ((8, 64), torch.bfloat16)
    assert got["blocks.1.ssm.dt_bias"][1] == torch.float32
    assert float(model.meta_tokens.float().std()) == pytest.approx(0.02,
                                                                   rel=0.2)


def test_carry_refuses_a_missing_ssm_or_meta_tokens_leaf():
    rcfg, tcfg = _configs("bfloat16")
    params = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0),
                                                    rcfg))
    model = lm_params_from_arrays(tcfg, params, device="cpu")
    np.testing.assert_array_equal(model.meta_tokens.float().numpy(),
                                  params["meta_tokens"].astype(np.float32))
    np.testing.assert_array_equal(model.blocks[1].ssm.A_log.numpy(),
                                  params["blocks"]["ssm"]["A_log"][1])
    no_meta = {k: v for k, v in params.items() if k != "meta_tokens"}
    with pytest.raises(ValueError, match="meta_tokens"):
        lm_params_from_arrays(tcfg, no_meta, device="cpu")
    no_ssm = dict(params, blocks={k: v for k, v in params["blocks"].items()
                                  if k != "ssm"})
    with pytest.raises(ValueError, match="ssm"):
        lm_params_from_arrays(tcfg, no_ssm, device="cpu")
    wrong = dict(params, meta_tokens=params["meta_tokens"][:3])
    with pytest.raises(ValueError, match="meta_tokens"):
        lm_params_from_arrays(tcfg, wrong, device="cpu")
