"""The port's LM serving path against the reference on the same weights
and tokens: configs, layers, attention, the dense model's forward,
prefill and decode, and ``Engine.generate``.

Weights are made by the reference's ``init_params`` (with norms and
biases perturbed so that ``1 + scale`` and the biases matter), turned
into numpy and carried into the port with
``repro_torch.carry.lm_params_from_arrays``; tokens are numpy from a
seed. The REDUCED configs run in float32, where the two packages differ
only in the order of float32 sums (and the reference's chunked online
softmax against one softmax): logits to rtol=atol=1e-4 and identical
greedy tokens. The bfloat16 run holds logits to 0.1 absolute, about six
bfloat16 steps at their size: XLA and PyTorch round bfloat16 products
at different places, and the differences add up over the layers.
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
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

DENSE = ("tinyllama-1.1b", "stablelm-1.6b", "command-r-plus-104b",
         "qwen1.5-4b")
MOE = ("dbrx-132b", "kimi-k2-1t-a32b")   # tests/test_torch_moe.py
# whisper-small (audio) and internvl2-76b (vlm): tests/test_torch_audio.py
# and tests/test_torch_vlm.py
AUDIO_VLM = ("whisper-small", "internvl2-76b")
# mamba2-370m (ssm) and hymba-1.5b (hybrid): tests/test_torch_ssm.py and
# tests/test_torch_hybrid.py
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.1


def _configs(arch, dtype="float32", **changes):
    """(reference cfg, port cfg) of ``arch`` REDUCED with ``changes``."""
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype=dtype,
                                     **changes)
                 for get in (ref_get_config, get_config))


def _weights(cfg, seed=0):
    """The reference's params as numpy, norms and biases perturbed."""
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or name.endswith(("['bq']", "['bk']", "['bv']")):
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, params)


def _pair(arch, dtype="float32", **changes):
    """(ref cfg, ref params, port cfg, port model) on the same weights."""
    rcfg, tcfg = _configs(arch, dtype, **changes)
    np_params = _weights(rcfg)
    return (rcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            lm_params_from_arrays(tcfg, np_params, device="cpu"))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.fixture(scope="module")
def tiny_f32():
    return _pair("tinyllama-1.1b")


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", DENSE + MOE + AUDIO_VLM)
@pytest.mark.parametrize("reduced", [False, True])
def test_dense_configs_copy_the_reference(arch, reduced):
    """The dense, moe, audio and vlm families' configs, and their analytic
    counts (the audio family's with its encoder and cross-attention)."""
    ref = ref_get_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.vocab_padded == ref.vocab_padded
    assert got.resolved_head_dim == ref.resolved_head_dim
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()


def test_a_family_the_port_does_not_know_raises_naming_it():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", reduced=True),
                              family="diffusion")
    for call in (lambda: T.init_params(cfg, device="cpu"),
                 lambda: T.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: batch_at(DataConfig(), cfg, 0, device="cpu")):
        with pytest.raises(NotImplementedError, match="'diffusion'"):
            call()


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("gpt-5")


# ------------------------------------------------------------------- layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    scale = (rng.standard_normal(16) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
        ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(530, 539)
    cos, sin = tlayers.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    rcos, rsin = ref_layers.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    # cos/sin of angles up to ~540 rad: float32 argument reduction
    np.testing.assert_allclose(cos, rcos, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sin, rsin, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(
            np.array(rcos)), torch.from_numpy(np.array(rsin))),
        ref_layers.apply_rope(jnp.asarray(x), rcos, rsin),
        rtol=1e-6, atol=1e-6)


def test_init_helpers_draw_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, (256, 4, 32), (0, 1), torch.float32)
    assert abs(float(w.std()) - 1 / 32) < 0.002
    e = tlayers.embed_init(torch.Generator().manual_seed(0), (512, 64))
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 0.002
    again = tlayers.dense_init(torch.Generator().manual_seed(0),
                               (256, 4, 32), (0, 1), torch.float32)
    assert torch.equal(w, again)


# ---------------------------------------------------------------- attention

def _qkv(b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(sq + sk)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


# the reference's chunk: a ragged last chunk with full attention counts its
# padded keys (next test), so that case takes a chunk that divides Sk
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,chunk", [
    (2, 37, 37, 4, 2, 16, True, 16),     # ragged length, group 2
    (1, 20, 45, 8, 1, 16, True, 16),     # suffix queries, group 8
    (2, 33, 33, 4, 4, 32, False, 11),    # full attention, no grouping
])
def test_attention_matches_reference(b, sq, sk, h, kvh, d, causal, chunk):
    q, k, v = _qkv(b, sq, sk, h, kvh, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        tattn.attention(tq, tk, tv, causal=causal),
        ref_attn.attention(jq, jk, jv, causal=causal, chunk=chunk),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tattn.attention_reference(tq, tk, tv, causal=causal),
        ref_attn.attention_reference(jq, jk, jv, causal=causal),
        rtol=1e-5, atol=1e-5)


def test_reference_chunks_count_padded_keys_in_full_attention():
    """A divergence of the reference (ROADMAP queue 3): its chunked path
    pads K/V to a multiple of ``chunk`` with zeros and only the causal
    mask hides them, so full attention over Sk=33 in chunks of 16 gives
    15 zero keys weight. The port attends to the 33 real keys only, as
    the reference's own oracle does."""
    q, k, v = _qkv(1, 33, 33, 2, 2, 16)
    got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = ref_attn.attention_reference(jq, jk, jv, causal=False)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    chunked = ref_attn.attention(jq, jk, jv, causal=False, chunk=16)
    assert np.abs(got - np.asarray(chunked)).max() > 0.1


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    for cur in (0, 17, 39):
        got = tattn.decode_attention(
            *(torch.from_numpy(a) for a in (q, kc, vc)),
            k_pos=torch.arange(40), cur_pos=cur)
        want = ref_attn.decode_attention(
            *(jnp.asarray(a) for a in (q, kc, vc)), k_pos=jnp.arange(40),
            cur_pos=jnp.int32(cur))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("arch,changes", [
    ("tinyllama-1.1b", {}),
    ("tinyllama-1.1b", {"vocab_size": 500}),    # padded vocab: 500 -> 512
    ("stablelm-1.6b", {}),                      # qkv bias, no grouping
    ("command-r-plus-104b", {}),                # tied embeddings
    ("qwen1.5-4b", {}),                         # qkv bias, head_dim 12
])
def test_forward_matches_reference(arch, changes):
    rcfg, rparams, tcfg, model = _pair(arch, **changes)
    tok = _tokens(rcfg, 2, 37)
    want = np.asarray(R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg))
    got = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    if tcfg.vocab_padded != tcfg.vocab_size:
        assert (got[..., tcfg.vocab_size:] == -1e30).all()


def test_prefill_and_decode_match_reference(tiny_f32):
    rcfg, rparams, tcfg, model = tiny_f32
    b, s, extra = 2, 16, 4
    tok = _tokens(rcfg, b, s + extra, seed=2)
    rlog, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok[:, :s])},
                             rcfg, max_len=s + extra)
    tlog, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok[:, :s])},
                             tcfg, max_len=s + extra)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)
    for key in ("k", "v"):
        assert tcache[key].shape == rcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(rcache[key]), **F32_TOL)
    full = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    for t in range(extra):
        step = tok[:, s + t: s + t + 1]
        rlog, rcache = R.decode_step(rparams, jnp.asarray(step), rcache,
                                     s + t, rcfg)
        tlog, tcache = T.decode_step(model, torch.from_numpy(step), tcache,
                                     s + t, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)
        # teacher-forced forward at the same position
        np.testing.assert_allclose(tlog[:, 0], full[:, s + t], **F32_TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(rcache["k"]),
                               **F32_TOL)


def test_engine_generate_matches_reference(tiny_f32):
    rcfg, rparams, tcfg, model = tiny_f32
    prompt = _tokens(rcfg, 3, 21, seed=4)
    want = RefEngine(rcfg, rparams, RefServeConfig(max_new_tokens=8)) \
        .generate({"tokens": jnp.asarray(prompt)})
    engine = Engine(tcfg, model, ServeConfig(max_new_tokens=8))
    got = engine.generate({"tokens": torch.from_numpy(prompt)})
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(engine.timing) == {"prefill_s", "decode_s"}
    # stop at EOS: row 0's third token; later ids of a stopped row are EOS
    eos = int(want[0, 2])
    scfg = dict(max_new_tokens=8, eos_id=eos)
    want = RefEngine(rcfg, rparams, RefServeConfig(**scfg)) \
        .generate({"tokens": jnp.asarray(prompt)})
    got = Engine(tcfg, model, ServeConfig(**scfg)) \
        .generate({"tokens": torch.from_numpy(prompt)})
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_temperature_sampling_draws_from_the_generator(tiny_f32):
    _, _, tcfg, model = tiny_f32
    prompt = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 9))}
    engine = Engine(tcfg, model, ServeConfig(max_new_tokens=6,
                                             temperature=1.0))
    a = engine.generate(prompt, torch.Generator().manual_seed(5))
    b = engine.generate(prompt, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
    with pytest.raises(ValueError, match="Generator"):
        engine.generate(prompt)


def test_bf16_forward_and_decode_within_bf16_tolerance():
    rcfg, rparams, tcfg, model = _pair("tinyllama-1.1b", dtype="bfloat16")
    assert model.tok_embed.dtype == torch.bfloat16
    b, s = 2, 24
    tok = _tokens(rcfg, b, s + 1, seed=6)
    want = np.asarray(R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg))
    got = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    _, cache = T.prefill(model, {"tokens": torch.from_numpy(tok[:, :s])},
                         tcfg, max_len=s + 1)
    assert cache["k"].dtype == torch.bfloat16
    step, _ = T.decode_step(model, torch.from_numpy(tok[:, s:]), cache, s,
                            tcfg)
    np.testing.assert_allclose(step[:, 0].numpy(), want[:, s], rtol=0,
                               atol=BF16_ATOL)


# ------------------------------------------------------- weights, data, device

def test_init_params_has_the_reference_layout():
    rcfg, tcfg = _configs("qwen1.5-4b", dtype="bfloat16")
    shapes = jax.eval_shape(lambda: R.init_params(jax.random.PRNGKey(0),
                                                  rcfg))
    flat = {jax.tree_util.keystr(p): s.shape for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = T.init_params(tcfg, seed=0, device="cpu")
    got = dict(model.named_parameters())
    assert len(got) == sum(rcfg.n_layers if "'blocks'" in name else 1
                           for name in flat)
    for name, shape in flat.items():
        parts = [p.strip("[]'") for p in name.split("][")]
        if parts[0] == "blocks":
            for i in range(rcfg.n_layers):
                t = got[".".join(["blocks", str(i)] + parts[1:])]
                assert tuple(t.shape) == shape[1:]
        else:
            assert tuple(got[".".join(parts)].shape) == shape
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad
               for t in got.values())
    again = T.init_params(tcfg, seed=0, device="cpu")
    other = T.init_params(tcfg, seed=1, device="cpu")
    assert torch.equal(model.blocks[1].attn.wq, again.blocks[1].attn.wq)
    assert not torch.equal(model.blocks[1].attn.wq, other.blocks[1].attn.wq)
    assert (model.final_norm == 0).all() and (model.blocks[0].attn.bq == 0) \
        .all()


def test_carry_copies_bf16_weights_and_refuses_a_mismatch():
    rcfg, tcfg = _configs("tinyllama-1.1b", dtype="bfloat16")
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(0), rcfg))
    assert params["tok_embed"].dtype.name == "bfloat16"
    model = lm_params_from_arrays(tcfg, params, device="cpu")
    np.testing.assert_array_equal(
        model.blocks[1].mlp.w_down.float().numpy(),
        params["blocks"]["mlp"]["w_down"][1].astype(np.float32))
    missing = dict(params)
    del missing["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_arrays(tcfg, missing, device="cpu")
    wrong = dict(params, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_arrays(tcfg, wrong, device="cpu")


def test_batch_at_is_a_function_of_seed_and_step():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    dcfg = DataConfig(seed=3, batch_size=4, seq_len=50)
    a = batch_at(dcfg, cfg, 7, device="cpu")
    assert a["tokens"].shape == (4, 50) and a["labels"].shape == (4, 50)
    assert ((a["tokens"] >= 0) & (a["tokens"] < cfg.vocab_size)).all()
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    assert torch.equal(a["tokens"], batch_at(dcfg, cfg, 7,
                                             device="cpu")["tokens"])
    assert not torch.equal(a["tokens"], batch_at(dcfg, cfg, 8,
                                                 device="cpu")["tokens"])
    # Zipf marginal: token 0 is the most frequent
    big = batch_at(DataConfig(batch_size=8, seq_len=500), cfg, 0,
                   device="cpu")["tokens"]
    counts = torch.bincount(big.flatten(), minlength=cfg.vocab_size)
    assert int(counts.argmax()) == 0


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b", reduced=True)
    for call in (lambda: T.init_params(cfg),
                 lambda: T.init_cache(cfg, 1, 4),
                 lambda: batch_at(DataConfig(), cfg, 0),
                 lambda: lm_params_from_arrays(cfg, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
