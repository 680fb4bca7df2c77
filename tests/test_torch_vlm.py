"""The vlm family (internvl2-76b) against the reference: the vision
embeddings' overlay in the forward, prefill and decode, ``batch_at``'s
modality stub and ``Engine.generate`` passing the stub through (training:
``tests/test_torch_modal_train.py``).

The vlm model is the dense family whose first ``vision_tokens`` token
embeddings the prompt's ``vision_embeds`` replace. Weights come from the
reference's ``init_params`` (norms perturbed), carried into the port with
``repro_torch.carry.lm_params_from_arrays``; tokens and vision embeddings
are numpy from a seed. In float32 the logits agree within 1e-4 absolute
(``F32_TOL``) with identical greedy tokens; in bfloat16 within 0.1, the
dense family's bound (``tests/test_torch_lm.py``; measured 0.055).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import lm_params_from_arrays  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCH = "internvl2-76b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.1


def _pair(dtype="float32"):
    """(ref cfg, ref params, port cfg, port model) on the same weights,
    the norms perturbed."""
    rcfg, tcfg = (dataclasses.replace(get(ARCH, reduced=True), dtype=dtype)
                  for get in (ref_get_config, get_config))
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(0), rcfg))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    params = jax.tree_util.tree_map_with_path(perturb, params)
    return (rcfg, jax.tree.map(jnp.asarray, params), tcfg,
            lm_params_from_arrays(tcfg, params, device="cpu"))


def _batch(cfg, b, s, seed=1):
    """numpy {"tokens" [b, s], "vision_embeds" [b, vision_tokens, d]}."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "vision_embeds": rng.standard_normal(
                (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)}


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def f32():
    return _pair()


@pytest.mark.parametrize("stub", [True, False])
def test_forward_matches_reference(f32, stub):
    """With the vision embeddings overlaid, and without (the plain dense
    forward)."""
    rcfg, rparams, tcfg, model = f32
    batch = _batch(rcfg, 2, 37)
    if not stub:
        del batch["vision_embeds"]
    want = np.asarray(R.forward(rparams, _ref(batch), rcfg))
    got = T.forward(model, _port(batch), tcfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_the_overlay_replaces_the_first_vision_tokens_embeddings(f32):
    """Changing the vision embeddings changes the logits at every position
    (each attends to the first ``vision_tokens``); changing the tokens
    under them changes nothing."""
    _, _, tcfg, model = f32
    vt = tcfg.vision_tokens
    batch = _port(_batch(tcfg, 2, 20))
    base = T.forward(model, batch, tcfg)
    under = dict(batch, tokens=batch["tokens"].clone())
    under["tokens"][:, :vt] = (under["tokens"][:, :vt] + 1) % tcfg.vocab_size
    assert torch.equal(T.forward(model, under, tcfg), base)
    moved = dict(batch, vision_embeds=batch["vision_embeds"] + 0.5)
    diff = (T.forward(model, moved, tcfg) - base).abs().amax(-1)
    assert (diff > 1e-3).all()


def test_bf16_forward_within_bf16_tolerance():
    rcfg, rparams, tcfg, model = _pair("bfloat16")
    batch = _batch(rcfg, 2, 24, seed=6)
    want = np.asarray(R.forward(rparams, _ref(batch), rcfg))
    got = T.forward(model, _port(batch), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_prefill_and_decode_match_reference(f32):
    """The prefill with the overlay, then three decode steps (no overlay
    at decode), each against the reference's and against the
    teacher-forced forward."""
    rcfg, rparams, tcfg, model = f32
    b, s, extra = 2, 16, 3
    batch = _batch(rcfg, b, s + extra, seed=2)
    prompt = dict(batch, tokens=batch["tokens"][:, :s])
    rlog, rcache = R.prefill(rparams, _ref(prompt), rcfg, max_len=s + extra)
    tlog, tcache = T.prefill(model, _port(prompt), tcfg, max_len=s + extra)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)
    full = T.forward(model, _port(batch), tcfg)
    for t in range(extra):
        step = batch["tokens"][:, s + t: s + t + 1]
        rlog, rcache = R.decode_step(rparams, jnp.asarray(step), rcache,
                                     s + t, rcfg)
        tlog, tcache = T.decode_step(model, torch.from_numpy(step), tcache,
                                     s + t, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)
        np.testing.assert_allclose(tlog[:, 0], full[:, s + t], **F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(rcache[key]), **F32_TOL)


def test_engine_generate_passes_the_stub_and_matches_reference(f32):
    rcfg, rparams, tcfg, model = f32
    prompt = _batch(rcfg, 3, 21, seed=4)
    engine = Engine(tcfg, model, ServeConfig(max_new_tokens=8))
    want = RefEngine(rcfg, rparams, RefServeConfig(max_new_tokens=8)) \
        .generate(_ref(prompt))
    got = engine.generate(prompt)
    np.testing.assert_array_equal(got, want)
    other = dict(prompt, vision_embeds=prompt["vision_embeds"] * -1)
    want_other = RefEngine(rcfg, rparams,
                           RefServeConfig(max_new_tokens=8)) \
        .generate(_ref(other))
    got_other = engine.generate(_port(other))
    np.testing.assert_array_equal(got_other, want_other)
    assert not np.array_equal(got_other, got)


def test_batch_at_draws_vision_embeds_and_masks_their_labels():
    cfg = get_config(ARCH, reduced=True)
    dcfg = DataConfig(seed=2, batch_size=3, seq_len=30)
    a = batch_at(dcfg, cfg, 4, device="cpu")
    vt = cfg.vision_tokens
    assert set(a) == {"tokens", "labels", "vision_embeds"}
    assert a["vision_embeds"].shape == (3, vt, cfg.d_model)
    assert a["vision_embeds"].dtype == torch.float32
    assert (a["labels"][:, :vt] == -1).all()
    assert torch.equal(a["labels"][:, vt:-1], a["tokens"][:, vt + 1:])
    assert (a["labels"][:, -1] == -1).all()
    dense = batch_at(dcfg, get_config("tinyllama-1.1b", reduced=True), 4,
                     device="cpu")   # the same vocabulary and stream
    assert torch.equal(a["tokens"], dense["tokens"])
    assert torch.equal(a["vision_embeds"],
                       batch_at(dcfg, cfg, 4, device="cpu")["vision_embeds"])
