"""The port's moe family against the reference on the same weights and
tokens: routing (ties included), the sort-based dispatch with capacity
drops, shared experts, the aux loss, the models of DBRX-132B and Kimi-K2
(REDUCED; Kimi-K2's dense prefix layer and shared expert) through
forward, prefill, decode and ``Engine.generate``, the train step with its
AdamW state, and carrying weights and optimizer state with the dense
prefix.

Weights are the reference's ``init_params`` / ``init_moe`` (norms
perturbed so that ``1 + scale`` matters), carried across as numpy;
inputs are numpy from a seed. Float32 runs hold the layer's output and
the logits to rtol=atol=1e-5 and 1e-4 (f32 sums in another order), route
ids exactly, gate weights to 1e-6, the aux loss to 1e-5. Bfloat16 runs
hold a layer's output to 2^-6 of its largest magnitude (products rounded
to bf16 at other places in XLA and PyTorch, a few bf16 steps), the
logits to 0.1 as ``tests/test_torch_lm.py`` does, the model's aux loss
to 1e-2 (``BF16_AUX_RTOL``), and routes exactly (the router logits of
the same bf16 input round alike); the bf16 model's routes, whose
hidden states differ by those steps, to a rule for near-ties
(``ROUTE_TIE_RTOL``). The train steps use ``tests/test_torch_train.py``'s
tolerances, for the reasons its docstring gives.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import models as R  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_step as ref_ts  # noqa: E402
from repro_torch import models as T  # noqa: E402
from repro_torch.carry import (  # noqa: E402
    lm_params_from_arrays,
    opt_state_from_arrays,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm import DataConfig, batch_at  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 2 ** -6
BF16_LOGITS_ATOL = 0.1
# the bf16 model's aux loss: its router probabilities move with hidden
# states a few bf16 steps apart (~2^-8 relative), and a top-1 choice that
# flips between two near-equal experts moves it by E/T times their
# probability gap (~0.3% at T = 58)
BF16_AUX_RTOL = 1e-2
# the route rule (bf16 only; float32 routes are identical): at least 95%
# of (token, layer) routes identical, and a token's first differing route
# a near-tie, the experts swapped within 2^-4 of each other in reference
# probability (a router-logit gap of 0.06, a few bf16 steps of a logit)
ROUTE_AGREEMENT = 0.95
ROUTE_TIE_RTOL = 2 ** -4
# tests/test_torch_train.py's step tolerances
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-2
MOMENT_OUTLIERS = dict(outlier_atol=1e-6, outlier_rtol=2 ** -7)


def _configs(arch, dtype="float32", **changes):
    """(reference cfg, port cfg) of ``arch`` REDUCED with ``changes``."""
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype=dtype,
                                     **changes)
                 for get in (ref_get_config, get_config))


def _weights(cfg, seed=0):
    """The reference's params as numpy, norms perturbed."""
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if "norm" in jax.tree_util.keystr(path):
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


def _layer(arch, dtype, seed=0, **changes):
    """(ref cfg, port cfg, the reference's ``init_moe`` params as numpy)."""
    rcfg, tcfg = _configs(arch, dtype, **changes)
    params = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg,
                              jnp.dtype(dtype))
    return rcfg, tcfg, jax.tree.map(np.asarray, params)


def _t(a):
    """numpy (bf16 included) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().float().numpy()


def _x(shape, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.dtype(dtype)))


def _close(got, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, err_msg=what, **F32_TOL)
    else:
        bound = BF16_REL * float(np.abs(want).max())
        assert float(np.abs(_np(got) - want).max()) <= bound, what


def _gshard_keep(gate_e, n_experts, cap):
    """Independent oracle of GShard capacity: each expert keeps the first
    ``cap`` of its assignments in token order."""
    seen = np.zeros(n_experts, int)
    keep = np.zeros(gate_e.shape, bool)
    for t, row in enumerate(gate_e):
        for j, e in enumerate(row):
            keep[t, j] = seen[e] < cap
            seen[e] += 1
    return keep


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, dtype):
    rcfg, _, params = _layer(arch, dtype)
    xf = _x((37, rcfg.d_model), dtype)
    w, e = moe.route(_t(xf), _t(params["router"]), rcfg.moe_top_k)
    rw, re = ref_moe._route(jnp.asarray(xf), jnp.asarray(params["router"]),
                            rcfg.moe_top_k)
    assert w.dtype == torch.float32 and tuple(e.shape) == re.shape
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6,
                               atol=1e-6)


def test_route_ties_go_to_the_lower_expert_ids():
    """A zero router makes every probability equal: the k lowest ids win,
    as ``jax.lax.top_k`` picks them. Columns equal in pairs tie within
    each pair: the lower id of a pair comes first."""
    rcfg, _, params = _layer("kimi-k2-1t-a32b", "float32")
    k, n_e = rcfg.moe_top_k, rcfg.n_experts
    xf = _x((9, rcfg.d_model), "float32")
    zero = np.zeros_like(params["router"])
    w, e = moe.route(_t(xf), _t(zero), k)
    _, re = ref_moe._route(jnp.asarray(xf), jnp.asarray(zero), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_array_equal(e.numpy(), np.tile(np.arange(k), (9, 1)))
    np.testing.assert_allclose(w.numpy(), 1 / k)
    paired = np.repeat(params["router"][:, ::2], 2, axis=1)[:, :n_e]
    _, e = moe.route(_t(xf), _t(paired), 2 * (k // 2) + 1)
    _, re = ref_moe._route(jnp.asarray(xf), jnp.asarray(paired),
                           2 * (k // 2) + 1)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    assert (e[:, 0] % 2 == 0).all() and (e[:, 1] == e[:, 0] + 1).all()


# ----------------------------------------------------------------- dispatch

def _dispatch_both(rcfg, params, xf, gate_w, gate_e, cap):
    kw = dict(n_experts=rcfg.n_experts, top_k=rcfg.moe_top_k, cap=cap)
    got = moe.dispatch_compute(_t(xf), _t(gate_w), _t(gate_e).long(),
                               _t(params["w_gate"]), _t(params["w_up"]),
                               _t(params["w_down"]), **kw)
    want = ref_moe._dispatch_compute(
        jnp.asarray(xf), jnp.asarray(gate_w), jnp.asarray(gate_e),
        jnp.asarray(params["w_gate"]), jnp.asarray(params["w_up"]),
        jnp.asarray(params["w_down"]), **kw)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.5])
def test_dispatch_compute_matches_reference(capacity_factor, dtype):
    """The expert outputs combined over routed tokens, at a capacity with
    no drops (8), the published 1.25 and a dropping 0.5."""
    rcfg, tcfg, params = _layer("dbrx-132b", dtype,
                                capacity_factor=capacity_factor)
    xf = _x((40, rcfg.d_model), dtype)
    rw, re = ref_moe._route(jnp.asarray(xf), jnp.asarray(params["router"]),
                            rcfg.moe_top_k)
    cap = moe.capacity(tcfg, 40)
    assert cap == max(int(capacity_factor * 40 * rcfg.moe_top_k
                          / rcfg.n_experts), 1)
    got, want = _dispatch_both(rcfg, params, xf, np.asarray(rw),
                               np.asarray(re), cap)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_capacity_drops_the_reference_drops():
    """capacity_factor 0.5: each expert takes 5 of its assignments from 40
    tokens x top-2 over 4 experts. The port's kept set is GShard's (an
    oracle in numpy) and the reference's (probed one rank at a time: with
    a gate weight of 1 on rank j only, a token's output is nonzero iff its
    j-th assignment was kept); tokens dropped by every expert get zero."""
    rcfg, tcfg, params = _layer("dbrx-132b", "float32", capacity_factor=0.5)
    t, k = 40, rcfg.moe_top_k
    xf = _x((t, rcfg.d_model), "float32")
    _, re = ref_moe._route(jnp.asarray(xf), jnp.asarray(params["router"]), k)
    gate_e = np.asarray(re)
    cap = moe.capacity(tcfg, t)
    keep = moe.capacity_keep(_t(gate_e).long(), rcfg.n_experts, cap).numpy()
    np.testing.assert_array_equal(keep, _gshard_keep(gate_e, rcfg.n_experts,
                                                     cap))
    assert 0 < keep.sum() < keep.size
    ref_keep = np.zeros_like(keep)
    for j in range(k):
        one = np.zeros((t, k), np.float32)
        one[:, j] = 1.0
        got, want = _dispatch_both(rcfg, params, xf, one, gate_e, cap)
        ref_keep[:, j] = np.abs(want).max(1) > 0
        _close(got, want, "float32", f"rank {j}")
    np.testing.assert_array_equal(keep, ref_keep)
    rw, _ = ref_moe._route(jnp.asarray(xf), jnp.asarray(params["router"]), k)
    got, want = _dispatch_both(rcfg, params, xf, np.asarray(rw), gate_e, cap)
    _close(got, want, "float32")
    assert (_np(got)[~keep.any(1)] == 0).all()


def test_dispatch_is_bit_identical_across_calls():
    rcfg, tcfg, params = _layer("kimi-k2-1t-a32b", "bfloat16",
                                capacity_factor=1.25)
    p = {n: _t(a) for n, a in params.items()}
    x = _t(_x((3, 11, rcfg.d_model), "bfloat16"))
    a = moe.moe_forward(p, x, tcfg)
    b = moe.moe_forward(p, x, tcfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# -------------------------------------------------------- layer and aux loss

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, capacity_factor, dtype):
    """The whole layer (Kimi-K2's adds its shared expert) over [B, S, d]."""
    rcfg, tcfg, params = _layer(arch, dtype, capacity_factor=capacity_factor)
    x = _x((3, 13, rcfg.d_model), dtype)
    got = moe.moe_forward({n: _t(a) for n, a in params.items()}, _t(x), tcfg)
    want = ref_moe.moe_forward(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x), rcfg)
    assert tuple(got.shape) == want.shape
    _close(got, want, dtype)
    want_local = ref_moe._moe_local(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), rcfg)
    _close(got, want_local, dtype)
    if rcfg.n_shared_experts:
        xf = x.reshape(-1, rcfg.d_model)
        _close(moe.shared_experts({n: _t(a) for n, a in params.items()},
                                  _t(xf)),
               ref_moe._shared_experts(jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(xf)), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_and_its_router_gradient_match_reference(arch):
    rcfg, tcfg, params = _layer(arch, "float32")
    x = _x((2, 17, rcfg.d_model), "float32")
    router = _t(params["router"]).requires_grad_()
    got = moe.moe_aux_loss({"router": router}, _t(x), tcfg)
    (grad,) = torch.autograd.grad(got, router)
    want, rgrad = jax.value_and_grad(
        lambda r: ref_moe.moe_aux_loss({"router": r}, jnp.asarray(x), rcfg))(
        jnp.asarray(params["router"]))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=1e-4,
                               atol=1e-7)


# -------------------------------------------------------------------- model

def _record_routes(monkeypatch, rcfg):
    """Record every routing call of both packages, layer by layer: (expert
    ids [T, k], router probabilities [T, E]) as numpy. The reference runs
    its layers in a Python loop (``scan_layers=False``, no remat: the same
    function, its routes concrete arrays). Returns (reference cfg, its
    calls, the port's calls)."""
    ref_calls, port_calls = [], []
    ref_route, port_route = ref_moe._route, moe.route

    def ref_wrapped(xf, router, k):
        w, e = ref_route(xf, router, k)
        probs = ref_moe.softmax_fp32((xf @ router).astype(jnp.float32))
        ref_calls.append((np.asarray(e), np.asarray(probs)))
        return w, e

    def port_wrapped(xf, router, k):
        w, e = port_route(xf, router, k)
        probs = moe.softmax_fp32((xf @ router).float())
        port_calls.append((e.numpy(), probs.numpy()))
        return w, e

    monkeypatch.setattr(ref_moe, "_route", ref_wrapped)
    monkeypatch.setattr(moe, "route", port_wrapped)
    return (dataclasses.replace(rcfg, scan_layers=False, remat=False),
            ref_calls, port_calls)


def _routes_agree(ref_calls, port_calls):
    """The route rule: at least ROUTE_AGREEMENT of the (token, layer)
    expert sets are identical, and each token whose set differs differs
    first at a near-tie: every expert that one package took and the other
    did not has a reference probability within ROUTE_TIE_RTOL of the
    expert it displaced. Returns the tokens whose routes agree at every
    layer."""
    same = np.stack([(np.sort(a, 1) == np.sort(b, 1)).all(1)
                     for (a, _), (b, _) in zip(ref_calls, port_calls)])
    assert same.mean() >= ROUTE_AGREEMENT, same.mean()
    for t in np.nonzero(~same.all(0))[0]:
        layer = int(np.argmin(same[:, t]))
        (ref_e, probs), (port_e, _) = ref_calls[layer], port_calls[layer]
        p = probs[t]
        ref_only = p[np.setdiff1d(ref_e[t], port_e[t])]
        port_only = p[np.setdiff1d(port_e[t], ref_e[t])]
        gap = (ref_only.max() - port_only.min()) / ref_only.max()
        assert gap <= ROUTE_TIE_RTOL, (t, layer, ref_e[t], port_e[t], gap)
    return same.all(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_aux_matches_reference(arch, monkeypatch):
    """Float32: the summed aux loss, the logits and every layer's routes
    (ids exactly)."""
    rcfg, rparams, tcfg, model = _pair(arch)
    rcfg, ref_calls, port_calls = _record_routes(monkeypatch, rcfg)
    tok = _tokens(rcfg, 2, 29)
    want, r_aux = R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg,
                            return_aux=True)
    got, aux = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg,
                         return_aux=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **LOGITS_F32_TOL)
    assert len(port_calls) == len(ref_calls) == \
        rcfg.n_layers - rcfg.n_dense_layers
    for (ref_e, _), (port_e, _) in zip(ref_calls, port_calls):
        np.testing.assert_array_equal(port_e, ref_e)
    assert torch.equal(got, T.forward(model, {"tokens": torch.from_numpy(
        tok)}, tcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_tolerance_under_the_route_rule(arch,
                                                            monkeypatch):
    """Bfloat16: hidden states a few bf16 steps apart can flip a near-tied
    routing choice, which changes that token's layer output by a whole
    expert's. So the routes are held to the route rule, the logits to
    BF16_LOGITS_ATOL on the tokens whose routes agree at every layer
    (measured: Kimi-K2 flips one of 116, at a reference probability gap
    of 0.8%), and the aux loss to BF16_AUX_RTOL."""
    rcfg, rparams, tcfg, model = _pair(arch, "bfloat16")
    rcfg, ref_calls, port_calls = _record_routes(monkeypatch, rcfg)
    tok = _tokens(rcfg, 2, 29)
    want, r_aux = R.forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg,
                            return_aux=True)
    got, aux = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg,
                         return_aux=True)
    agree = _routes_agree(ref_calls, port_calls).reshape(tok.shape)
    np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree],
                               rtol=0, atol=BF16_LOGITS_ATOL)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=BF16_AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """REDUCED's capacity_factor 8 drops nothing, so every decode step
    also equals the teacher-forced forward at its position."""
    rcfg, rparams, tcfg, model = _pair(arch)
    b, s, extra = 2, 16, 4
    tok = _tokens(rcfg, b, s + extra, seed=2)
    rlog, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok[:, :s])},
                             rcfg, max_len=s + extra)
    tlog, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok[:, :s])},
                             tcfg, max_len=s + extra)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog),
                               **LOGITS_F32_TOL)
    assert tcache["k"].shape == rcache["k"].shape
    assert tcache["k"].shape[0] == rcfg.n_layers
    full = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    for t in range(extra):
        step = tok[:, s + t: s + t + 1]
        rlog, rcache = R.decode_step(rparams, jnp.asarray(step), rcache,
                                     s + t, rcfg)
        tlog, tcache = T.decode_step(model, torch.from_numpy(step), tcache,
                                     s + t, tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog),
                                   **LOGITS_F32_TOL)
        np.testing.assert_allclose(tlog[:, 0], full[:, s + t],
                                   **LOGITS_F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(rcache[key]), **LOGITS_F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_capacity_follows_the_step_tokens(arch):
    """At the published capacity_factor 1.25 a decode step's capacity comes
    from its B tokens (here 1 per expert), as in the reference, so tokens
    drop at decode that a prefill keeps: the step still matches the
    reference's, not the teacher-forced forward."""
    rcfg, rparams, tcfg, model = _pair(arch, capacity_factor=1.25)
    b, s = 3, 12
    assert moe.capacity(tcfg, b) == 1
    tok = _tokens(rcfg, b, s + 1, seed=3)
    _, rcache = R.prefill(rparams, {"tokens": jnp.asarray(tok[:, :s])}, rcfg,
                          max_len=s + 1)
    _, tcache = T.prefill(model, {"tokens": torch.from_numpy(tok[:, :s])},
                          tcfg, max_len=s + 1)
    rlog, _ = R.decode_step(rparams, jnp.asarray(tok[:, s:]), rcache, s, rcfg)
    tlog, _ = T.decode_step(model, torch.from_numpy(tok[:, s:]), tcache, s,
                            tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog),
                               **LOGITS_F32_TOL)
    full = T.forward(model, {"tokens": torch.from_numpy(tok)}, tcfg)
    assert float((tlog[:, 0] - full[:, s]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_reference(arch):
    rcfg, rparams, tcfg, model = _pair(arch)
    prompt = _tokens(rcfg, 3, 21, seed=4)
    want = RefEngine(rcfg, rparams, RefServeConfig(max_new_tokens=8)) \
        .generate({"tokens": jnp.asarray(prompt)})
    got = Engine(tcfg, model, ServeConfig(max_new_tokens=8)) \
        .generate({"tokens": torch.from_numpy(prompt)})
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- weights and carry

def _reference_layout(rcfg):
    """The reference's parameter shapes by the port's names (stacked
    leaves split into layers), from ``jax.eval_shape`` (nothing drawn)."""
    shapes = jax.eval_shape(lambda: R.init_params(jax.random.PRNGKey(0),
                                                  rcfg))
    stacks = {"blocks": rcfg.n_layers - rcfg.n_dense_layers,
              "dense_blocks": rcfg.n_dense_layers}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        parts = [p.strip("[]'") for p in
                 jax.tree_util.keystr(path).split("][")]
        if parts[0] in stacks:
            for i in range(stacks[parts[0]]):
                want[".".join([parts[0], str(i)] + parts[1:])] = \
                    leaf.shape[1:]
        else:
            want[".".join(parts)] = leaf.shape
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_published_configs_build_the_reference_layout(arch):
    """At the published widths and depths (on the meta device: nothing
    allocated), every parameter of the port's model has its reference
    leaf's shape, so the reference's pytree carries across."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    got = dict(LM(cfg, "meta").named_parameters())
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        _reference_layout(rcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    rcfg, tcfg = _configs(arch, dtype="bfloat16")
    model = T.init_params(tcfg, seed=0, device="cpu")
    got = dict(model.named_parameters())
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        _reference_layout(rcfg)
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad
               for t in got.values())
    assert len(model.dense_blocks) == rcfg.n_dense_layers
    # fan-in normal, expert by expert: w_gate's along d, w_down's along f
    m = model.blocks[-1].moe
    for w, fan_in in ((m.w_gate, rcfg.d_model), (m.w_down, rcfg.d_ff)):
        assert abs(float(w.float().std()) * fan_in ** 0.5 - 1) < 0.05
    assert not torch.equal(m.w_gate[0], m.w_gate[1])
    again = T.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(m.w_up, again.blocks[-1].moe.w_up)


def test_carry_splits_dense_blocks_and_refuses_a_missing_leaf():
    rcfg, tcfg = _configs("kimi-k2-1t-a32b", dtype="bfloat16")
    params = jax.tree.map(np.asarray,
                          R.init_params(jax.random.PRNGKey(0), rcfg))
    model = lm_params_from_arrays(tcfg, params, device="cpu")
    np.testing.assert_array_equal(
        model.dense_blocks[0].mlp.w_up.float().numpy(),
        params["dense_blocks"]["mlp"]["w_up"][0].astype(np.float32))
    np.testing.assert_array_equal(
        model.blocks[1].moe.w_down.float().numpy(),
        params["blocks"]["moe"]["w_down"][1].astype(np.float32))
    for drop in (("dense_blocks", "attn_norm"), ("blocks", "moe")):
        missing = {k: dict(v) if isinstance(v, dict) else v
                   for k, v in params.items()}
        del missing[drop[0]][drop[1]]
        with pytest.raises(ValueError, match=drop[1]):
            lm_params_from_arrays(tcfg, missing, device="cpu")
    state = jax.tree.map(np.asarray, ref_opt.init_state(
        jax.tree.map(jnp.asarray, params), ref_opt.OptimizerConfig()))
    t_state = opt_state_from_arrays(tcfg, state, device="cpu")
    assert set(t_state["m"]) == set(dict(model.named_parameters()))
    del state["m"]["dense_blocks"]
    with pytest.raises(ValueError, match="dense_blocks"):
        opt_state_from_arrays(tcfg, state, device="cpu")


def test_weight_decay_sees_the_dense_prefix_stack():
    """dense_blocks.0.attn_norm is the reference's [L_dense, d] leaf: it
    decays as blocks.<i>.attn_norm does."""
    w = torch.zeros(4)
    assert opt.reference_ndim("dense_blocks.0.attn_norm", w) == 2
    assert opt.reference_ndim("blocks.1.moe.router", torch.zeros(4, 2)) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_at_serves_the_moe_family(arch):
    cfg = get_config(arch, reduced=True)
    b = batch_at(DataConfig(batch_size=2, seq_len=9), cfg, 0, device="cpu")
    assert b["tokens"].shape == (2, 9)
    assert ((b["tokens"] >= 0) & (b["tokens"] < cfg.vocab_size)).all()


# ------------------------------------------------------------------- train

def _batch(cfg, b=4, s=24, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1))
    labels = tokens[:, 1:].copy()
    labels[rng.random((b, s)) < 0.1] = -1
    labels[:, -1] = -1
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}


def _by_port_name(tree):
    """A reference tree of numpy arrays by the port's names: stacked
    leaves split into layers, factored leaves as ``<name>.row``."""
    out = {}

    def walk(t, prefix):
        for key, val in t.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
                continue
            stack, _, rest = prefix.partition(".")
            if stack in ("blocks", "dense_blocks"):
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
                out[f"{name}.{key}"] = _np(t)
        else:
            out[name] = _np(val)
    return out


def _assert_trees(got, want, tol, what, outlier_atol, outlier_rtol=0.0):
    """tests/test_torch_train.py's rule: every array within ``tol``, but
    for up to one element in a thousand (at least one: the near-eps
    element it allows for strikes one element whatever the array's size)
    within ``outlier_atol + outlier_rtol |want|``."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for name in sorted(want):
        g, w = got[name], want[name]
        err = np.abs(g - w)
        out = err > tol["atol"] + tol["rtol"] * np.abs(w)
        assert out.sum() <= max(1, w.size // 1000), \
            (what, name, int(out.sum()))
        assert (err <= outlier_atol + outlier_rtol * np.abs(w)).all(), \
            (what, name, float(err.max()))


def _run_steps(arch, n_steps, **okw):
    """The reference's train step ``n_steps`` times from the reference's
    weights; its params and AdamW state before the last step carried into
    the port (``lm_params_from_arrays``, ``opt_state_from_arrays``), and
    the port's step taken on the last batch. Consecutive steps of the two
    packages drift apart by more than the step tolerances, as each step's
    near-eps elements (the module docstring of
    ``tests/test_torch_train.py``) move the next step's forward (measured
    on Kimi-K2 REDUCED after three: 0.5% of the expert elements up to
    3.4e-4 apart, the aux loss 1.2e-5 relative), so the step is held from
    the reference's own state. Default TrainConfig (aux_loss_weight
    0.01)."""
    rcfg, tcfg = _configs(arch)
    ocfg = dict(lr=LR, warmup_steps=2, total_steps=10, **okw)
    r_step = jax.jit(ref_ts.make_train_step(
        rcfg, ref_opt.OptimizerConfig(**ocfg), ref_ts.TrainConfig()))
    t_step = ts.make_train_step(tcfg, opt.OptimizerConfig(**ocfg),
                                ts.TrainConfig())
    params = jax.tree.map(jnp.asarray, _weights(rcfg))
    state = ref_opt.init_state(params, ref_opt.OptimizerConfig(**ocfg))
    batches = [_batch(rcfg, seed=s) for s in range(n_steps)]
    for batch in batches[:-1]:
        params, state, _ = r_step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu").requires_grad_()
    t_state = opt_state_from_arrays(tcfg, jax.tree.map(np.asarray, state),
                                    device="cpu")
    fresh = opt.init_state(dict(model.named_parameters()),
                           opt.OptimizerConfig(**ocfg))
    assert _port_flat(fresh["v"]).keys() == _port_flat(t_state["v"]).keys()
    params, state, r_metrics = r_step(
        params, state, {k: jnp.asarray(v) for k, v in batches[-1].items()})
    model, t_state, t_metrics = t_step(
        model, t_state, {k: torch.from_numpy(v.astype(np.int64))
                         for k, v in batches[-1].items()})
    return (dict(model.named_parameters()), t_state, t_metrics,
            jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), r_metrics)


def _assert_step(n_steps, p, st, m, rp, rst, rm):
    assert int(st["step"]) == int(rst["step"]) == n_steps
    _assert_trees(_port_flat(p), _by_port_name(rp), PARAM_TOL, "param",
                  outlier_atol=3 * LR)
    _assert_trees(_port_flat(st["m"]), _by_port_name(rst["m"]), STEP_TOL, "m",
                  **MOMENT_OUTLIERS)
    _assert_trees(_port_flat(st["v"]), _by_port_name(rst["v"]), STEP_TOL, "v",
                  **MOMENT_OUTLIERS)
    for key in ("loss", "aux_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert float(m["aux_loss"]) > 0


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, n_steps):
    """Params and AdamW moments after step 1 (from the weights) and step 3
    (from the reference's state after two); the loss, the summed aux loss,
    the total (loss + 0.01 aux), the gradient norm and lr."""
    _assert_step(n_steps, *_run_steps(arch, n_steps))


def test_factored_train_step_over_expert_leaves_matches_reference():
    """min_dim_size_to_factor 32 factors the [E, d, f] expert leaves (row
    [E, d], col [E, f]) and Kimi-K2's dense prefix MLP, bf16 state; step
    2, from the reference's factored state after one."""
    out = _run_steps("kimi-k2-1t-a32b", 2, factored=True,
                     min_dim_size_to_factor=32, state_dtype="bfloat16")
    st = out[1]
    assert set(st["v"]["blocks.0.moe.w_gate"]) == {"row", "col"}
    assert tuple(st["v"]["blocks.0.moe.w_down"]["row"].shape) == (8, 32)
    assert set(st["v"]["dense_blocks.0.mlp.w_up"]) == {"row", "col"}
    assert not isinstance(st["v"]["blocks.0.moe.router"], dict)
    _assert_step(2, *out)
