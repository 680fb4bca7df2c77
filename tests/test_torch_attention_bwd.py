"""The attention backward of the port against the reference.

``repro_torch.kernels.flash_attention.FlashAttention`` (the autograd
Function the model's attention runs through when it trains; its plain
versions on the CPU) against ``jax.vjp`` of the reference's
``repro.models.attention.attention`` (whose backward is the jnp
``custom_vjp`` ``bwd``, ``repro/models/attention.py:136``) on the same
numpy q, k, v and dO: causal and full, GQA ratios H/KVH = 1, 2 and 8,
head dims 16, 64 and a width the kernel pads (48), Sq = Sk in {33, 64},
and causal Sq < Sk. Full attention keeps Sk a multiple of the
reference's ``chunk`` (its ragged last chunk attends to zero keys). In
float32 the two agree to 1e-4 relative and 1e-5 absolute (f32 sums in
other orders, one softmax against the chunked online one).

Then the bf16 kernel's own rounding, emulated in plain torch at the
points ``csrc/flash_attention_bwd.cu`` rounds (P and dS to bf16 before
their products, exp2 of a scale * log2(e) product, lse * log2(e) in f32,
outputs rounded once), is held to the f32 plain backward on the same
inputs within ``BWD_BF16_TOL`` of each gradient's largest magnitude: the
bound ``chip_smoke.py`` holds the kernel to on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

F32_TOL = dict(rtol=1e-4, atol=1e-5)
# chip_smoke.FLASH_BWD_BF16_TOL: a gradient within 2^-6 of its largest
# magnitude; the emulated rounding stays near 2^-8 (0.3-0.6%)
BWD_BF16_TOL = 2 ** -6
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _inputs(b, h, kvh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                      (b, sq, h, d))]


def _port_grads(q, k, v, dout, causal):
    """(out, dq, dk, dv) through the autograd Function on the CPU."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(dout))
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _ref_grads(q, k, v, dout, causal, chunk):
    out, vjp = jax.vjp(lambda q_, k_, v_: ref_attn.attention(
        q_, k_, v_, causal=causal, chunk=chunk),
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _chunk(sk, causal):
    """A chunk below Sk, so the reference scans several; for full
    attention one that divides Sk."""
    if causal or sk % 16 == 0:
        return 16
    return next(c for c in (11, 7, 5, 3) if sk % c == 0)


# (B, H, KVH, Sq, Sk, D, causal): GQA ratios 1, 2 and 8, D 16, 64 and 48
# (padded to 64 by the kernel), Sq = Sk in {33, 64}, causal Sq < Sk
BWD_SHAPES = [(2, 4, 4, 33, 33, 16, True), (2, 4, 4, 33, 33, 16, False),
              (1, 4, 2, 64, 64, 64, True), (1, 4, 2, 64, 64, 64, False),
              (1, 8, 1, 33, 33, 48, True), (1, 8, 1, 64, 64, 48, False),
              (2, 16, 2, 33, 33, 16, True), (1, 16, 2, 33, 33, 64, False),
              (1, 8, 1, 40, 70, 64, True), (1, 4, 2, 17, 64, 16, True)]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", BWD_SHAPES)
def test_backward_matches_reference_vjp(b, h, kvh, sq, sk, d, causal):
    q, k, v, dout = _inputs(b, h, kvh, sq, sk, d, seed=sq * d + h)
    got = _port_grads(q, k, v, dout, causal)
    want = _ref_grads(q, k, v, dout, causal, _chunk(sk, causal))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", BWD_SHAPES[::3])
def test_lse_matches_reference_forward_residual(b, h, kvh, sq, sk, d,
                                                causal):
    """The forward's log-sum-exp, f32 [B, H, Sq], against the ``lse``
    residual of the reference's ``fwd`` ([B, KVH, G, Sq])."""
    q, k, v, _ = _inputs(b, h, kvh, sq, sk, d, seed=1)
    _, lse = fa.flash_attention_plain(*(torch.from_numpy(x) for x in
                                        (q, k, v)), causal,
                                      return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _, want = ref_attn._flash_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.zeros(()), causal, 0, 0,
        _chunk(sk, causal))
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(b, h, sq), **F32_TOL)


# ----------------------------------------------- the bf16 kernel's rounding


def _grouped(x, kvh):
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _ungrouped(x):
    b, kvh, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d)


def _causal_keep(sq, sk):
    return torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + (sk - sq)


def _fwd_tiled_bf16(q, k, v, causal, tile=64):
    """(out, lse) as ``flash_fwd_bf16`` computes them: 64-key tiles, scores
    times scale * log2(e), P rounded to bf16 for P.V and for l, lse =
    m ln 2 + log(max(l, 1e-30))."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = _grouped(q, kvh)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    sl2 = float(np.float32(np.float32(1 / np.sqrt(d)) * LOG2E))
    keep = _causal_keep(sq, sk)
    m = torch.full(qf.shape[:-1], -1e30)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, sk, tile):
        s = (qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2)) * sl2
        if causal:
            s = s.masked_fill(~keep[:, k0:k0 + tile], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None]).bfloat16().float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vf[..., k0:k0 + tile, :]
        m = m_new
    out = _ungrouped(acc / l.clamp_min(1e-30)[..., None]).bfloat16()
    lse = m * float(LN2) + torch.log(l.clamp_min(1e-30))
    return out, lse.reshape(b, h, sq)


def _delta_launch0(out, dout):
    """delta f32 [B, H, Sq] as ``bwd_delta`` forms it from the bf16 O and
    dO: each of L lanes sums the products of its 8 columns in order (a
    bf16 product is exact in f32, so fmaf rounds only the sum), then the
    lanes' partial sums meet in a butterfly of shuffles (xor L/2 .. 1),
    whose lane 0 writes the row."""
    b, sq, h, d = out.shape
    width = fa.head_width(d, fa.BWD_HEAD_DIMS)   # the zero-padded row
    lanes = width // 8
    prod = torch.nn.functional.pad(out.float() * dout.float(),
                                   (0, width - d)).reshape(b, sq, h, lanes, 8)
    part = torch.zeros(b, sq, h, lanes)
    for c in range(8):
        part = part + prod[..., c]
    m = lanes // 2
    while m:
        part = part + part[..., torch.arange(lanes) ^ m]
        m //= 2
    return part[..., 0].transpose(1, 2).contiguous()


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of x [S, D], zeros past its end (TMA's
    zero fill)."""
    got = x[r0:r0 + n]
    return torch.cat([got, got.new_zeros(n - got.shape[0], x.shape[1])]) \
        if got.shape[0] < n else got


def _bwd_bf16(q, k, v, out, lse, dout, causal, true_d=None):
    """(dq, dk, dv) as ``csrc/flash_attention_bwd.cu``'s bf16 kernels
    compute them, tile by tile and in their order: delta from launch 0;
    dK/dV blocks of 128 keys, two warpgroups of 64, walking every query
    head of their KV head and, for each, the NQ-row query tiles (NQ = 32
    at the padded width 128, else 64) from the block's causal diagonal
    on, skipping a tile where no key of the warpgroup reaches a row and
    masking (P = 0 by selection) only where the kernel's ``masked`` flag
    says so; dQ blocks of 128 rows, two warpgroups of 64, over 64-key
    tiles up to the diagonal. Per tile: S = exp2(s * f32(scale log2 e) -
    f32(lse log2 e)), P rounded to bf16 for dV, dS from the f32 P rounded
    to bf16 for dQ and dK, f32 sums, outputs rounded once."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    nq = 32 if fa.head_width(d, fa.BWD_HEAD_DIMS) == 128 else 64
    nk = 64
    scale = float(np.float32(1 / np.sqrt(true_d or d)))
    sl2 = float(np.float32(np.float32(scale) * LOG2E))
    off = sk - sq
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = _delta_launch0(out, dout)
    l2 = lse.float() * float(LOG2E)
    dq, dk, dv = torch.zeros(q.shape), torch.zeros(k.shape), \
        torch.zeros(v.shape)
    for bi in range(b):
        for kvi in range(kvh):
            for k0 in range(0, sk, 128):
                qt0 = max(0, k0 - off) // nq if causal else 0
                for kw0 in (k0, k0 + 64):
                    if kw0 >= sk:
                        continue
                    keys = torch.arange(kw0, kw0 + 64)[:, None]
                    kt, vt = (_rows(x[bi, :, kvi], kw0, 64) for x in (kf, vf))
                    acc_k, acc_v = torch.zeros(64, d), torch.zeros(64, d)
                    for hh in range(kvi * g, kvi * g + g):
                        for q0 in range(qt0 * nq, sq, nq):
                            if causal and kw0 > min(sq, q0 + nq) - 1 + off:
                                continue
                            masked = kw0 + 64 > sk or q0 + nq > sq or (
                                causal and kw0 + 63 > q0 + off)
                            qt, dot = (_rows(x[bi, :, hh], q0, nq)
                                       for x in (qf, dof))
                            lt, dlt = (_rows(x[bi, hh, :, None], q0, nq)[:, 0]
                                       for x in (l2, delta))
                            p = torch.exp2((kt @ qt.T) * sl2 - lt)
                            if masked:
                                rows = torch.arange(q0, q0 + nq)[None, :]
                                keep = (rows < sq) & (keys < sk)
                                if causal:
                                    keep &= keys <= rows + off
                                p = torch.where(keep, p, 0.0)
                            acc_v += p.bfloat16().float() @ dot
                            ds = p * ((vt @ dot.T) - dlt) * scale
                            acc_k += ds.bfloat16().float() @ qt
                    n = min(64, sk - kw0)
                    dk[bi, kw0:kw0 + n, kvi] = acc_k[:n]
                    dv[bi, kw0:kw0 + n, kvi] = acc_v[:n]
    for bi in range(b):
        for hh in range(h):
            kvi = hh // g
            for q0 in range(0, sq, 128):
                k_end = min(sk, min(sq, q0 + 128) + off) if causal else sk
                for qw0 in (q0, q0 + 64):
                    rows = min(64, sq - qw0)
                    if rows <= 0:
                        continue
                    r = torch.arange(qw0, qw0 + 64)[:, None]
                    qt, dot = (_rows(x[bi, :, hh], qw0, 64) for x in (qf, dof))
                    lt, dlt = (_rows(x[bi, hh, :, None], qw0, 64)
                               for x in (l2, delta))
                    acc = torch.zeros(64, d)
                    for kt0 in range(0, k_end, nk):
                        if causal and kt0 > qw0 + rows - 1 + off:
                            continue
                        masked = rows < 64 or kt0 + nk > sk or (
                            causal and kt0 + nk - 1 > qw0 + off)
                        kt, vt = (_rows(x[bi, :, kvi], kt0, nk)
                                  for x in (kf, vf))
                        p = torch.exp2((qt @ kt.T) * sl2 - lt)
                        if masked:
                            keys = torch.arange(kt0, kt0 + nk)[None, :]
                            keep = (r < sq) & (keys < sk)
                            if causal:
                                keep &= keys <= r + off
                            p = torch.where(keep, p, 0.0)
                        ds = p * ((dot @ vt.T) - dlt) * scale
                        acc += ds.bfloat16().float() @ kt
                    dq[bi, qw0:qw0 + rows, hh] = acc[:rows]
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _assert_within(got, want, tol, names=("dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        g, w = g.float(), w.float()
        bound = tol * float(w.abs().max())
        err = float((g - w).abs().max())
        assert torch.isfinite(g).all() and err <= bound, (name, err, bound)


# ragged tiles, GQA 1, 2 and 8, D 16, 64, 128 and the padded 48 and 112,
# causal Sq < Sk (G = 2 and 8), full Sq > Sk, Sk off the 128-key blocks,
# a 64-row multiple and TinyLlama's 32/4 heads
EMUL_SHAPES = [(1, 8, 1, 77, 77, 64, True), (1, 8, 8, 100, 130, 16, False),
               (1, 4, 1, 33, 70, 112, True), (2, 4, 2, 65, 65, 64, True),
               (1, 4, 4, 90, 40, 16, False), (1, 32, 4, 192, 192, 64, True),
               (1, 4, 2, 100, 300, 128, True), (1, 8, 1, 70, 200, 48, True),
               (2, 8, 1, 130, 130, 128, False)]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", EMUL_SHAPES)
def test_bf16_kernel_rounding_holds_the_chip_tolerance(b, h, kvh, sq, sk, d,
                                                       causal):
    """The emulated bf16 backward, fed the emulated bf16 forward's (out,
    lse), within BWD_BF16_TOL of the plain backward on the same inputs
    (the chip check's comparison), and the forward's lse within 2^-7 of
    the plain one (bf16 P in l)."""
    q, k, v, dout = _bf16(*_inputs(b, h, kvh, sq, sk, d, seed=sq + d))
    out, lse = _fwd_tiled_bf16(q, k, v, causal)
    _, plain_lse = fa.flash_attention_plain(q, k, v, causal,
                                            return_lse=True)
    assert float((lse - plain_lse).abs().max()) <= 2 ** -7
    got = _bwd_bf16(q, k, v, out, lse, dout, causal)
    want = tref.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    _assert_within(got, want, BWD_BF16_TOL)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", EMUL_SHAPES[::2])
def test_bf16_pipeline_holds_the_tolerance_against_plain_autograd(
        b, h, kvh, sq, sk, d, causal):
    """What the train path's one-layer check compares on the card: the
    kernels' forward and backward (emulated) against autograd through the
    materialised-scores attention, whose softmax and output stay f32
    inside. The bf16 O in delta and the bf16 rounding add up to under
    2^-7 of each gradient's largest magnitude here, inside 2^-6."""
    q, k, v, dout = _bf16(*_inputs(b, h, kvh, sq, sk, d, seed=sq * 3))
    out, lse = _fwd_tiled_bf16(q, k, v, causal)
    got = _bwd_bf16(q, k, v, out, lse, dout, causal)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, causal).backward(dout)
    _assert_within(got, (qr.grad, kr.grad, vr.grad), BWD_BF16_TOL)


@pytest.mark.parametrize("d", [16, 48, 64, 112, 128])
def test_delta_as_launch_0_forms_it_matches_the_f32_formula(d):
    """delta summed as ``bwd_delta`` sums it (per-lane runs of 8 columns,
    then a shuffle butterfly) from bf16 O and dO, against rowsum(dO * O)
    in f64 and in the f32 formula the wrapper used before launch 0: both
    within f32 rounding of a sum of d terms (1e-5 of the sum of the
    products' magnitudes)."""
    out, dout = (t.bfloat16() for t in (torch.from_numpy(a) for a in
                                        _inputs(2, 4, 4, 37, 37, d,
                                                seed=d)[::3]))
    got = _delta_launch0(out, dout)
    prod = out.double() * dout.double()
    bound = 1e-5 * prod.abs().sum(-1).transpose(1, 2)
    assert got.shape == (2, 4, 37) and got.dtype == torch.float32
    assert ((got.double() - prod.sum(-1).transpose(1, 2)).abs()
            <= bound).all()
    old = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    assert ((got - old).abs().double() <= bound).all()


def test_delta_from_the_bf16_output_costs_under_2_to_the_minus_7():
    """The reference takes delta from its f32 output; the port's forward
    rounds O to bf16 and delta is formed from that. The cost, on the
    plain backward: within 2^-7 of each gradient's largest magnitude."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(1, 32, 4, 128, 128, 64, seed=5))
    out, lse = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True)
    got = fa.flash_attention_bwd_plain(q, k, v, out.bfloat16().float(), lse,
                                       dout, True)
    _assert_within(got, want, 2 ** -7)


@pytest.mark.parametrize("d", [12, 48, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_on_zero_padded_heads_equals_unpadded(d, causal):
    """What the backward wrapper launches for a D it does not compile:
    q, k, v, dO zero-padded to the next width, the true D's scale, the
    gradients' padding columns cut off: the unpadded gradients (zero
    columns add exact zeros to every score and to dP)."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(1, 4, 2, 33, 50, d, seed=d))
    out, lse = fa.flash_attention_plain(q, k, v, causal, return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    width = fa.head_width(d, fa.BWD_HEAD_DIMS)
    qp, kp, vp = fa.pad_head_dim(q, k, v, width)
    dop, outp = (torch.nn.functional.pad(t, (0, width - d))
                 for t in (dout, out))
    got = fa.flash_attention_bwd_plain(qp, kp, vp, outp, lse, dop, causal,
                                       scale=1.0 / d ** 0.5)
    for g, w in zip(got, want):
        assert not g[..., d:].any()
        torch.testing.assert_close(g[..., :d], w, rtol=1e-6, atol=1e-6)


def test_without_grad_the_forward_is_todays_plain_call():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 9, 9, 16))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


def test_bwd_wrapper_refuses_cpu_tensors_and_counts_nothing_on_the_cpu():
    ops.reset_launch_counts()
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(1, 4, 2, 9, 9, 16))
    out, lse = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, return_lse=True)
    _port_grads(*(x.numpy() for x in (q, k, v, dout)), True)
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == 0
    assert counts["flash_attention"] == 0
