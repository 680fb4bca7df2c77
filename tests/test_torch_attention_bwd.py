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

The hybrid family's sliding window and meta tokens, both ways: through
the port's model-level ``attention`` (``disable_window`` sends a global
layer's window 0) against ``jax.vjp`` of the reference's ``attention``
with the same ``window``, ``meta_tokens`` and ``disable_window``, at
windows 1, 17, 64 and >= Sk, meta 0 and 8, G = 1 and 5, Sq = Sk and Sq <
Sk; float32 at the causal cases' 1e-4 relative and 1e-5 absolute (at
1e-6 absolute a window of 1 fails by 1.2e-6: a row that sees only its
own key has P = 1 and dP - delta = 0 in exact arithmetic, so its dq is
f32 rounding of a cancelled sum in both packages), bfloat16 within 2^-6
of each gradient's largest magnitude.

Then the bf16 kernel's own rounding, emulated in plain torch at the
points ``csrc/flash_attention_bwd.cu`` rounds (P and dS to bf16 before
their products, exp2 of a scale * log2(e) product, lse * log2(e) in f32,
outputs rounded once), is held to the f32 plain backward on the same
inputs within ``BWD_BF16_TOL`` of each gradient's largest magnitude: the
bound ``chip_smoke.py`` holds the kernel to on the card. The emulation
walks the kernels' tiles as they do, the window's included: the rows a
dK/dV block walks, the key tiles a dQ block walks and in which order,
the tiles a warpgroup skips and those it masks element by element. The
tile ranges themselves (``csrc/attention_mask.cuh``, mirrored here) are
pinned on their own: every pair the mask lets through lies in a walked,
unskipped tile, every unmasked tile holds only such pairs, the launch
order is longest first, and a window of at least Sk walks the causal
tiles in the causal order.
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
from repro_torch.models import attention as tattn  # noqa: E402

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
    _, lse, _ = fa.flash_attention_plain(*(torch.from_numpy(x) for x in
                                           (q, k, v)), causal,
                                         return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _, want = ref_attn._flash_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.zeros(()), causal, 0, 0,
        _chunk(sk, causal))
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(b, h, sq), **F32_TOL)


# ------------------------------------------- the window and meta tokens

# (B, H, KVH, Sq, Sk, D, window, meta_tokens, disable_window): windows 1,
# 17, 64 and >= Sk, meta 0 and 8, G = 1 and 5 (hymba's 25 / 5), Sq = Sk
# and Sq < Sk, a global layer (disable_window) and no window with meta
# tokens (the gradient flows as plain causal attention's)
WINDOW_SHAPES = [(1, 5, 1, 40, 40, 16, 1, 0, False),
                 (2, 5, 5, 40, 40, 16, 1, 8, False),
                 (1, 10, 2, 70, 70, 16, 17, 0, False),
                 (1, 5, 1, 33, 90, 16, 17, 8, False),
                 (1, 4, 4, 100, 100, 16, 64, 0, False),
                 (1, 5, 1, 70, 100, 32, 64, 8, False),
                 (1, 5, 1, 48, 48, 16, 48, 0, False),
                 (2, 10, 2, 30, 50, 16, 77, 8, False),
                 (1, 5, 1, 64, 64, 16, 17, 8, True),
                 (1, 10, 2, 40, 60, 16, 1, 0, True),
                 (1, 2, 2, 8, 8, 16, 0, 1, False)]


def _window_grads(q, k, v, dout, window, meta, dw, dtype=torch.float32):
    """(out, dq, dk, dv) through the port's model-level attention."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    out = tattn.attention(q, k, v, window=window, meta_tokens=meta,
                          disable_window=dw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(dout).to(dtype))
    return [t.detach() for t in (out, q.grad, k.grad, v.grad)]


def _window_ref(q, k, v, dout, window, meta, dw):
    out, vjp = jax.vjp(lambda q_, k_, v_: ref_attn.attention(
        q_, k_, v_, window=window, meta_tokens=meta, chunk=16,
        disable_window=jnp.asarray(dw)), *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,window,meta,dw", WINDOW_SHAPES)
def test_windowed_backward_matches_reference_vjp(b, h, kvh, sq, sk, d,
                                                 window, meta, dw):
    q, k, v, dout = _inputs(b, h, kvh, sq, sk, d, seed=window + sq)
    got = _window_grads(q, k, v, dout, window, meta, dw)
    want = _window_ref(q, k, v, dout, window, meta, dw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,window,meta,dw",
                         WINDOW_SHAPES[1:9:2])
def test_windowed_backward_in_bf16_within_2_to_the_minus_6(
        b, h, kvh, sq, sk, d, window, meta, dw):
    """bf16 inputs through the port (plain versions, bf16 gradients)
    against the reference's f32 vjp on the same bf16-rounded inputs."""
    arrays = [np.asarray(torch.from_numpy(a).bfloat16().float())
              for a in _inputs(b, h, kvh, sq, sk, d, seed=window + 1)]
    got = _window_grads(*arrays, window, meta, dw, dtype=torch.bfloat16)
    want = _window_ref(*arrays, window, meta, dw)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.dtype == torch.bfloat16, name
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= BWD_BF16_TOL * float(np.abs(w).max()), (name, err)


def test_windowed_bwd_plain_refuses_a_window_without_causal():
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(1, 2, 2, 8, 8, 16))
    _, lse, out = fa.flash_attention_plain(q, k, v, return_lse=True)
    for kw in (dict(causal=False, window=4), dict(window=-1),
               dict(window=4, meta_tokens=-1)):
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)


# ----------------------------------------------- the bf16 kernel's rounding


def _grouped(x, kvh):
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _ungrouped(x):
    b, kvh, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d)


# csrc/attention_mask.cuh, mirrored


def _visible(j, p, causal, window, meta):
    """Key(s) j visible to the query at position(s) p (numpy or ints)."""
    hidden_by_window = (window > 0) & (j >= meta) & (j <= p - window)
    return ~((causal & (j > p)) | hidden_by_window)


def _window_hides_tile(k0, n, p, window, meta):
    return window > 0 and k0 >= meta and k0 + n - 1 <= p - window


def _window_cuts_tile(k0, p_last, window, meta):
    return window > 0 and max(k0, meta) <= p_last - window


def _key_tiles(k_end, tile, p_first, window, meta):
    """The first keys of the tiles a block walks, in order (KeyTiles)."""
    t_end = -(-k_end // tile)
    n_meta, t_lo = 0, 0
    if window > 0:
        n_meta = min(-(-meta // tile), t_end)
        t_lo = max(n_meta, max(0, p_first - window + 1) // tile)
    return [t * tile for t in list(range(n_meta)) + list(range(t_lo, t_end))]


def _window_rows_end(k_first, k_last, sq, off, window, meta):
    if window <= 0 or k_first < meta:
        return sq
    return max(0, min(sq, k_last + window - off))


def _dq_tiles(qb, rows, sq, sk, tile, causal, window, meta):
    off = sk - sq
    q0 = qb * rows
    k_end = min(sk, min(sq, q0 + rows) + off) if causal else sk
    return _key_tiles(k_end, tile, q0 + off, window, meta)


def _dq_longest_first(i, sq, sk, rows, tile, causal, window, meta):
    n = -(-sq // rows)
    if not causal:
        return i
    if window <= 0 or sq % rows == 0:
        return n - 1 - i

    def count(qb):
        return len(_dq_tiles(qb, rows, sq, sk, tile, causal, window, meta))
    last = count(n - 1)
    ahead = 0
    while ahead < n - 1 and count(n - 2 - ahead) > last:
        ahead += 1
    return n - 2 - i if i < ahead else n - 1 if i == ahead else n - 1 - i


def _dkdv_longest_first(i, sq, sk, keys, nq, causal, window, meta):
    n = -(-sk // keys)
    m = min(n, -(-meta // keys))

    def count(kb):
        return len(_dkdv_rows(kb * keys, keys, nq, sq, sk, causal, window,
                              meta))
    if window <= 0 or i < m:
        return i
    counts = [count(kb) for kb in range(m, n)]
    peak = m + counts.index(max(counts))
    r, l = peak, peak - 1
    for j in range(m, n):
        right = r < n and (l < m or count(r) >= count(l))
        kb, r, l = (r, r + 1, l) if right else (l, r, l - 1)
        if j == i:
            return kb


def _dkdv_rows(k0, n_keys, nq, sq, sk, causal, window, meta):
    """The query tiles (first rows) a dK/dV block of keys k0 .. k0 +
    n_keys - 1 walks: from its diagonal to the last row its keys' windows
    reach, in NQ-row tiles."""
    off = sk - sq
    first = max(0, k0 - off) // nq * nq if causal else 0
    end = -(-_window_rows_end(k0, min(k0 + n_keys, sk) - 1, sq, off, window,
                              meta) // nq) * nq
    return list(range(first, end, nq))


def _fwd_tiled_bf16(q, k, v, causal, tile=64, window=0, meta=0):
    """(out, lse, out_f32) as ``flash_fwd_bf16`` computes them: 64-key
    tiles, scores times scale * log2(e), P rounded to bf16 for P.V and for
    l, lse = m ln 2 + log(max(l, 1e-30)), the f32 output rounded once to
    bf16. A tile masked for a row before its first
    visible key gives p = 1 that the next visible tile's correction
    clears, after it p = 0, as in the kernel."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = _grouped(q, kvh)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    sl2 = float(np.float32(np.float32(1 / np.sqrt(d)) * LOG2E))
    keep = ~fa._hidden(sq, sk, "cpu", True, window, meta)
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
    out = _ungrouped(acc / l.clamp_min(1e-30)[..., None])
    lse = m * float(LN2) + torch.log(l.clamp_min(1e-30))
    return out.bfloat16(), lse.reshape(b, h, sq), out


def _delta_launch0(out, dout):
    """delta f32 [B, H, Sq] as ``bwd_delta`` forms it from the f32 O and
    the bf16 dO: each of L lanes sums the products of its 8 columns in
    order with fmaf (the product of an f32 and a bf16 is exact in f64, so
    each step rounds once, to f32), then the lanes' partial sums meet in a
    butterfly of shuffles (xor L/2 .. 1), whose lane 0 writes the row."""
    b, sq, h, d = out.shape
    width = fa.head_width(d, fa.BWD_HEAD_DIMS)   # the zero-padded row
    lanes = width // 8
    prod = torch.nn.functional.pad(out.double() * dout.double(),
                                   (0, width - d)).reshape(b, sq, h, lanes, 8)
    part = torch.zeros(b, sq, h, lanes)
    for c in range(8):
        part = (part.double() + prod[..., c]).float()
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


def _bwd_bf16(q, k, v, out, lse, dout, causal, true_d=None, window=0,
              meta=0):
    """(dq, dk, dv) as ``csrc/flash_attention_bwd.cu``'s bf16 kernels
    compute them, tile by tile and in their order: delta from launch 0;
    dK/dV blocks of 128 keys, two warpgroups of 64, walking every query
    head of their KV head and, for each, the NQ-row query tiles (NQ = 32
    at the padded width 128, else 64) from the block's causal diagonal to
    the last row its keys' windows reach (``_dkdv_rows``), skipping a
    tile where no key of the warpgroup reaches a row (past the diagonal,
    or hidden by the window) and masking (P = 0 by selection) only where
    the kernel's ``masked`` flag says so; dQ blocks of 128 rows, two
    warpgroups of 64, over the 64-key tiles of ``_dq_tiles`` (the meta
    tiles, then the first row's window start to the diagonal), skipping
    and masking likewise. Per tile: S = exp2(s * f32(scale log2 e) -
    f32(lse log2 e)), P rounded to bf16 for dV, dS from the f32 P rounded
    to bf16 for dQ and dK, f32 sums, outputs rounded once. ``out`` is the
    forward's f32 output, as the kernels take it."""
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
            for i in range(-(-sk // 128)):
                k0 = 128 * _dkdv_longest_first(i, sq, sk, 128, nq, causal,
                                               window, meta)
                q_tiles = _dkdv_rows(k0, 128, nq, sq, sk, causal, window,
                                     meta)
                for kw0 in (k0, k0 + 64):
                    if kw0 >= sk:
                        continue
                    keys = torch.arange(kw0, kw0 + 64)[:, None]
                    kt, vt = (_rows(x[bi, :, kvi], kw0, 64) for x in (kf, vf))
                    acc_k, acc_v = torch.zeros(64, d), torch.zeros(64, d)
                    for hh in range(kvi * g, kvi * g + g):
                        for q0 in q_tiles:
                            if causal and kw0 > min(sq, q0 + nq) - 1 + off \
                                    or _window_hides_tile(kw0, 64, q0 + off,
                                                          window, meta):
                                continue
                            masked = kw0 + 64 > sk or q0 + nq > sq or (
                                causal and kw0 + 63 > q0 + off) or \
                                _window_cuts_tile(kw0, q0 + nq - 1 + off,
                                                  window, meta)
                            qt, dot = (_rows(x[bi, :, hh], q0, nq)
                                       for x in (qf, dof))
                            lt, dlt = (_rows(x[bi, hh, :, None], q0, nq)[:, 0]
                                       for x in (l2, delta))
                            p = torch.exp2((kt @ qt.T) * sl2 - lt)
                            if masked:
                                rows = torch.arange(q0, q0 + nq)[None, :]
                                keep = (rows < sq) & (keys < sk) & _visible(
                                    keys, rows + off, causal, window, meta)
                                p = torch.where(keep, p, 0.0)
                            acc_v += p.bfloat16().float() @ dot
                            ds = p * ((vt @ dot.T) - dlt) * scale
                            acc_k += ds.bfloat16().float() @ qt
                    n = min(64, sk - kw0)
                    dk[bi, kw0:kw0 + n, kvi] = acc_k[:n]
                    dv[bi, kw0:kw0 + n, kvi] = acc_v[:n]
    n_qb = -(-sq // 128)
    for bi in range(b):
        for hh in range(h):
            kvi = hh // g
            for i in range(n_qb):
                qb = _dq_longest_first(i, sq, sk, 128, nk, causal, window,
                                       meta)
                q0 = qb * 128
                k_tiles = _dq_tiles(qb, 128, sq, sk, nk, causal, window,
                                    meta)
                for qw0 in (q0, q0 + 64):
                    rows = min(64, sq - qw0)
                    if rows <= 0:
                        continue
                    r = torch.arange(qw0, qw0 + 64)[:, None]
                    qt, dot = (_rows(x[bi, :, hh], qw0, 64) for x in (qf, dof))
                    lt, dlt = (_rows(x[bi, hh, :, None], qw0, 64)
                               for x in (l2, delta))
                    acc = torch.zeros(64, d)
                    for kt0 in k_tiles:
                        if causal and kt0 > qw0 + rows - 1 + off or \
                                _window_hides_tile(kt0, nk, qw0 + off, window,
                                                   meta):
                            continue
                        masked = rows < 64 or kt0 + nk > sk or (
                            causal and kt0 + nk - 1 > qw0 + off) or \
                            _window_cuts_tile(kt0, qw0 + 63 + off, window,
                                              meta)
                        kt, vt = (_rows(x[bi, :, kvi], kt0, nk)
                                  for x in (kf, vf))
                        p = torch.exp2((qt @ kt.T) * sl2 - lt)
                        if masked:
                            keys = torch.arange(kt0, kt0 + nk)[None, :]
                            keep = (r < sq) & (keys < sk) & _visible(
                                keys, r + off, causal, window, meta)
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
    _, lse, out = _fwd_tiled_bf16(q, k, v, causal)
    _, plain_lse, _ = fa.flash_attention_plain(q, k, v, causal,
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
    _, lse, out = _fwd_tiled_bf16(q, k, v, causal)
    got = _bwd_bf16(q, k, v, out, lse, dout, causal)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, causal).backward(dout)
    _assert_within(got, (qr.grad, kr.grad, vr.grad), BWD_BF16_TOL)


# full attention off both tiles (the dK/dV blocks' 128 keys and the dQ
# blocks' 64-key tiles): Sq = Sk = 150 and Sq 45 x Sk 150 (the shapes of
# whisper's encoder and cross-attention, cut), and D 128 at G = 8 (NQ =
# 32 query steps; internvl2's 64 / 8 heads of 128), full and causal
FULL_EMUL_SHAPES = [(1, 4, 4, 150, 150, 64, False),
                    (2, 4, 4, 45, 150, 64, False),
                    (1, 8, 1, 150, 150, 128, False),
                    (1, 8, 1, 150, 150, 128, True)]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", FULL_EMUL_SHAPES)
def test_full_and_d128_backward_matches_reference_vjp(b, h, kvh, sq, sk, d,
                                                      causal):
    """The plain backward through the autograd Function against the
    reference's ``custom_vjp`` (``causal=False`` over a chunk dividing Sk)
    at the emulated shapes, in float32."""
    q, k, v, dout = _inputs(b, h, kvh, sq, sk, d, seed=sq + sk + d)
    got = _port_grads(q, k, v, dout, causal)
    want = _ref_grads(q, k, v, dout, causal, _chunk(sk, causal))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", FULL_EMUL_SHAPES)
def test_bf16_full_and_d128_kernel_rounding_holds_the_chip_tolerance(
        b, h, kvh, sq, sk, d, causal):
    """The emulated bf16 backward (the kernels' walks and rounding, fed
    the emulated forward's f32 output and lse) within BWD_BF16_TOL of the
    plain backward on the same inputs, and of autograd through the
    materialised-scores attention (the train paths' layer check)."""
    q, k, v, dout = _bf16(*_inputs(b, h, kvh, sq, sk, d, seed=sq * 7 + d))
    _, lse, out = _fwd_tiled_bf16(q, k, v, causal)
    got = _bwd_bf16(q, k, v, out, lse, dout, causal)
    _assert_within(got, tref.flash_attention_bwd_plain(q, k, v, out, lse,
                                                       dout, causal),
                   BWD_BF16_TOL)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, causal).backward(dout)
    _assert_within(got, (qr.grad, kr.grad, vr.grad), BWD_BF16_TOL)


# (B, H, KVH, Sq, Sk, D, window, meta): a window inside a 64-key tile,
# across a tile edge and of whole tiles, meta 0, 8 (a block mixing meta
# and windowed keys) and 128, G = 5, Sq < Sk, a ragged last query block
# behind whole ones that walk more tiles, NQ = 32 (D 128)
WINDOW_EMUL_SHAPES = [(1, 5, 1, 300, 300, 64, 64, 8),
                      (1, 5, 1, 200, 330, 16, 17, 0),
                      (1, 10, 2, 333, 333, 64, 128, 128),
                      (1, 4, 4, 260, 260, 128, 1, 8),
                      (1, 5, 1, 522, 522, 16, 100, 0)]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,window,meta", WINDOW_EMUL_SHAPES)
def test_bf16_windowed_kernel_holds_the_chip_tolerance(b, h, kvh, sq, sk, d,
                                                       window, meta):
    """The emulated bf16 backward under the window and meta tokens (the
    kernels' row ranges, key-tile order, skips and masks), fed the
    emulated forward's (out, lse), within BWD_BF16_TOL of the plain
    backward, with no NaN or inf."""
    q, k, v, dout = _bf16(*_inputs(b, h, kvh, sq, sk, d, seed=window + sq))
    _, lse, out = _fwd_tiled_bf16(q, k, v, True, window=window, meta=meta)
    _, plain_lse, _ = fa.flash_attention_plain(q, k, v, window=window,
                                               meta_tokens=meta,
                                               return_lse=True)
    assert float((lse - plain_lse).abs().max()) <= 2 ** -7
    got = _bwd_bf16(q, k, v, out, lse, dout, True, window=window, meta=meta)
    want = tref.flash_attention_bwd_plain(q, k, v, out, lse, dout, True,
                                          window=window, meta_tokens=meta)
    _assert_within(got, want, BWD_BF16_TOL)


@pytest.mark.parametrize("meta", [0, 8])
def test_bf16_emulation_with_a_window_of_at_least_sk_is_causal_exactly(meta):
    q, k, v, dout = _bf16(*_inputs(1, 5, 1, 150, 200, 16, seed=meta))
    _, lse, out = _fwd_tiled_bf16(q, k, v, True)
    want = _bwd_bf16(q, k, v, out, lse, dout, True)
    for window in (200, 333):
        got = _bwd_bf16(q, k, v, out, lse, dout, True, window=window,
                        meta=meta)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# (Sq, Sk, causal, window, meta, NQ): hymba's layer (2176 slots, window
# 1024, 128 meta tokens), ragged blocks, Sq < Sk, meta 8 (not a multiple
# of a tile), windows 1 and 17, plain causal, full attention, a window of
# at least Sk, and NQ = 32 (D 128)
RANGE_CASES = [(2176, 2176, True, 1024, 128, 64),
               (333, 333, True, 128, 128, 64),
               (522, 522, True, 100, 0, 64),
               (100, 2176, True, 17, 0, 64),
               (1, 300, True, 64, 128, 64),
               (200, 200, True, 17, 8, 32),
               (130, 130, True, 1, 0, 64),
               (200, 260, True, 0, 0, 64),
               (81, 200, False, 0, 0, 64),
               (300, 300, True, 300, 8, 64)]


def _visible_pairs(sq, sk, causal, window, meta):
    """[Sq, Sk] bool: the pairs the mask lets through."""
    return _visible(np.arange(sk)[None, :], np.arange(sq)[:, None] + sk - sq,
                    causal, window, meta)


@pytest.mark.parametrize("sq,sk,causal,window,meta,nq", RANGE_CASES)
def test_wgmma_tile_ranges_cover_the_mask_longest_first(sq, sk, causal,
                                                        window, meta, nq):
    """The bf16 kernels' walks: every visible pair lies in a tile some
    warpgroup computes, and a tile computed without the element mask holds
    only visible, in-range pairs; dK/dV blocks (``dkdv_longest_first``)
    and dQ blocks (``dq_longest_first``), each a permutation, go out
    longest first; in key-block order wherever Sq = Sk."""
    off = sk - sq
    vis = _visible_pairs(sq, sk, causal, window, meta)
    pad = np.zeros((sq + 128, sk + 128), bool)
    pad[:sq, :sk] = vis
    covered = np.zeros_like(pad)
    n_kb = -(-sk // 128)
    kbs = [_dkdv_longest_first(i, sq, sk, 128, nq, causal, window, meta)
           for i in range(n_kb)]
    assert sorted(kbs) == list(range(n_kb))
    assert sq != sk or kbs == list(range(n_kb))
    lengths = []
    for k0 in (128 * kb for kb in kbs):
        tiles = _dkdv_rows(k0, 128, nq, sq, sk, causal, window, meta)
        lengths.append(len(tiles))
        for kw0 in (k0, k0 + 64):
            for q0 in tiles if kw0 < sk else ():
                if causal and kw0 > min(sq, q0 + nq) - 1 + off or \
                        _window_hides_tile(kw0, 64, q0 + off, window, meta):
                    continue
                covered[q0:q0 + nq, kw0:kw0 + 64] = True
                masked = kw0 + 64 > sk or q0 + nq > sq or (
                    causal and kw0 + 63 > q0 + off) or \
                    _window_cuts_tile(kw0, q0 + nq - 1 + off, window, meta)
                assert masked or pad[q0:q0 + nq, kw0:kw0 + 64].all()
    assert not (pad & ~covered).any()
    assert lengths == sorted(lengths, reverse=True)

    n_qb = -(-sq // 128)
    order = [_dq_longest_first(i, sq, sk, 128, 64, causal, window, meta)
             for i in range(n_qb)]
    assert sorted(order) == list(range(n_qb))
    counts = [len(_dq_tiles(qb, 128, sq, sk, 64, causal, window, meta))
              for qb in order]
    assert counts == sorted(counts, reverse=True)
    covered[:] = False
    for qb in order:
        for qw0 in (qb * 128, qb * 128 + 64):
            rows = min(64, sq - qw0)
            tiles = _dq_tiles(qb, 128, sq, sk, 64, causal, window, meta)
            assert len(set(tiles)) == len(tiles)
            for kt0 in tiles if rows > 0 else ():
                if causal and kt0 > qw0 + rows - 1 + off or \
                        _window_hides_tile(kt0, 64, qw0 + off, window, meta):
                    continue
                covered[qw0:qw0 + rows, kt0:kt0 + 64] = True
                masked = rows < 64 or kt0 + 64 > sk or (
                    causal and kt0 + 63 > qw0 + off) or \
                    _window_cuts_tile(kt0, qw0 + 63 + off, window, meta)
                assert masked or pad[qw0:qw0 + 64, kt0:kt0 + 64].all()
    assert not (pad & ~covered).any()
    if (sq, window) == (522, 100):   # the ragged block goes after three
        assert order == [3, 2, 1, 4, 0]


@pytest.mark.parametrize("sq,sk,causal,window,meta,nq", RANGE_CASES)
def test_f32_kernel_ranges_cover_the_mask(sq, sk, causal, window, meta, nq):
    """The f32 kernels' walks: a dK/dV block of 64 keys walks 32-row tiles
    from its diagonal to ``window_rows_end``; a dQ block of 64 rows walks
    32-key ``KeyTiles``. Every visible pair lies in them."""
    off = sk - sq
    vis = _visible_pairs(sq, sk, causal, window, meta)
    for k0 in range(0, sk, 64):
        first = max(0, k0 - off) // 32 * 32 if causal else 0
        end = _window_rows_end(k0, min(k0 + 64, sk) - 1, sq, off, window,
                               meta)
        rows = np.nonzero(vis[:, k0:k0 + 64].any(1))[0]
        assert rows.size == 0 or first <= rows[0] and rows[-1] < end
    for q0 in range(0, sq, 64):
        k_end = min(sk, min(sq, q0 + 64) + off) if causal else sk
        walked = np.zeros(sk, bool)
        for c0 in _key_tiles(k_end, 32, q0 + off, window, meta):
            walked[c0:c0 + 32] = True
        assert not (vis[q0:q0 + 64].any(0) & ~walked).any()


# the train paths' own shapes: whisper's encoder (full, 1500 x 1500) and
# cross-attention (full, 448 x 1500), and internvl2's layer (causal, 1024
# x 1024, NQ = 32 at D 128)
PATH_RANGE_CASES = [(1500, 1500, False, 0, 0, 64),
                    (448, 1500, False, 0, 0, 64),
                    (1024, 1024, True, 0, 0, 32)]


@pytest.mark.parametrize("sq,sk,causal,window,meta,nq", PATH_RANGE_CASES)
def test_tile_ranges_cover_the_mask_at_the_train_paths_shapes(
        sq, sk, causal, window, meta, nq):
    test_wgmma_tile_ranges_cover_the_mask_longest_first(sq, sk, causal,
                                                        window, meta, nq)
    test_f32_kernel_ranges_cover_the_mask(sq, sk, causal, window, meta, nq)


@pytest.mark.parametrize("meta", [0, 8, 128])
def test_a_window_of_at_least_sk_walks_the_causal_tiles(meta):
    sq, sk = 333, 400
    for window in (sk, sk + 50):
        for k0 in range(0, sk, 64):
            for n, nq in ((128, 64), (128, 32), (64, 32)):
                assert _dkdv_rows(k0, n, nq, sq, sk, True, window, meta) == \
                    _dkdv_rows(k0, n, nq, sq, sk, True, 0, 0)
        for rows, tile in ((128, 64), (64, 32)):
            for qb in range(-(-sq // rows)):
                assert _dq_tiles(qb, rows, sq, sk, tile, True, window,
                                 meta) == _dq_tiles(qb, rows, sq, sk, tile,
                                                    True, 0, 0)
                assert _dq_longest_first(qb, sq, sk, rows, tile, True,
                                         window, meta) == _dq_longest_first(
                    qb, sq, sk, rows, tile, True, 0, 0)
        for i in range(-(-sk // 128)):
            assert _dkdv_longest_first(i, sq, sk, 128, 64, True, window,
                                       meta) == i


@pytest.mark.parametrize("d", [16, 48, 64, 112, 128])
def test_delta_as_launch_0_forms_it_matches_the_f32_formula(d):
    """delta summed as ``bwd_delta`` sums it (per-lane runs of 8 columns,
    then a shuffle butterfly) from the f32 O and the bf16 dO, against
    rowsum(dO * O) in f64 and in the f32 formula of the plain backward:
    both within f32 rounding of a sum of d terms (1e-5 of the sum of the
    products' magnitudes)."""
    out, dout = (torch.from_numpy(a) for a in
                 _inputs(2, 4, 4, 37, 37, d, seed=d)[::3])
    dout = dout.bfloat16()
    got = _delta_launch0(out, dout)
    prod = out.double() * dout.double()
    bound = 1e-5 * prod.abs().sum(-1).transpose(1, 2)
    assert got.shape == (2, 4, 37) and got.dtype == torch.float32
    assert ((got.double() - prod.sum(-1).transpose(1, 2)).abs()
            <= bound).all()
    plain = (dout.float() * out).sum(-1).transpose(1, 2)
    assert ((got - plain).abs().double() <= bound).all()


def test_delta_from_the_bf16_output_costs_under_2_to_the_minus_7():
    """The reference takes delta from its f32 output, and so does the
    port's backward. What forming it from the output rounded to bf16
    would cost at TinyLlama's head layout (causal, keys of zero mean), on
    the plain backward: within 2^-7 of each gradient's largest
    magnitude."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(1, 32, 4, 128, 128, 64, seed=5))
    _, lse, out = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True)
    got = fa.flash_attention_bwd_plain(q, k, v, out.bfloat16().float(), lse,
                                       dout, True)
    _assert_within(got, want, 2 ** -7)


def test_delta_from_the_bf16_output_fails_full_attention_over_keys_of_a_mean():
    """Full attention of 45 queries over 1500 keys and values that share a
    mean (a cross-attention over an encoder's normed output, with no
    rotary embedding to turn it): the rounding of a bf16 O enters delta,
    and through dS = P (dP - delta) every key of its row alike, so dQ = dS
    K takes the keys' mean with it where it would cancel. The emulated
    bf16 backward fed the bf16 O puts dQ more than 2^-6 of its largest
    magnitude off autograd through the plain attention; fed the f32 O, as
    the kernels take it, it holds BWD_BF16_TOL."""
    q, k, v, dout = _inputs(1, 2, 2, 45, 1500, 64, seed=9)
    mean = np.random.default_rng(10).standard_normal((1, 1, 2, 64)) * 2
    q, k, v, dout = _bf16(q * 0.3, k + mean, v + mean, dout)
    rounded, lse, out = _fwd_tiled_bf16(q, k, v, False)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, False).backward(dout)
    want = (qr.grad, kr.grad, vr.grad)
    _assert_within(_bwd_bf16(q, k, v, out, lse, dout, False), want,
                   BWD_BF16_TOL)
    dq = _bwd_bf16(q, k, v, rounded.float(), lse, dout, False)[0]
    err = float((dq.float() - want[0].float()).abs().max())
    assert err > BWD_BF16_TOL * float(want[0].float().abs().max())


@pytest.mark.parametrize("d", [12, 48, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_on_zero_padded_heads_equals_unpadded(d, causal):
    """What the backward wrapper launches for a D it does not compile:
    q, k, v, dO zero-padded to the next width, the true D's scale, the
    gradients' padding columns cut off: the unpadded gradients (zero
    columns add exact zeros to every score and to dP)."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(1, 4, 2, 33, 50, d, seed=d))
    _, lse, out = fa.flash_attention_plain(q, k, v, causal, return_lse=True)
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
    _, lse, out = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, return_lse=True)
    _port_grads(*(x.numpy() for x in (q, k, v, dout)), True)
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == 0
    assert counts["flash_attention"] == 0
