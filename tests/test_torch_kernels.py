"""The port's kernels, as their plain PyTorch versions run on the CPU,
against the reference's oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode, on the same numpy inputs.

Masked kernels: d2 is held to rtol=atol=1e-4 (float32 sums in another
order, as in tests/test_kernels.py); id sets must match. Unmasked
``l2_topk``: ids equal position by position, d2 to rtol 1e-5 with an atol
of 1e-5 of the largest |q|^2 + |x|^2 (the expanded form's float32 error
scales with the norms, not with the distance). ``pq_adc``: rtol 1e-5
(8 terms summed in another order). On integer-valued inputs every sum is
exact, so ids must match position by position: that checks the tie rule
(lower pool position or id first). ``flash_attention``: float32 outputs
to rtol=atol=1e-5 (sums in another order, the scale applied before the
product rather than after, the online softmax of the Pallas kernel against
one softmax); bfloat16 outputs to one bfloat16 step (rtol=atol=2^-7), since
both sides compute in float32 and round once at the end. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.data.vectors import brute_force_knn as ref_knn  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.distances import topk_l2  # noqa: E402
from repro_torch.data.vectors import brute_force_knn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import l2_topk, ops, pq_adc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

# tests/test_kernels.py:28-31, plus k=200 (block >= C: one Pallas block,
# see ROADMAP queue 3 on short rows across blocks); pq_adc_masked is in
# tests/test_torch_adc.py
L2_SHAPES = [(4, 96, 16, 5, 32), (9, 257, 32, 10, 128), (6, 40, 24, 64, 64),
             (5, 300, 32, 200, 512)]


def _ragged_ids(rng, qn, c, min_len=0):
    ids = rng.permutation(1 << 20)[:c].astype(np.int32)
    lens = np.linspace(min_len, c, qn).astype(int)
    return np.where(np.arange(c)[None, :] < lens[:, None], ids[None, :],
                    -1).astype(np.int32)


def _same_sets(a, b):
    for x, y in zip(np.asarray(a), np.asarray(b)):
        assert set(x.tolist()) == set(y.tolist())


def _l2_inputs(qn, c, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    pools = rng.standard_normal((qn, c, d)).astype(np.float32)
    return q, pools, _ragged_ids(rng, qn, c)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("qn,c,d,k,block", L2_SHAPES)
def test_l2_plain_matches_ref_and_pallas(qn, c, d, k, block):
    q, pools, ids = _l2_inputs(qn, c, d, seed=qn * c)
    d2, oi = ops.l2_topk_masked(*_t(q, pools, ids), k=k)
    assert d2.dtype == torch.float32 and oi.dtype == torch.int32
    for rd, ri in (ref.l2_topk_masked_ref(jnp.asarray(q), jnp.asarray(pools),
                                          jnp.asarray(ids), k),
                   ref_ops.l2_topk_masked(jnp.asarray(q), jnp.asarray(pools),
                                          jnp.asarray(ids), k=k,
                                          block_c=block, interpret=True)):
        np.testing.assert_allclose(d2.numpy(), np.asarray(rd), rtol=1e-4,
                                   atol=1e-4)
        _same_sets(oi, ri)
    # short rows end in explicit padding
    short = oi.numpy()[(ids >= 0).sum(1) < k]
    assert (short[:, -1] == -1).all()


@pytest.mark.parametrize("k", [5, 64])
def test_empty_pools_give_sentinels(k):
    # C == 0: every row is padding, in both kernels' plain versions
    q = np.zeros((3, 16), np.float32)
    d2, oi = ops.l2_topk_masked(*_t(q, np.zeros((3, 0, 16), np.float32),
                                    np.zeros((3, 0), np.int32)), k=k)
    rd, ri = ref.l2_topk_masked_ref(jnp.asarray(q),
                                    jnp.zeros((3, 0, 16), jnp.float32),
                                    jnp.zeros((3, 0), jnp.int32), k)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(rd))
    d2, oi = ops.pq_adc_masked(*_t(np.zeros((3, 4, 256), np.float32),
                                   np.zeros((3, 0, 4), np.uint8),
                                   np.zeros((3, 0), np.int32)), k=k)
    pd, pi = ref_ops.pq_adc_masked(jnp.zeros((3, 4, 256), jnp.float32),
                                   jnp.zeros((3, 0, 4), jnp.uint8),
                                   jnp.zeros((3, 0), jnp.int32), k=k,
                                   interpret=True)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(pd))


@pytest.mark.parametrize("qn,c,d,k,block", [(6, 300, 16, 10, 64),
                                            (4, 500, 8, 40, 128)])
def test_l2_tie_rule_on_exact_inputs(qn, c, d, k, block):
    # integer vectors: exact distances, many ties across Pallas blocks;
    # every row holds >= k candidates (multi-block short rows differ in
    # the Pallas kernel, ROADMAP queue 3)
    rng = np.random.default_rng(qn + c)
    q = rng.integers(-2, 3, (qn, d)).astype(np.float32)
    pools = rng.integers(-2, 3, (qn, c, d)).astype(np.float32)
    ids = _ragged_ids(rng, qn, c, min_len=k)
    d2, oi = ops.l2_topk_masked(*_t(q, pools, ids), k=k)
    for rd, ri in (ref.l2_topk_masked_ref(jnp.asarray(q), jnp.asarray(pools),
                                          jnp.asarray(ids), k),
                   ref_ops.l2_topk_masked(jnp.asarray(q), jnp.asarray(pools),
                                          jnp.asarray(ids), k=k,
                                          block_c=block, interpret=True)):
        np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(d2.numpy(), np.asarray(rd))


# (Q, N, d, k, Pallas block_n): N off the block, N == block, k = 1,
# k = 100 (make_dataset's k_gt)
UNMASKED_SHAPES = [(4, 96, 16, 5, 32), (9, 257, 32, 10, 128),
                   (6, 700, 24, 64, 256), (3, 50, 8, 1, 16),
                   (5, 512, 16, 100, 512)]


def _norm_atol(q, x):
    return 1e-5 * float((q * q).sum(1).max() + (x * x).sum(1).max())


@pytest.mark.parametrize("qn,n,d,k,block", UNMASKED_SHAPES)
def test_l2_topk_plain_matches_ref_and_pallas(qn, n, d, k, block):
    rng = np.random.default_rng(qn * n + k)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    d2, oi = ops.l2_topk(*_t(q, x), k=k)
    assert d2.dtype == torch.float32 and oi.dtype == torch.int32
    for rd, ri in (ref.l2_topk_ref(jnp.asarray(q), jnp.asarray(x), k),
                   ref_ops.l2_topk(jnp.asarray(q), jnp.asarray(x), k=k,
                                   block_n=block, interpret=True)):
        np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(d2.numpy(), np.asarray(rd), rtol=1e-5,
                                   atol=_norm_atol(q, x))


@pytest.mark.parametrize("qn,n,d,k,block", [(6, 300, 16, 10, 64),
                                            (4, 500, 8, 40, 128),
                                            (5, 3, 4, 8, 4)])
def test_l2_topk_tie_rule_and_sentinels_on_exact_inputs(qn, n, d, k, block):
    # integer vectors: exact distances, many ties across Pallas blocks;
    # N < k in the last case: the missing places are (3.4e38, -1)
    rng = np.random.default_rng(qn + n)
    q = rng.integers(-2, 3, (qn, d)).astype(np.float32)
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    d2, oi = ops.l2_topk(*_t(q, x), k=k)
    pd, pi = ref_ops.l2_topk(jnp.asarray(q), jnp.asarray(x), k=k,
                             block_n=block, interpret=True)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(pd))
    if n >= k:   # lax.top_k needs k <= N
        rd, ri = ref.l2_topk_ref(jnp.asarray(q), jnp.asarray(x), k)
        np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(d2.numpy(), np.asarray(rd))
    else:
        assert (oi.numpy()[:, n:] == -1).all()


@pytest.mark.parametrize("n,m,block,dtype", [(1, 8, 1024, np.uint8),
                                             (300, 8, 128, np.uint8),
                                             (1000, 16, 256, np.int32)])
def test_pq_adc_plain_matches_ref_and_pallas(n, m, block, dtype):
    rng = np.random.default_rng(n + m)
    lut = rng.random((m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(dtype)
    codes[0] = 255
    codes[-1, : m // 2] = 0
    d = ops.pq_adc(*_t(lut, codes))
    assert d.dtype == torch.float32 and d.shape == (n,)
    for want in (ref.pq_adc_ref(jnp.asarray(lut),
                                jnp.asarray(codes.astype(np.int32))),
                 ref_ops.pq_adc(jnp.asarray(lut), jnp.asarray(codes),
                                block_n=block, interpret=True)):
        np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-5)


def test_topk_l2_keeps_the_reference_return_order():
    from repro.core.distances import topk_l2 as ref_topk
    rng = np.random.default_rng(3)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    ids, d2 = topk_l2(*_t(q, x), 12)
    rids, rd2 = ref_topk(jnp.asarray(q), jnp.asarray(x), 12)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=1e-5,
                               atol=_norm_atol(q, x))


def test_ground_truth_ties_go_to_the_lower_id():
    # duplicate rows straddle the k-th place: of four copies at the same
    # distance two fit, and they must be the two lowest ids, as
    # jax.lax.top_k keeps them
    rng = np.random.default_rng(5)
    base = rng.standard_normal((400, 8)).astype(np.float32) + 10.0
    queries = rng.standard_normal((3, 8)).astype(np.float32)
    queries[1:] += 10.0                            # among the other rows
    near = queries[0] + 0.5
    base[[7, 50, 51, 300]] = near                  # d2 = 8 * 0.25 = 2.0
    base[[120, 9, 260]] = queries[0] + 0.25        # three closer rows
    k = 5
    ids, d2 = brute_force_knn(base, queries, k, device="cpu")
    assert ids.dtype == np.int32 and d2.dtype == np.float32
    np.testing.assert_array_equal(ids[0], [9, 120, 260, 7, 50])
    _, top_ids = jax.lax.top_k(-jnp.asarray(
        ((queries[:1, None, :] - base[None]) ** 2).sum(-1)), k)
    np.testing.assert_array_equal(ids[0], np.asarray(top_ids)[0])
    # the reference's ground truth agrees wherever no tie straddles k
    rids, rd2 = ref_knn(base, queries, k)
    np.testing.assert_array_equal(ids[1:], rids[1:])
    np.testing.assert_allclose(d2, rd2, rtol=1e-5, atol=1e-4)


# tests/test_kernels.py:143-148 as (b, h, kvh, sq, sk, d, bq, bk, causal),
# plus grouped-query heads and lengths off every tile
FLASH_SHAPES = [(1, 2, 2, 128, 128, 64, 64, 64, True),
                (2, 1, 1, 256, 256, 32, 128, 128, True),
                (1, 1, 1, 128, 256, 64, 64, 128, True),    # Sq != Sk
                (1, 2, 2, 128, 128, 64, 64, 64, False),
                (2, 8, 2, 64, 192, 32, 64, 64, True),      # GQA, group 4
                (1, 8, 1, 77, 77, 16, 128, 128, True),     # group 8, ragged
                (2, 4, 2, 50, 93, 128, 128, 128, False)]


def _flash_inputs(b, h, kvh, sq, sk, d, seed, dtype=np.float32):
    """numpy q [B, Sq, H, D], k, v [B, Sk, KVH, D]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, sk, kvh, d)).astype(dtype),
            rng.standard_normal((b, sk, kvh, d)).astype(dtype))


def _to_ref_layout(q, k, v):
    """The reference kernel's [B, H, S, D], each query head with its own
    copy of its KV head."""
    g = q.shape[2] // k.shape[2]
    return (jnp.asarray(q.transpose(0, 2, 1, 3)),
            jnp.asarray(np.repeat(k, g, axis=2).transpose(0, 2, 1, 3)),
            jnp.asarray(np.repeat(v, g, axis=2).transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,bq,bk,causal", FLASH_SHAPES)
def test_flash_plain_matches_ref_and_pallas(b, h, kvh, sq, sk, d, bq, bk,
                                            causal):
    q, k, v = _flash_inputs(b, h, kvh, sq, sk, d, seed=sq + sk + h)
    got = tref.flash_attention_plain(*_t(q, k, v), causal=causal).numpy()
    assert got.shape == q.shape
    rq, rk, rv = _to_ref_layout(q, k, v)
    for want in (ref.flash_attention_ref(rq, rk, rv, causal=causal),
                 ref_ops.flash_attention(rq, rk, rv, causal=causal,
                                         block_q=bq, block_k=bk,
                                         interpret=True)):
        np.testing.assert_allclose(
            got, np.asarray(want).transpose(0, 2, 1, 3), rtol=1e-5,
            atol=1e-5)
    # on the CPU the dispatcher takes the plain version
    np.testing.assert_array_equal(
        ops.flash_attention(*_t(q, k, v), causal=causal).numpy(), got)


def test_flash_plain_bf16_matches_ref_and_pallas():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _flash_inputs(1, 4, 2, 128, 128, 64, seed=9))
    got = tref.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    rq, rk, rv = (x.astype(jnp.bfloat16) for x in _to_ref_layout(
        *(t.float().numpy() for t in (q, k, v))))
    for want in (ref.flash_attention_ref(rq, rk, rv),
                 ref_ops.flash_attention(rq, rk, rv, block_q=64, block_k=64,
                                         interpret=True)):
        np.testing.assert_allclose(
            got.float().numpy(),
            np.asarray(want, np.float32).transpose(0, 2, 1, 3),
            rtol=2 ** -7, atol=2 ** -7)


def _flash_tiled_bf16(q, k, v, causal, tile=64, true_d=None):
    """The rounding of the bf16 tensor-core kernel
    (csrc/flash_attention.cu:flash_fwd_bf16) in plain torch: 64-key tiles,
    exact float32 products of the bf16 inputs, the scale 1/sqrt(D) * log2(e)
    applied to the float32 scores after the product, a float32 online
    softmax in base 2, P rounded to bf16 (the row sum l adds the rounded
    P), and acc / max(l, 1e-30) rounded once. ``true_d``: the head dim
    whose scale a padded launch takes (default: q's own)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scale_log2 = float(np.float32(np.float32(1.0 / np.sqrt(true_d or d))
                                  * np.float32(1.4426950408889634)))
    q_pos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full(qf.shape[:-1], -1e30)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, sk, tile):
        s = (qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2)) * scale_log2
        if causal:
            keys = torch.arange(k0, min(k0 + tile, sk))[None, :]
            s = s.masked_fill(keys > q_pos, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None]).bfloat16().float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vf[..., k0:k0 + tile, :]
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).bfloat16()


# (b, h, kvh, sq, sk, d, causal): ragged q and key tiles, Sk < 16, Sq = 1,
# Sq = 1 (mod 16), causal Sq < Sk, groups 1, 2, 4 and 8, D 16, 32, 64, 112
# and 128
FLASH_TILED_SHAPES = [(1, 4, 2, 77, 77, 16, True),
                      (1, 4, 1, 50, 93, 112, False),
                      (1, 4, 2, 77, 77, 64, True),
                      (2, 4, 1, 1, 131, 32, True),
                      (1, 2, 2, 9, 9, 64, True),
                      (1, 4, 4, 50, 93, 128, False),
                      (2, 8, 2, 65, 130, 64, True),
                      (1, 8, 8, 17, 200, 32, False),
                      (1, 8, 1, 40, 300, 128, True),
                      (1, 2, 1, 128, 128, 64, True)]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", FLASH_TILED_SHAPES)
def test_flash_bf16_kernel_rounding_holds_the_tolerance(b, h, kvh, sq, sk,
                                                        d, causal):
    """The bf16 kernel's own rounding stays within one bf16 step
    (chip_smoke.FLASH_BF16_TOL = 2^-7, abs and rel) of the plain version
    and of the Pallas kernel in interpret mode."""
    tol = 2 ** -7
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in
               _flash_inputs(b, h, kvh, sq, sk, d, seed=sq * sk + d))
    got = _flash_tiled_bf16(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    plain = fa.flash_attention_plain(q, k, v, causal)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)
    rq, rk, rv = (x.astype(jnp.bfloat16) for x in _to_ref_layout(
        *(t.float().numpy() for t in (q, k, v))))
    pallas = ref_ops.flash_attention(rq, rk, rv, causal=causal, block_q=sq,
                                     block_k=sk, interpret=True)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(pallas, np.float32).transpose(0, 2, 1, 3),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [1, 12, 16, 17, 48, 100, 112, 128])
def test_flash_head_width_pads_up_to_the_next_compiled_width(d):
    width = fa.head_width(d)
    assert width in fa.HEAD_DIMS and width >= d
    assert all(w < d for w in fa.HEAD_DIMS if w < width)


@pytest.mark.parametrize("d", [0, 129, 256])
def test_flash_head_width_refuses_0_and_above_the_widest(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.head_width(d)


# (b, h, kvh, sq, sk, d, causal): qwen1.5's REDUCED D = 12 (to 16), widths
# padded to 64 and 112, causal and full, ragged Sq < Sk
FLASH_PADDED_SHAPES = [(2, 5, 5, 40, 40, 12, True),
                       (1, 5, 5, 33, 70, 12, False),
                       (1, 4, 2, 65, 65, 48, True),
                       (1, 4, 2, 50, 93, 100, False)]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", FLASH_PADDED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_on_zero_padded_heads_equals_unpadded(b, h, kvh, sq, sk,
                                                          d, causal, dtype):
    """What the wrapper launches for a D it does not compile: q, k, v
    zero-padded to the next width, the true D's scale, the output's
    padding columns cut off — the same attention as at D itself (the zero
    columns add exact zeros to every score)."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in
               _flash_inputs(b, h, kvh, sq, sk, d, seed=sq + d))
    width = fa.head_width(d)
    qp, kp, vp = fa.pad_head_dim(q, k, v, width)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == width
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    got = fa.flash_attention_plain(qp, kp, vp, causal,
                                   scale=1.0 / d ** 0.5)[..., :d]
    want = fa.flash_attention_plain(q, k, v, causal)
    assert torch.equal(got, want)
    if dtype == torch.bfloat16:
        # the bf16 kernel's rounding on the padded launch holds the
        # one-step tolerance against the unpadded plain version
        tiled = _flash_tiled_bf16(qp, kp, vp, causal, true_d=d)[..., :d]
        np.testing.assert_allclose(tiled.float().numpy(),
                                   want.float().numpy(), rtol=2 ** -7,
                                   atol=2 ** -7)


# the (Q, N) of chip_smoke.check_unmasked_edges: every slice of the scan
# kernel's grid is a whole number of 128-row tiles but the last, non-empty,
# and together they cover [0, N) once
SPLIT_SHAPES = [(5, 7), (9, 1000), (33, 777), (40, 5000), (7, 3000),
                (20_000, 6250), (3, 200_000), (130, 1000), (257, 3001),
                (129, 129), (1, 50_000), (1, 129), (6, 4099),
                (4, 1_000_000), (6, 3000), (4, 100_000), (5, 2),
                (130, 300_000), (512, 1_000_000), (8192, 6250)]


@pytest.mark.parametrize("qn,n", SPLIT_SHAPES)
def test_split_rows_covers_every_row_once(qn, n):
    s, rows = l2_topk.split_rows(qn, n)
    assert s >= 1 and rows % l2_topk.TILE_N == 0
    seen = np.zeros(n, np.int64)
    for i in range(s):
        lo, hi = i * rows, min(n, (i + 1) * rows)
        assert lo < hi   # no empty slice
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # one wave of at most SCAN_BLOCKS blocks unless the query tiles alone
    # are more; no more slices than N / MIN_SPLIT_ROWS, so none is under
    # half of it
    q_tiles = -(-qn // l2_topk.TILE_Q)
    assert s == 1 or 2 * rows > l2_topk.MIN_SPLIT_ROWS
    assert q_tiles * s <= max(l2_topk.SCAN_BLOCKS, q_tiles)


def test_ref_module_names_the_plain_versions():
    assert tref.flash_attention_plain is fa.flash_attention_plain
    assert tref.l2_topk_masked_ref is l2_topk.l2_topk_masked_plain
    assert tref.pq_adc_masked_ref is pq_adc.pq_adc_masked_plain
    assert tref.l2_topk_ref is l2_topk.l2_topk_plain
    assert tref.pq_adc_ref is pq_adc.pq_adc_plain


def test_cuda_wrappers_refuse_cpu_tensors_without_launching():
    ops.reset_launch_counts()
    q, pools, ids = _t(*_l2_inputs(2, 8, 4, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        l2_topk.l2_topk_masked(q, pools, ids, 3)
    with pytest.raises(ValueError, match="CUDA"):
        l2_topk.l2_topk(q, pools[0], 3)
    luts, codes = _t(np.zeros((2, 4, 256), np.float32),
                     np.zeros((2, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc.pq_adc_masked(luts, codes, ids, 3)
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc.pq_adc(luts[0], codes[0])
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc.pq_adc_rows(luts, codes[0], torch.zeros(3, dtype=torch.int32),
                           torch.tensor([0, 1, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*_t(*_flash_inputs(1, 2, 1, 8, 8, 32, seed=0)))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0, "l2_topk": 0,
                                   "l2_topk_masked": 0, "pq_adc": 0,
                                   "pq_adc_rows": 0, "pq_adc_masked": 0}


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
