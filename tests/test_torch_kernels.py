"""The port's kernels, as their plain PyTorch versions run on the CPU,
against the reference's oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode, on the same numpy inputs.

d2 is held to rtol=atol=1e-4 (float32 sums in another order, as in
tests/test_kernels.py); id sets must match. On integer-valued inputs every
sum is exact, so ids must match position by position: that checks the
tie rule (lower pool position first). The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
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


def test_ref_module_names_the_plain_versions():
    assert tref.l2_topk_masked_ref is l2_topk.l2_topk_masked_plain
    assert tref.pq_adc_masked_ref is pq_adc.pq_adc_masked_plain


def test_cuda_wrappers_refuse_cpu_tensors_without_launching():
    ops.reset_launch_counts()
    q, pools, ids = _t(*_l2_inputs(2, 8, 4, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        l2_topk.l2_topk_masked(q, pools, ids, 3)
    luts, codes = _t(np.zeros((2, 4, 256), np.float32),
                     np.zeros((2, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc.pq_adc_masked(luts, codes, ids, 3)
    assert ops.launch_counts() == {"l2_topk_masked": 0, "pq_adc_masked": 0}


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
