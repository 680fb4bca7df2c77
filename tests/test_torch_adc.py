"""The port's ``pq_adc_masked``, as its plain PyTorch version runs on the
CPU, against the reference's oracle and its Pallas kernel in interpret
mode, on the same numpy inputs (tolerances and the tie check as in
tests/test_torch_kernels.py; the CUDA kernel is held against this plain
version on the card by ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

# tests/test_kernels.py:91-95, plus k=200 (one Pallas block)
ADC_SHAPES = [(4, 96, 8, 5, 32), (7, 257, 4, 10, 128), (5, 40, 16, 64, 64),
              (5, 300, 8, 200, 512)]


def _ragged_ids(rng, qn, c, min_len=0):
    ids = rng.permutation(1 << 20)[:c].astype(np.int32)
    lens = np.linspace(min_len, c, qn).astype(int)
    return np.where(np.arange(c)[None, :] < lens[:, None], ids[None, :],
                    -1).astype(np.int32)


def _same_sets(a, b):
    for x, y in zip(np.asarray(a), np.asarray(b)):
        assert set(x.tolist()) == set(y.tolist())


def _adc_inputs(qn, c, m, seed):
    rng = np.random.default_rng(seed)
    luts = rng.random((qn, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (qn, c, m), dtype=np.uint8)
    return luts, codes, _ragged_ids(rng, qn, c)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("qn,c,m,k,block", ADC_SHAPES)
def test_adc_plain_matches_ref_and_pallas(qn, c, m, k, block):
    luts, codes, ids = _adc_inputs(qn, c, m, seed=qn * c)
    d2, oi = ops.pq_adc_masked(*_t(luts, codes, ids), k=k)
    for rd, ri in (ref.pq_adc_masked_ref(jnp.asarray(luts),
                                         jnp.asarray(codes),
                                         jnp.asarray(ids), k),
                   ref_ops.pq_adc_masked(jnp.asarray(luts),
                                         jnp.asarray(codes),
                                         jnp.asarray(ids), k=k,
                                         block_c=block, interpret=True)):
        np.testing.assert_allclose(d2.numpy(), np.asarray(rd), rtol=1e-4,
                                   atol=1e-4)
        _same_sets(oi, ri)


@pytest.mark.parametrize("qn,c,m,k,block", [(6, 300, 8, 10, 64),
                                            (4, 600, 4, 32, 256)])
def test_adc_tie_rule_on_exact_inputs(qn, c, m, k, block):
    rng = np.random.default_rng(qn + c)
    luts = rng.integers(0, 4, (qn, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (qn, c, m), dtype=np.uint8)
    ids = _ragged_ids(rng, qn, c, min_len=k)
    d2, oi = ops.pq_adc_masked(*_t(luts, codes, ids), k=k)
    for rd, ri in (ref.pq_adc_masked_ref(jnp.asarray(luts),
                                         jnp.asarray(codes),
                                         jnp.asarray(ids), k),
                   ref_ops.pq_adc_masked(jnp.asarray(luts),
                                         jnp.asarray(codes),
                                         jnp.asarray(ids), k=k,
                                         block_c=block, interpret=True)):
        np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(d2.numpy(), np.asarray(rd))
