"""The ragged ADC of the port's DiskANN waves, ``pq_adc_rows`` (its plain
version on the CPU), against the reference's ADC oracle
``repro.kernels.ref.pq_adc_ref`` and its Pallas ``pq_adc`` kernel in
interpret mode, segment by segment: each query's LUT against the table
rows of its own node ids. rtol 1e-5, as in
``tests/test_torch_kernels.py::test_pq_adc_plain_matches_ref_and_pallas``
(M terms summed in another order). The plain version sums in the order
m = 0 .. M-1 as the single-LUT ``pq_adc_plain`` does, so the two agree
bit for bit; the CUDA kernel is held to it on the card by
``chip_smoke.py``. Also the batched LUTs DiskANN builds, against each
query's own ``adc_lut``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.baselines.pq import adc_lut as ref_adc_lut  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.baselines.pq import (  # noqa: E402
    PQCodebook,
    adc_distances_rows,
    adc_lut,
    adc_luts,
)
from repro_torch.kernels import ops, pq_adc  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

N_TABLE = 500


def _wave(q, lens, m, seed):
    """luts [Q, M, 256] f32, table [N_TABLE, M] u8, rows [T] i32 with ids
    0 and N_TABLE-1 among them, offsets [Q + 1] i32."""
    rng = np.random.default_rng(seed)
    luts = rng.random((q, m, 256)).astype(np.float32)
    table = rng.integers(0, 256, (N_TABLE, m)).astype(np.uint8)
    table[0] = 255
    table[-1] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rows = rng.integers(0, N_TABLE, int(offsets[-1])).astype(np.int32)
    if len(rows):
        rows[0], rows[-1] = 0, N_TABLE - 1
    return luts, table, rows, offsets


# (Q, segment lengths, M): empty segments, Q = 1, M in {1, 8, 16, 64}
CASES = [(1, [7], 8), (1, [0], 8), (4, [3, 0, 50, 1], 8),
         (5, [0, 0, 9, 0, 0], 1), (3, [20, 0, 33], 16), (2, [17, 40], 64),
         (6, [5, 6, 0, 7, 8, 64], 8)]


@pytest.mark.parametrize("q,lens,m", CASES)
def test_pq_adc_rows_plain_matches_ref_and_pallas_per_segment(q, lens, m):
    luts, table, rows, offsets = _wave(q, lens, m, seed=q * 100 + m)
    d = ops.pq_adc_rows(*(torch.from_numpy(a) for a in
                          (luts, table, rows, offsets))).numpy()
    assert d.dtype == np.float32 and d.shape == (len(rows),)
    for qi in range(q):
        lo, hi = offsets[qi], offsets[qi + 1]
        if lo == hi:
            continue
        codes = table[rows[lo:hi]]
        for want in (ref.pq_adc_ref(jnp.asarray(luts[qi]),
                                    jnp.asarray(codes.astype(np.int32))),
                     ref_ops.pq_adc(jnp.asarray(luts[qi]),
                                    jnp.asarray(codes), block_n=128,
                                    interpret=True)):
            np.testing.assert_allclose(d[lo:hi], np.asarray(want),
                                       rtol=1e-5)
        # the single-LUT plain version: the same sums bit for bit
        np.testing.assert_array_equal(
            d[lo:hi], pq_adc.pq_adc_plain(torch.from_numpy(luts[qi]),
                                          torch.from_numpy(codes)).numpy())


def test_adc_distances_rows_packs_host_ids_into_one_call(monkeypatch):
    luts, table, rows, offsets = _wave(4, [3, 0, 50, 1], 8, seed=1)
    calls = []
    orig = ops.pq_adc_rows

    def counted(*args):
        calls.append([a.shape for a in args])
        return orig(*args)

    monkeypatch.setattr(ops, "pq_adc_rows", counted)
    d = adc_distances_rows(torch.from_numpy(luts), torch.from_numpy(table),
                           rows.astype(np.int64), offsets.astype(np.int64))
    assert len(calls) == 1
    want = pq_adc.pq_adc_rows_plain(*(torch.from_numpy(a) for a in
                                      (luts, table, rows, offsets)))
    assert torch.equal(d, want)
    # no rows at all: an empty result
    empty = adc_distances_rows(torch.from_numpy(luts),
                               torch.from_numpy(table),
                               np.zeros(0, np.int64), np.zeros(5, np.int64))
    assert empty.shape == (0,)


@pytest.mark.parametrize("d,m", [(16, 8), (128, 8), (32, 16)])
def test_adc_luts_is_adc_lut_of_each_query_bit_for_bit(d, m):
    """DiskANN builds every query's LUT in one op; it must equal the
    per-query ``adc_lut`` bit for bit (a flipped low bit moves a near-tie
    and the traversal), and the reference's ``adc_lut`` to rtol 1e-6."""
    rng = np.random.default_rng(d + m)
    cb = PQCodebook(rng.standard_normal((m, 256, d // m)).astype(np.float32),
                    m, d)
    q = rng.standard_normal((9, d)).astype(np.float32)
    luts = adc_luts(cb, torch.from_numpy(q))
    assert luts.shape == (9, m, 256) and luts.dtype == torch.float32
    for i in range(len(q)):
        assert torch.equal(luts[i], adc_lut(cb, torch.from_numpy(q[i])))
        np.testing.assert_allclose(luts[i].numpy(), ref_adc_lut(cb, q[i]),
                                   rtol=1e-6)
