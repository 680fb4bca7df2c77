"""The reduce-scatter's sum (``core/distributed.py:slice_sum``) against the
sum it replaced.

``_reduce_scatter`` gathers every rank's gradient and keeps this rank's
block of their sum. It used to move the whole gathered ``[n, ...]`` tensor
to the rank's device and add the block of each part there; ``slice_sum``
moves only each part's block, one at a time, and adds them in the same
rank order. The results must be the same bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distributed import slice_sum  # noqa: E402

SHAPE = (4, 8, 12)


def _whole_gather_sum(parts, dim, start, size):
    """The sum as it was: the block of each part of the whole gather,
    added in rank order."""
    acc = parts[0].narrow(dim, start, size)
    for part in parts[1:]:
        acc = acc + part.narrow(dim, start, size)
    return acc


@pytest.mark.parametrize("dim", range(len(SHAPE)))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slice_sum_is_the_whole_gathers_sum_bit_for_bit(dtype, n, dim):
    rng = np.random.default_rng(n * 10 + dim)
    # magnitudes spread over six decades, so that every addition rounds
    x = rng.standard_normal((n, *SHAPE)) * 10.0 ** rng.integers(
        -3, 3, (n, *SHAPE))
    parts = torch.from_numpy(x.astype(np.float32)).to(dtype)
    size = SHAPE[dim] // n
    for rank in range(n):
        want = _whole_gather_sum(parts, dim, rank * size, size)
        got = slice_sum(parts, dim, rank * size, size, "cpu")
        assert got.dtype == dtype and got.shape == want.shape
        assert got.is_contiguous()
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.contiguous().view(
                               torch.int16 if dtype == torch.bfloat16
                               else torch.int32))


def test_slice_sum_leaves_the_parts_alone():
    parts = torch.arange(2 * 4 * 6, dtype=torch.float32).view(2, 4, 6)
    before = parts.clone()
    slice_sum(parts, 1, 0, 2, "cpu")
    assert torch.equal(parts, before)
