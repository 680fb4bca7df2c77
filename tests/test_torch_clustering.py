"""The port's k-means (``core/clustering.py``: kmeans++ draws, the
assignment, the balance penalty and the center update on the device)
against the reference's ``repro.core.clustering.kmeans`` on the same
seeded points: the same assignment, the centers within 1e-5 (f64 sums on
the device against numpy's f32 means). Its callers (SPANN, CIC, the PQ
codebooks) are held through their builds in ``test_torch_baselines.py``,
``test_torch_cic.py`` and ``test_torch_search.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import clustering as ref  # noqa: E402
from repro_torch.core import clustering  # noqa: E402

CENTER_ATOL = 1e-5
# (n, d, k, iters, balance_weight, seed): plain Lloyd; the SPANN and CIC
# balance weights; k near n (empty clusters re-seeded); chunks of points
CASES = {"plain": (600, 16, 12, 6, 0.0, 0),
         "balanced": (700, 8, 40, 8, 2.0, 1),
         "cic": (500, 12, 4, 4, 1.0, 2),
         "crowded": (64, 4, 48, 5, 0.0, 3),
         "chunked": (2100, 8, 9, 3, 2.0, 4)}


def _points(n, d, seed):
    rng = np.random.default_rng(100 + seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, 8, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kmeans_matches_the_reference(case, monkeypatch):
    n, d, k, iters, w, seed = CASES[case]
    if case == "chunked":   # several assignment chunks at this size
        monkeypatch.setattr(clustering, "ASSIGN_CHUNK", 512)
    x = _points(n, d, seed)
    want_c, want_a = ref.kmeans(x, k, iters=iters, seed=seed,
                                balance_weight=w)
    got_c, got_a = clustering.kmeans(x, k, iters=iters, seed=seed,
                                     balance_weight=w, device="cpu")
    assert got_c.dtype == np.float32 and got_a.dtype == np.int64
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=CENTER_ATOL)


def test_kmeanspp_draws_as_numpy_choice_does():
    """One ``rng.random()`` against the normalised cumulative sum is the
    index ``rng.choice(n, p=...)`` draws, and leaves the generator where
    ``choice`` leaves it."""
    rng = np.random.default_rng(7)
    p = rng.random(50).astype(np.float32)
    p /= p.sum()
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        want = a.choice(50, p=p)
        cdf = np.cumsum(p.astype(np.float64))
        got = np.searchsorted(cdf / cdf[-1], b.random(), side="right")
        assert got == want
    assert a.random() == b.random()
