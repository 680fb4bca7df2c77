"""The port's graph phase against the reference on the same index.

The reference's ``built_pag`` is carried into the port with
``pag_from_arrays``. Float32 sums in XLA and in PyTorch agree bitwise on
only part of the entries, and a stable sort of near-equal distances can
then order them differently, so the parity rule is: ``path`` and
``n_hops`` identical for at least 95% of the queries, and for every query
that differs, the first differing hop has path distances within rtol 1e-5
of each other (the walk split at a near-tie).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.graph_search import greedy_search as ref_greedy  # noqa: E402
from repro.core.graph_search import robust_prune as ref_prune  # noqa: E402
from repro_torch.carry import pag_from_arrays  # noqa: E402
from repro_torch.core.graph_search import (  # noqa: E402
    greedy_search,
    robust_prune,
)

torch.set_num_threads(2)   # xdist runs several workers on the same cores


@pytest.fixture(scope="module")
def carried(built_pag):
    return pag_from_arrays(built_pag.arrays())


def _assert_paths_agree(ref_path, ref_pd, ref_hops, path, pd, hops):
    same = (ref_path == path).all(1) & (ref_hops == hops)
    assert same.mean() >= 0.95, same.mean()
    for qi in np.flatnonzero(~same):
        h = int(np.flatnonzero(ref_path[qi] != path[qi])[0])
        np.testing.assert_allclose(pd[qi, h], ref_pd[qi, h], rtol=1e-5)


@pytest.mark.parametrize("L", [16, 32])
def test_greedy_search_matches_reference(built_pag, carried, small_ds, L):
    A, nbrs, n_nodes, entry = built_pag.pg.device_arrays()
    ref = ref_greedy(A, nbrs, n_nodes, entry, jnp.asarray(small_ds.queries),
                     L=L, K=L)
    tA, tn, tnn, tentry = carried.pg.device_arrays("cpu")
    res = greedy_search(tA, tn, tnn, tentry,
                        torch.from_numpy(small_ds.queries), L=L, K=L)
    _assert_paths_agree(np.asarray(ref.path), np.asarray(ref.path_dists),
                        np.asarray(ref.n_hops), res.path.numpy(),
                        res.path_dists.numpy(), res.n_hops.numpy())
    same = (np.asarray(ref.path) == res.path.numpy()).all(1)
    np.testing.assert_array_equal(res.ids.numpy()[same],
                                  np.asarray(ref.ids)[same])
    # expanded-form distances: float32 cancellation against |q|^2 + |x|^2
    np.testing.assert_allclose(res.dists.numpy()[same],
                               np.asarray(ref.dists)[same], rtol=1e-4,
                               atol=1e-4)


def test_finished_queries_stay_frozen(carried, small_ds):
    # a query that converges early keeps its hop count and path padding
    # while the rest of the batch goes on
    tA, tn, tnn, tentry = carried.pg.device_arrays("cpu")
    q = torch.from_numpy(small_ds.queries)
    res = greedy_search(tA, tn, tnn, tentry, q, L=16, K=16)
    hops = res.n_hops.numpy()
    assert hops.min() < hops.max()
    m_cap = carried.pg.m_cap
    for qi in range(len(hops)):
        path = res.path.numpy()[qi]
        assert (path[:hops[qi]] < m_cap).all()
        assert (path[hops[qi]:] == m_cap).all()
    alone = greedy_search(tA, tn, tnn, tentry, q[:1], L=16, K=16)
    np.testing.assert_array_equal(alone.path.numpy()[0], res.path.numpy()[0])


def test_robust_prune_matches_reference(built_pag, carried, small_ds):
    # fixed candidate sets: each node's 40 nearest graph nodes, shuffled,
    # with duplicates and padding
    pg = built_pag.pg
    rng = np.random.default_rng(0)
    rows = rng.choice(pg.n_nodes, 64, replace=False)
    a = pg.A[:pg.n_nodes]
    d2 = ((a[rows][:, None, :] - a[None, :, :]) ** 2).sum(-1)
    cand = np.argsort(d2, axis=1)[:, 1:41].astype(np.int32)
    cand[:, -4:] = cand[:, :4]                   # duplicates
    cand[:, 30:33] = pg.m_cap                    # padding
    cand = np.take_along_axis(cand, rng.permuted(
        np.tile(np.arange(40), (64, 1)), axis=1), axis=1)
    cd = np.where(cand < pg.n_nodes, np.take_along_axis(
        d2, np.minimum(cand, pg.n_nodes - 1), axis=1),
        np.float32(3.4e38)).astype(np.float32)
    for alpha in (1.0, 1.44):
        ref = np.asarray(ref_prune(jnp.asarray(cand), jnp.asarray(cd),
                                   jnp.asarray(pg.A), jnp.int32(pg.n_nodes),
                                   jnp.float32(alpha), R=16))
        out = robust_prune(torch.from_numpy(cand), torch.from_numpy(cd),
                           torch.from_numpy(carried.pg.A), carried.pg.n_nodes,
                           alpha, R=16).numpy()
        same = (ref == out).all(1)
        assert same.mean() >= 0.95, same.mean()
