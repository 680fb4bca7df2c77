"""The port's comparison baselines (DiskANN, HNSW, SPANN) and ``exact_pg``
against the reference, on one small dataset made here from a seed
(1,500 x 16 uniform, 30 queries) and fed to both packages as the same
numpy arrays.

Two kinds of check:
* one index, two searches: the reference's index carried into the port
  (same graph, codes, centroids, storage objects, storage seed), so the
  searches must agree query by query — ids and simulated latencies on at
  least 95% of the queries (float32 near-ties may reorder a candidate
  list; the store's latency stream then shifts for the rest);
* two builds: each package builds its own index, and the port's recall@10
  must lie within 0.01 of the reference's, with the structure (level
  sizes, partition count, replication) held as each test states.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.baselines import diskann as ref_dk  # noqa: E402
from repro.baselines import hnsw as ref_hn  # noqa: E402
from repro.baselines import spann as ref_sp  # noqa: E402
from repro.core.build import exact_pg as ref_exact_pg  # noqa: E402
from repro.data.vectors import make_dataset, recall_at_k  # noqa: E402
from repro.storage.simulator import ObjectStore as RefStore  # noqa: E402
from repro.storage.simulator import StorageConfig as RefConfig  # noqa: E402
from repro_torch.baselines import diskann, hnsw, spann  # noqa: E402
from repro_torch.baselines.pq import PQCodebook  # noqa: E402
from repro_torch.carry import store_from_objects  # noqa: E402
from repro_torch.core.build import PG, exact_pg  # noqa: E402
from repro_torch.storage.simulator import (  # noqa: E402
    ObjectStore,
    StorageConfig,
)

torch.set_num_threads(2)   # xdist runs several workers on the same cores

K = 10
SAME_QUERIES = 0.95     # share of queries whose ids / latencies must agree
RECALL_GAP = 0.01       # own builds: |recall(port) - recall(reference)|


@pytest.fixture(scope="module")
def ds():
    return make_dataset("uniform", n=1500, d=16, n_queries=30, k_gt=20,
                        seed=1)


def _recall(ids, ds):
    return recall_at_k(np.asarray(ids), ds.gt_ids, K)


def _same_rows(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).all(axis=1).mean())


def _port_pg(pg) -> PG:
    return PG(A=np.array(pg.A), nbrs=np.array(pg.nbrs), n_nodes=pg.n_nodes,
              entry=pg.entry, R_prune=pg.R_prune)


def _dfs_pair(objects):
    """A reference and a port store holding the same objects, with the
    same latency seed."""
    ref = RefStore(RefConfig.preset("dfs", seed=3))
    for key, obj in objects.items():
        ref.put(key, obj)
    return ref, store_from_objects(objects, StorageConfig.preset("dfs",
                                                                 seed=3))


@pytest.fixture(scope="module")
def ref_diskann(ds):
    store = RefStore(RefConfig.preset("mem"))
    return ref_dk.build_diskann(ds.base, store, R=16, L=32, M=8), store


def test_diskann_search_matches_reference_on_one_index(ref_diskann, ds):
    ridx, rstore = ref_diskann
    idx = diskann.DiskANNIndex(
        codes=torch.from_numpy(ridx.codes),
        cb=PQCodebook(ridx.cb.centroids, ridx.cb.M, ridx.cb.d),
        entry=ridx.entry, n=ridx.n, d=ridx.d, R=ridx.R, build_stats={})
    ref_store, store = _dfs_pair(rstore._data)
    rids, rd2, rlats = ref_dk.search_diskann(ridx, ds.queries, ref_store,
                                             k=K, L=32)
    ids, d2, lats = diskann.search_diskann(idx, ds.queries, store, k=K,
                                           L=32)
    assert _same_rows(ids, rids) >= SAME_QUERIES
    assert np.mean(np.asarray(lats) == np.asarray(rlats)) >= SAME_QUERIES
    same = (ids == rids).all(axis=1)
    np.testing.assert_array_equal(d2[same], rd2[same])   # host numpy sums
    assert store.n_gets == ref_store.n_gets


def test_diskann_own_build_recall_matches_reference(ref_diskann, ds):
    ridx, rstore = ref_diskann
    store = ObjectStore(StorageConfig.preset("mem"))
    idx = diskann.build_diskann(ds.base, store, R=16, L=32, M=8,
                                device="cpu")
    assert idx.codes.dtype == torch.uint8 and idx.codes.shape == (1500, 8)
    assert len(store.keys()) == len(rstore.keys()) == 1500
    assert set(idx.build_stats) == set(ridx.build_stats)
    rids, _, _ = ref_dk.search_diskann(ridx, ds.queries, rstore, k=K, L=32)
    ids, _, _ = diskann.search_diskann(idx, ds.queries, store, k=K, L=32)
    assert abs(_recall(ids, ds) - _recall(rids, ds)) <= RECALL_GAP


def test_hnsw_levels_and_recall_match_reference(ds):
    ridx = ref_hn.build_hnsw(ds.base, R=16, L=32)
    idx = hnsw.build_hnsw(ds.base, R=16, L=32, device="cpu")
    # level sampling is the reference's numpy: the same subsets exactly
    assert [len(i) for i in idx.level_ids] == \
        [len(i) for i in ridx.level_ids]
    for a, b in zip(idx.level_ids, ridx.level_ids):
        np.testing.assert_array_equal(a, b)
    rids, _, _ = ref_hn.search_hnsw(ridx, ds.queries, k=K, L=64)
    ids, _, lats = hnsw.search_hnsw(idx, ds.queries, k=K, L=64)
    assert abs(_recall(ids, ds) - _recall(rids, ds)) <= RECALL_GAP
    # one index, two searches: the reference's levels in the port
    carried = hnsw.HNSWIndex(levels=[_port_pg(pg) for pg in ridx.levels],
                             level_ids=ridx.level_ids, n=ridx.n, d=ridx.d,
                             build_stats={}, device=torch.device("cpu"))
    rids, _, rlats = ref_hn.search_hnsw(ridx, ds.queries, k=K, L=32)
    ids, _, lats = hnsw.search_hnsw(carried, ds.queries, k=K, L=32)
    assert _same_rows(ids, rids) >= SAME_QUERIES
    assert np.mean(np.asarray(lats) == np.asarray(rlats)) >= SAME_QUERIES


def test_spann_build_and_search_match_reference(ds):
    rstore = RefStore(RefConfig.preset("mem"))
    ridx = ref_sp.build_spann(ds.base, rstore, points_per_part=16)
    store = ObjectStore(StorageConfig.preset("mem"))
    idx = spann.build_spann(ds.base, store, points_per_part=16,
                            device="cpu")
    rs, s = ridx.build_stats, idx.build_stats
    assert set(s) == set(rs)
    assert s["n_parts"] == rs["n_parts"]
    assert abs(s["replication"] - rs["replication"]) \
        <= 0.01 * rs["replication"]
    rids, _, _ = ref_sp.search_spann(ridx, ds.queries, rstore, k=K, L=32,
                                     n_probe_max=32)
    ids, _, _ = spann.search_spann(idx, ds.queries, store, k=K, L=32,
                                   n_probe_max=32)
    assert abs(_recall(ids, ds) - _recall(rids, ds)) <= RECALL_GAP
    # one index, two searches
    carried = spann.SPANNIndex(
        centroids=ridx.centroids, pg=_port_pg(ridx.pg), counts=ridx.counts,
        n=ridx.n, d=ridx.d, build_stats={}, device=torch.device("cpu"))
    ref_store, store = _dfs_pair(rstore._data)
    rids, rd2, rlats = ref_sp.search_spann(ridx, ds.queries, ref_store,
                                           k=K, L=32, n_probe_max=16)
    ids, d2, lats = spann.search_spann(carried, ds.queries, store, k=K,
                                       L=32, n_probe_max=16)
    assert _same_rows(ids, rids) >= SAME_QUERIES
    assert np.mean(np.asarray(lats) == np.asarray(rlats)) >= SAME_QUERIES


def test_spann_closure_assignment_is_the_reference_matrix_rule(ds):
    # the 8 nearest centroids by topk_l2 equal the reference's full
    # cdist2 + argsort[:, :8] except where float32 near-ties (rtol 1e-5)
    # reorder them
    from repro.core.distances import cdist2
    from repro_torch.core.distances import topk_l2
    rng = np.random.default_rng(2)
    centers = ds.base[rng.choice(ds.n, 93, replace=False)]
    d2 = np.asarray(cdist2(jnp.asarray(ds.base), jnp.asarray(centers)))
    ref_order = np.argsort(d2, axis=1, kind="stable")[:, :8]
    ids, dd = topk_l2(torch.from_numpy(ds.base), torch.from_numpy(centers),
                      8)
    ids = ids.numpy()
    differ = ids != ref_order
    ref_d = np.take_along_axis(d2, ref_order, axis=1)
    np.testing.assert_allclose(dd.numpy(), ref_d, rtol=1e-5, atol=1e-4)
    assert np.allclose(np.take_along_axis(d2, ids, axis=1)[differ],
                       ref_d[differ], rtol=1e-5)
    assert differ.any(axis=1).mean() <= 0.01


def test_exact_pg_matches_reference(ds):
    # neighbour lists equal except at float32 near-ties (rtol 1e-5 on the
    # two candidates' distances)
    x = ds.base[:400]
    rpg = ref_exact_pg(x, R=16)
    pg = exact_pg(x, R=16, device="cpu")
    assert pg.entry == rpg.entry and pg.nbrs.shape == rpg.nbrs.shape
    np.testing.assert_array_equal(pg.A, rpg.A)
    differ = pg.nbrs != rpg.nbrs
    rows = np.where(differ)[0]
    d_port = ((x[pg.nbrs[differ]] - x[rows]) ** 2).sum(1)
    d_ref = ((x[rpg.nbrs[differ]] - x[rows]) ** 2).sum(1)
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-5)
    assert differ.any(axis=1).mean() <= 0.05
    # short rows pad with m, as the reference's sentinel
    small = exact_pg(x[:5], R=8, device="cpu")
    assert (small.nbrs[:, 4:] == 5).all() and (small.nbrs[:, :4] < 5).all()
