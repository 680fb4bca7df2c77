"""``search_pag`` of the port against the reference on the same index and
objects, float and PQ planes (the serving tier on top of it is in
tests/test_torch_serving.py).

The reference's ``built_pag`` is carried with ``pag_from_arrays`` and its
objects (float residuals, PQ codes, codebook) with
``store_from_objects(ref_store._data, ...)`` under the "mem" preset.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.search import SearchConfig as RefConfig  # noqa: E402
from repro.core.search import search_pag as ref_search  # noqa: E402
from repro.core.search import write_partitions as ref_write  # noqa: E402
from repro.data.vectors import recall_at_k  # noqa: E402
from repro.dataplane.plan import (  # noqa: E402
    probe_orders as ref_probe_orders,
)
from repro.storage.simulator import ObjectStore as RefStore  # noqa: E402
from repro.storage.simulator import (  # noqa: E402
    StorageConfig as RefStorageConfig,
)
from repro_torch.carry import (  # noqa: E402
    pag_from_arrays,
    store_from_objects,
)
from repro_torch.core.search import SearchConfig, search_pag  # noqa: E402
from repro_torch.storage.simulator import StorageConfig  # noqa: E402

torch.set_num_threads(2)   # xdist runs several workers on the same cores

CFG = dict(L=32, k=10, n_probe_max=16)


@pytest.fixture(scope="module")
def ref_pq_store(built_pag, small_ds):
    store = RefStore(RefStorageConfig.preset("mem"))
    ref_write(built_pag, small_ds.base, store, n_shards=4, compression="pq")
    return store


@pytest.fixture(scope="module")
def carried(built_pag):
    return pag_from_arrays(built_pag.arrays())


def _port_store(ref_store):
    return store_from_objects(ref_store._data, StorageConfig.preset("mem"))


def _port_probes(pag, queries, cfg):
    from repro_torch.dataplane.prefetch import predict_probes
    return predict_probes(pag, queries, cfg, device="cpu")


@pytest.mark.parametrize("compression", ["none", "pq"])
def test_search_matches_reference(built_pag, carried, ref_pq_store, small_ds,
                                  compression):
    q = small_ds.queries
    ref_ids, ref_d2, ref_st = ref_search(
        built_pag, small_ds.d, q, ref_pq_store,
        RefConfig(**CFG, compression=compression), n_shards=4)
    cfg = SearchConfig(**CFG, compression=compression)
    ids, d2, st = search_pag(carried, small_ds.d, q, _port_store(ref_pq_store),
                             cfg, n_shards=4, device="cpu")
    assert ids.shape == ref_ids.shape and ids.dtype == np.int64
    r_ref = recall_at_k(ref_ids, small_ds.gt_ids, 10)
    assert abs(recall_at_k(ids, small_ds.gt_ids, 10) - r_ref) <= 0.01

    # equal probe lists -> equal ids, up to distance ties
    from repro.core.graph_search import greedy_search
    import jax.numpy as jnp
    A, nbrs, n_nodes, entry = built_pag.pg.device_arrays()
    res = greedy_search(A, nbrs, n_nodes, entry, jnp.asarray(q), L=32, K=32)
    ref_probes = ref_probe_orders(built_pag, np.asarray(res.path),
                                  np.asarray(res.path_dists),
                                  np.asarray(res.n_hops), cfg.rho,
                                  cfg.n_probe_max)
    probes = _port_probes(carried, q, cfg)
    same = np.array([a == b for a, b in zip(ref_probes, probes)])
    assert same.mean() >= 0.95
    for qi in np.flatnonzero(same):
        diff = ids[qi] != ref_ids[qi]
        np.testing.assert_allclose(d2[qi], ref_d2[qi], rtol=1e-4, atol=1e-4)
        if diff.any():  # only near-equal distances may swap places
            np.testing.assert_allclose(d2[qi][diff], ref_d2[qi][diff],
                                       rtol=1e-5)
    if same.all():  # one shared storage simulator -> one event clock
        assert st.n_distinct_fetches == ref_st.n_distinct_fetches
        np.testing.assert_allclose(st.latencies_s, ref_st.latencies_s)
        assert st.batch_span_s == pytest.approx(ref_st.batch_span_s)


def test_per_query_engine_gives_the_batched_answers(carried, ref_pq_store,
                                                    small_ds):
    q = small_ds.queries[:40]
    out = [search_pag(carried, small_ds.d, q, _port_store(ref_pq_store),
                      SearchConfig(**CFG, engine=engine, compression="pq"),
                      n_shards=4, device="cpu")[:2]
           for engine in ("batched", "per_query")]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
