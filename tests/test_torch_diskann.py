"""The port's DiskANN search as a lock-step traversal and a replay, against
the reference's per-query loop on one index: the reference's index
(graph, codes, centroids, storage objects) carried into the port, a "dfs"
store of one latency seed on each side.

* Every ``store.get`` of the two searches, as (key, latency), in order:
  the port's traversal reads objects through the store's value step and
  its replay charges them through ``get`` in the reference's order, so the
  two sequences, the store counters and the ``storage.*`` metrics are
  equal, and so are the returned ids, distances and latencies.
* One ADC call scores every query's entry point, then one call per wave,
  and a search has as many waves as its longest query has hops.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.baselines import diskann as ref_dk  # noqa: E402
from repro.data.vectors import make_dataset  # noqa: E402
from repro.obs import observe as ref_observe  # noqa: E402
from repro.obs.metrics import MetricsRegistry as RefMetrics  # noqa: E402
from repro.storage import simulator as ref_sim  # noqa: E402
from repro_torch.baselines import diskann  # noqa: E402
from repro_torch.baselines.pq import PQCodebook  # noqa: E402
from repro_torch.carry import store_from_objects  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import observe  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.storage.simulator import (  # noqa: E402
    FaultPlan,
    StorageConfig,
    TransientError,
)

torch.set_num_threads(2)   # xdist runs several workers on the same cores

K = 10
SEED = 5


@pytest.fixture(scope="module")
def index():
    """The reference's DiskANN on 800 x 16 uniform points (20 queries),
    and the same index carried into the port."""
    ds = make_dataset("uniform", n=800, d=16, n_queries=20, seed=2)
    store = ref_sim.ObjectStore(ref_sim.StorageConfig.preset("mem"))
    ridx = ref_dk.build_diskann(ds.base, store, R=16, L=32, M=8)
    idx = diskann.DiskANNIndex(
        codes=torch.from_numpy(ridx.codes),
        cb=PQCodebook(ridx.cb.centroids, ridx.cb.M, ridx.cb.d),
        entry=ridx.entry, n=ridx.n, d=ridx.d, R=ridx.R, build_stats={})
    return ds, ridx, idx, store._data


def _ref_store(kind, objects, seed=0):
    store = ref_sim.ObjectStore(ref_sim.StorageConfig.preset(kind, seed=seed))
    for key, obj in objects.items():
        store.put(key, obj)
    return store


def _recorded(store):
    """Wraps ``store.get`` so that every call appends (key, latency)."""
    seq = []
    get = store.get

    def recording(key, *args, **kw):
        value, lat = get(key, *args, **kw)
        seq.append((key, lat))
        return value, lat

    store.get = recording
    return seq


def _storage_metrics(snapshot):
    return {k: v for k, v in snapshot.items() if k.startswith("storage.")}


@pytest.mark.parametrize("L", [16, 32, 64])
@pytest.mark.parametrize("beam_io", [1, 4])
def test_store_gets_are_the_references_in_order(index, L, beam_io):
    ds, ridx, idx, objects = index
    ref_store = _ref_store("dfs", objects, seed=SEED)
    store = store_from_objects(objects, StorageConfig.preset("dfs",
                                                             seed=SEED))
    ref_seq, seq = _recorded(ref_store), _recorded(store)
    ref_metrics, metrics = RefMetrics(), MetricsRegistry()
    with ref_observe(metrics=ref_metrics):
        rids, rd2, rlats = ref_dk.search_diskann(
            ridx, ds.queries, ref_store, k=K, L=L, beam_io=beam_io)
    with observe(metrics=metrics):
        ids, d2, lats = diskann.search_diskann(
            idx, ds.queries, store, k=K, L=L, beam_io=beam_io)
    assert len(seq) > len(ds.queries)
    assert seq == ref_seq
    assert (store.n_gets, store.bytes_fetched) == \
        (ref_store.n_gets, ref_store.bytes_fetched)
    assert _storage_metrics(metrics.snapshot()) == \
        _storage_metrics(ref_metrics.snapshot())
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(d2, rd2)
    assert lats == rlats


class _HopCounter(ref_sim.ComputeModel):
    """The reference's compute model, counting each query's hops: one
    full-precision rerank charge (``scan`` at the vectors' width) a hop,
    after the LUT charge that opens each query."""

    def __init__(self, d):
        super().__init__()
        self.d, self.hops = d, []

    def scan(self, n_points, d):
        if n_points == 256 and d != self.d:   # the LUT build: a new query
            self.hops.append(0)
        elif d == self.d:
            self.hops[-1] += 1
        return super().scan(n_points, d)


@pytest.mark.parametrize("L,beam_io", [(16, 4), (64, 1)])
def test_one_adc_call_for_the_entry_points_then_one_per_wave(
        index, monkeypatch, L, beam_io):
    ds, ridx, idx, objects = index
    counter = _HopCounter(ridx.d)
    ref_dk.search_diskann(ridx, ds.queries, _ref_store("mem", objects), k=K,
                          L=L, beam_io=beam_io, compute=counter)
    assert len(counter.hops) == len(ds.queries)
    calls = []
    orig = ops.pq_adc_rows

    def counted(luts, table, rows, offsets):
        calls.append((luts.shape[0], rows.shape[0]))
        return orig(luts, table, rows, offsets)

    monkeypatch.setattr(ops, "pq_adc_rows", counted)
    store = store_from_objects(objects, StorageConfig.preset("mem"))
    diskann.search_diskann(idx, ds.queries, store, k=K, L=L,
                           beam_io=beam_io)
    assert len(calls) == 1 + max(counter.hops)
    # the first call scores one entry point per query
    assert calls[0] == (len(ds.queries), len(ds.queries))
    assert sum(t for _, t in calls[1:]) > 0


def test_a_fault_in_the_traversal_raises_the_references_error(index):
    ds, ridx, idx, objects = index
    plan = dict(transient_p=0.05, seed=1)
    ref_store = _ref_store("dfs", objects)
    ref_store.set_fault_plan(ref_sim.FaultPlan(**plan))
    store = store_from_objects(objects, StorageConfig.preset("dfs"))
    store.set_fault_plan(FaultPlan(**plan))
    with pytest.raises(ref_sim.TransientError):
        ref_dk.search_diskann(ridx, ds.queries, ref_store, k=K, L=32)
    with pytest.raises(TransientError):
        diskann.search_diskann(idx, ds.queries, store, k=K, L=32)
    # the traversal drew no latency and counted no fetch before it raised
    assert store.n_gets == 0
