"""The port's serving tier (``ShardedServing``, ``AnnsFrontend``) gives the
answers of a direct ``search_pag``, with and without prefetch-ahead, on a
small index the port builds itself (CPU, plain kernel versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distributed import ShardedServing  # noqa: E402
from repro_torch.core.pag import build_pag  # noqa: E402
from repro_torch.core.search import SearchConfig, search_pag  # noqa: E402
from repro_torch.core.search import write_partitions  # noqa: E402
from repro_torch.data.vectors import make_dataset  # noqa: E402
from repro_torch.serving.engine import AnnsFrontend  # noqa: E402
from repro_torch.storage.simulator import (  # noqa: E402
    ObjectStore,
    StorageConfig,
)

torch.set_num_threads(2)   # xdist runs several workers on the same cores

CFG = SearchConfig(L=24, k=10, n_probe_max=8, compression="pq")


@pytest.fixture(scope="module")
def index():
    ds = make_dataset("clustered", n=3000, d=16, n_queries=48, k_gt=10,
                      seed=3, device="cpu")
    pag = build_pag(ds.base, p=0.2, lam=3.0, redundancy=2, seed=0,
                    device="cpu")
    store = ObjectStore(StorageConfig.preset("dfs", seed=1))
    write_partitions(pag, ds.base, store, n_shards=4, compression="pq",
                     pq_m=4, device="cpu")
    return ds, pag, store


def _serving(index):
    ds, pag, store = index
    return ShardedServing(pag=pag, store=store, n_shards=4, dim=ds.d,
                          device="cpu")


def test_sharded_serving_and_frontend_give_search_answers(index):
    ds, pag, store = index
    ids, d2, _ = search_pag(pag, ds.d, ds.queries, store, CFG, n_shards=4,
                            device="cpu")
    s_ids, s_d2, _ = _serving(index).search(ds.queries, CFG)
    np.testing.assert_array_equal(s_ids, ids)
    np.testing.assert_array_equal(s_d2, d2)
    frontend = AnnsFrontend(_serving(index), CFG, max_batch=16)
    tickets = [frontend.submit(row) for row in ds.queries]
    results = frontend.flush()
    np.testing.assert_array_equal(
        np.stack([results[t][0] for t in tickets]), ids)
    np.testing.assert_array_equal(
        np.stack([results[t][1] for t in tickets]), d2)
    assert frontend.clock_s > 0 and len(frontend.degraded) == len(tickets)


def test_prefetch_pipeline_gives_the_same_answers(index):
    ds = index[0]
    runs = []
    for prefetch in (False, True):
        fe = AnnsFrontend(_serving(index), CFG, max_batch=16,
                          prefetch=prefetch, auto_flush=False)
        tickets = [fe.submit(row) for row in ds.queries]
        res = fe.flush()
        runs.append((np.stack([res[t][0] for t in tickets]),
                     fe.n_prefetch_hits))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == 0 and runs[1][1] > 0


def test_dead_shard_degrades_without_crashing(index):
    ds = index[0]
    serving = _serving(index)
    serving.kill_shard(1)
    try:
        ids, _, st = serving.search(ds.queries, CFG)
    finally:
        serving.revive()
    assert ids.shape == (len(ds.queries), 10)
    assert st.n_degraded_queries() > 0


def test_tracing_and_metrics_change_no_answer(index):
    from repro_torch.obs import MetricsRegistry, Tracer, observe
    ds, pag, store = index
    plain = search_pag(pag, ds.d, ds.queries, store, CFG, n_shards=4,
                       device="cpu")
    tracer, metrics = Tracer(), MetricsRegistry()
    with observe(tracer=tracer, metrics=metrics):
        traced = search_pag(pag, ds.d, ds.queries, store, CFG, n_shards=4,
                            device="cpu")
    np.testing.assert_array_equal(traced[0], plain[0])
    np.testing.assert_array_equal(traced[1], plain[1])
    names = {s.name for s in tracer.spans}
    assert {"kernel_launch l2_topk", "kernel_launch pq_adc"} <= names
    snap = metrics.snapshot()
    for key in ("search.graph_wall_s", "search.pool_wall_s",
                "kernels.launch_s"):
        assert snap[f"{key}.count"] >= 1 and snap[f"{key}.sum"] > 0


def test_replicas_and_resilience_serve_through_a_dead_shard():
    from repro_torch.storage.resilience import ResiliencePolicy
    ds = make_dataset("clustered", n=2000, d=16, n_queries=24, k_gt=10,
                      seed=5, device="cpu")
    pag = build_pag(ds.base, p=0.2, lam=3.0, redundancy=2, seed=0,
                    device="cpu")
    store = ObjectStore(StorageConfig.preset("dfs", seed=1))
    write_partitions(pag, ds.base, store, n_shards=4, replicas=2,
                     device="cpu")
    cfg = SearchConfig(L=24, k=10, n_probe_max=8)
    serving = ShardedServing(pag=pag, store=store, n_shards=4, dim=ds.d,
                             replicas=2, device="cpu")
    want, _, _ = serving.search(ds.queries, cfg)
    serving.enable_resilience(ResiliencePolicy())
    serving.kill_shard(2)
    got, _, st = serving.search(ds.queries, cfg)
    np.testing.assert_array_equal(got, want)
    assert st.n_degraded_queries() == 0 and st.total_failovers() > 0
