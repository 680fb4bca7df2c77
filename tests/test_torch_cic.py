"""The port's rest of the build path against the reference: ``cic_build``
(recall@10 within 0.01 of the reference's on the same arrays, connected,
original ids, the same ``stats`` keys), index checkpoints (a bit-identical
round trip whose loaded index serves the same ids) and ``obs/report.py``
(the reference's strings and shares for the same spans). Small data made
here from a seed: 1,500 x 16 uniform, 30 queries."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.cic import cic_build as ref_cic_build  # noqa: E402
from repro.core.graph_search import greedy_search as ref_greedy  # noqa: E402
from repro.data.vectors import make_dataset, recall_at_k  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro.obs.trace import Tracer as RefTracer  # noqa: E402
from repro_torch.checkpoint import latest_step, load_checkpoint  # noqa: E402
from repro_torch.core.build import reachable_mask  # noqa: E402
from repro_torch.core.cic import cic_build  # noqa: E402
from repro_torch.core.graph_search import greedy_search  # noqa: E402
from repro_torch.core.index import load_index, save_index  # noqa: E402
from repro_torch.core.pag import build_pag  # noqa: E402
from repro_torch.core.search import SearchConfig, search_pag  # noqa: E402
from repro_torch.core.search import write_partitions  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.storage.simulator import (  # noqa: E402
    ObjectStore,
    StorageConfig,
)

torch.set_num_threads(2)   # xdist runs several workers on the same cores

K = 10


@pytest.fixture(scope="module")
def ds():
    return make_dataset("uniform", n=1500, d=16, n_queries=30, k_gt=20,
                        seed=1)


@pytest.fixture(scope="module")
def built(ds):
    stats, ref_stats = {}, {}
    pg = cic_build(ds.base, c=4, R=16, L=32, stats=stats, device="cpu")
    ref_pg = ref_cic_build(ds.base, c=4, R=16, L=32, stats=ref_stats)
    return pg, stats, ref_pg, ref_stats


def test_cic_recall_matches_reference(built, ds):
    pg, _, ref_pg, _ = built
    A, nbrs, n_nodes, entry = pg.device_arrays("cpu")
    res = greedy_search(A, nbrs, n_nodes, entry,
                        torch.from_numpy(ds.queries), L=64, K=K)
    A, nbrs, n_nodes, entry = ref_pg.device_arrays()
    ref_res = ref_greedy(A, nbrs, n_nodes, entry, jnp.asarray(ds.queries),
                         L=64, K=K)
    rec = recall_at_k(res.ids.numpy(), ds.gt_ids, K)
    ref_rec = recall_at_k(np.asarray(ref_res.ids), ds.gt_ids, K)
    assert abs(rec - ref_rec) <= 0.01, (rec, ref_rec)


def test_cic_connected_with_original_ids_and_stats(built, ds):
    pg, stats, ref_pg, ref_stats = built
    assert reachable_mask(pg).all()
    # arena row i holds vector x[i] (identity remap contract)
    np.testing.assert_array_equal(pg.A[:pg.n_nodes], ds.base)
    assert pg.nbrs.shape == ref_pg.nbrs.shape
    assert pg.R_prune == ref_pg.R_prune
    assert set(stats) == set(ref_stats)
    assert stats["c"] == 4 and stats["n"] == ds.n
    assert stats["parallel_total_s"] < stats["total_s"]


def _pag_and_store(ds):
    pag = build_pag(ds.base, p=0.2, lam=3.0, redundancy=4, device="cpu")
    store = ObjectStore(StorageConfig.preset("mem"))
    write_partitions(pag, ds.base, store, n_shards=4, device="cpu")
    return pag, store


def test_index_checkpoint_round_trip_is_bit_identical(ds, tmp_path):
    pag, store = _pag_and_store(ds)
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    save_index(d, pag, step=3, extra={"note": "first"})
    path = save_index(d, pag, step=7)
    save_index(d, pag, step=7)                  # same step: replaced whole
    assert latest_step(d) == 7
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000007"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)                 # JSON, not msgpack
    assert manifest["step"] == 7
    assert manifest["keys"] == list(pag.arrays())

    loaded = load_index(d)
    for key, arr in pag.arrays().items():
        got = loaded.arrays()[key]
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
    assert loaded.build_stats == pag.build_stats
    assert load_checkpoint(d, 3)[2]["note"] == "first"

    cfg = SearchConfig(L=32, k=K, n_probe_max=16)
    ids, d2, _ = search_pag(pag, ds.d, ds.queries, store, cfg, n_shards=4,
                            device="cpu")
    ids2, d22, _ = search_pag(loaded, ds.d, ds.queries, store, cfg,
                              n_shards=4, device="cpu")
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(d2, d22)
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "empty"))


def _record(tracer):
    """The same spans into either package's tracer: two batch roots with
    compute / stall / scan tiles, an untiled tail, stage extents and one
    dropped span."""
    tracer.max_tracks = 3
    for b, (pq, tail) in enumerate([(False, 0.0), (True, 2.5e-4)]):
        track = f"batch{b}"
        tracer.span(track, "batch", 0.0, 4e-3 + tail, cat="batch",
                    args={"engine": "batched", "pq": pq})
        t = 0.0
        for cat, dur in [("compute", 1e-3), ("stall", 1.75e-3),
                         ("scan", 5e-4), ("compute", 3e-4),
                         ("stall", 2e-4), ("scan", 2.5e-4)]:
            tracer.span(track, cat, t, dur, cat=cat)
            t += dur
        tracer.aspan(track, "fetch_wave", 1e-3, 1.9e-3, cat="stage")
        if pq:
            tracer.aspan(track, "adc", 2.9e-3, 4e-4, cat="stage")
    tracer.span("batch2", "batch", 0.0, 1.0, cat="batch")
    tracer.span("batch3", "batch", 0.0, 1.0, cat="batch")   # over the cap


def test_report_gives_the_reference_strings_for_the_same_spans():
    tracer, ref_tracer = Tracer(), RefTracer()
    _record(tracer)
    _record(ref_tracer)
    assert tracer.n_dropped == ref_tracer.n_dropped == 1
    assert report.timeline_breakdown(tracer) == \
        ref_report.timeline_breakdown(ref_tracer)
    assert report.fetch_stall_share(tracer) == \
        ref_report.fetch_stall_share(ref_tracer)
    for root, ref_root in zip(tracer.roots("batch"),
                              ref_tracer.roots("batch")):
        assert report.batch_tile_shares(tracer, root) == \
            ref_report.batch_tile_shares(ref_tracer, ref_root)
        assert report.batch_breakdown(tracer, root) == \
            ref_report.batch_breakdown(ref_tracer, ref_root)
    assert report.timeline_breakdown(Tracer()) == \
        "(no batch spans recorded)"
