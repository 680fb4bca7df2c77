"""The port's data and build path against the reference on ``small_ds``:
bit-identical vectors, a PAG that assigns every residual with the
reference's partition count (within 5%) and recall (within 0.02), and a
PQ codebook whose quantisation error is the reference's (within 2%)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.baselines.pq import encode_pq as ref_encode  # noqa: E402
from repro.baselines.pq import train_pq as ref_train  # noqa: E402
from repro.core.search import SearchConfig as RefConfig  # noqa: E402
from repro.core.search import search_pag as ref_search  # noqa: E402
from repro.data.vectors import recall_at_k  # noqa: E402
from repro_torch.baselines.pq import encode_pq, train_pq  # noqa: E402
from repro_torch.core.pag import build_pag  # noqa: E402
from repro_torch.core.search import SearchConfig, search_pag  # noqa: E402
from repro_torch.core.search import write_partitions  # noqa: E402
from repro_torch.data.vectors import make_dataset  # noqa: E402
from repro_torch.storage.simulator import (  # noqa: E402
    ObjectStore,
    StorageConfig,
)

torch.set_num_threads(2)   # xdist runs several workers on the same cores


@pytest.fixture(scope="module")
def port_pag(small_ds):
    # the built_pag fixture's arguments (tests/conftest.py)
    return build_pag(small_ds.base, p=0.2, k=8, lam=3.0, redundancy=4,
                     seed=0, device="cpu")


def test_make_dataset_is_bit_identical(small_ds):
    ds = make_dataset("clustered", n=6000, d=32, n_queries=100, k_gt=50,
                      seed=0, device="cpu")
    assert ds.name == small_ds.name
    np.testing.assert_array_equal(ds.base, small_ds.base)
    np.testing.assert_array_equal(ds.queries, small_ds.queries)
    np.testing.assert_allclose(ds.gt_d2, small_ds.gt_d2, rtol=1e-4,
                               atol=1e-4)
    assert (ds.gt_ids[:, :10] == small_ds.gt_ids[:, :10]).mean() >= 0.99


def test_build_pag_assigns_every_residual(port_pag, built_pag, small_ds):
    n = small_ds.n
    agg = port_pag.node_src[:port_pag.n_parts]
    members = port_pag.plist[:port_pag.n_parts]
    covered = np.zeros(n, bool)
    covered[agg] = True
    covered[members[members >= 0]] = True
    assert covered.all()
    assert (port_pag.pcount <= port_pag.cap).all()
    assert abs(port_pag.n_parts - built_pag.n_parts) <= 0.05 * \
        built_pag.n_parts


def test_own_index_recall_matches_reference(port_pag, built_pag, pag_store,
                                            small_ds):
    cfg = dict(L=32, k=10, n_probe_max=16)
    ref_ids, _, _ = ref_search(built_pag, small_ds.d, small_ds.queries,
                               pag_store, RefConfig(**cfg), n_shards=4)
    store = ObjectStore(StorageConfig.preset("mem"))
    write_partitions(port_pag, small_ds.base, store, n_shards=4,
                     device="cpu")
    ids, _, _ = search_pag(port_pag, small_ds.d, small_ds.queries, store,
                           SearchConfig(**cfg), n_shards=4, device="cpu")
    assert abs(recall_at_k(ids, small_ds.gt_ids, 10)
               - recall_at_k(ref_ids, small_ds.gt_ids, 10)) <= 0.02


def _mse(cb, codes, x):
    m = np.arange(cb.M)[None, :]
    rec = cb.centroids[m, codes.astype(np.int64)].reshape(len(x), -1)
    return float(((rec - x) ** 2).mean())


def test_train_pq_quantisation_error_matches_reference(small_ds):
    x = small_ds.base
    ref_cb = ref_train(x, M=8, seed=0)
    cb = train_pq(x, M=8, seed=0, device="cpu")
    assert cb.centroids.shape == ref_cb.centroids.shape == (8, 256, 4)
    ref_mse = _mse(ref_cb, ref_encode(ref_cb, x), x)
    assert abs(_mse(cb, encode_pq(cb, x, device="cpu"), x) - ref_mse) \
        <= 0.02 * ref_mse
    # encoding is row-wise: the reference encoder on the port's codebook
    # gives the same codes on all but float near-ties
    assert (encode_pq(cb, x, device="cpu") == ref_encode(cb, x)).mean() \
        >= 0.999


def test_adc_tables_match_reference(small_ds):
    from repro.baselines.pq import adc_lut_batch as ref_luts
    from repro_torch.baselines.pq import adc_lut_batch
    cb = train_pq(small_ds.base, M=8, n_train=1024, seed=1, device="cpu")
    q = small_ds.queries[:16]
    luts = adc_lut_batch(cb, torch.from_numpy(q))
    assert luts.shape == (16, 8, 256) and luts.dtype == torch.float32
    np.testing.assert_allclose(luts.numpy(), ref_luts(cb, q), rtol=1e-5,
                               atol=1e-5)
