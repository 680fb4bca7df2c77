"""The masked scan kernels' selection (``csrc/topk_select.cuh``), emulated
in plain torch on the CPU and held to the plain versions' selection
(``kernels/l2_topk.py:_masked_select``) bit for bit, ids and distances.

The emulation follows the kernel step by step: the 32-bit order-preserving
key of each distance (masked positions keyed as 3.4e38, -0.0 as +0.0), the
radix select of the key of rank min(k, C) in digits of 11, 11 and 10 bits
that stops once the rank's bin is taken whole, the survivors below the bin,
the stable (position-ordered) compaction of a tied key, and the final sort
by (key, position). The CUDA kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``. Also here: the shared- or
global-memory branch of the keys (``select_smem``) for both kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import l2_topk  # noqa: E402
from repro_torch.kernels.l2_topk import INF, _masked_select  # noqa: E402

DIGITS = [(21, 11), (10, 11), (0, 10)]   # (shift, bits) from the top
U32 = 0xffffffff


def float_keys(d2: torch.Tensor) -> torch.Tensor:
    """The kernel's float_key, as int64 holding the u32 key."""
    u = d2.float().contiguous().view(torch.int32).to(torch.int64) & U32
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where((u & 0x80000000) != 0, ~u & U32, u | 0x80000000)


def key_floats(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's key_float: the inverse of float_keys."""
    u = torch.where((keys & 0x80000000) != 0, keys & 0x7fffffff, ~keys & U32)
    return u.to(torch.int32).view(torch.float32)   # low 32 bits


def select_row(keys: torch.Tensor, ids: torch.Tensor, k: int):
    """One block's select_topk over keys [C] (int64 u32 keys) and ids [C].
    Returns (d [k], ids [k], route) where ``route`` is "radix N" (N digit
    passes) with " ties" when the stable tie compaction ran."""
    c = keys.shape[0]
    kk = min(k, c)
    prefix = mask = 0
    want, n_bin, passes = kk, 0, 0
    pos = torch.arange(c)
    for shift, bits in DIGITS:
        passes += 1
        match = (keys & mask) == prefix
        hist = torch.bincount((keys[match] >> shift) & ((1 << bits) - 1),
                              minlength=1 << bits)
        cum = hist.cumsum(0)
        j = int((cum < want).sum())        # the bin where rank `want` falls
        want -= int(cum[j] - hist[j])
        n_bin = int(hist[j])
        prefix |= j << shift
        mask |= ((1 << bits) - 1) << shift
        if n_bin == want:                  # the bin is taken whole
            break
    whole = n_bin == want
    route = f"radix {passes}" + ("" if whole else " ties")
    m = keys & mask
    surv = pos[(m < prefix) | ((m == prefix) & whole)]
    if not whole:   # the tied key t: its first `want` positions
        surv = torch.cat([surv, pos[keys == prefix][:want]])
    assert surv.shape[0] == kk
    pairs = torch.sort((keys[surv] << 32) | surv).values
    out_d = torch.full((k,), INF, dtype=torch.float32)
    out_i = torch.full((k,), -1, dtype=torch.int32)
    chosen = ids[pairs & U32]
    real = chosen >= 0
    out_d[:kk] = torch.where(real, key_floats(pairs >> 32),
                             torch.tensor(INF, dtype=torch.float32))
    out_i[:kk] = torch.where(real, chosen, torch.tensor(-1, dtype=torch.int32))
    return out_d, out_i, route


def emulate(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """The kernels' selection over d2 [Q, C] (the scan's distances) with
    ids [Q, C] (-1 = padding): masked keys, then select_row per query."""
    ids = ids.to(torch.int32)
    keys = float_keys(torch.where(ids >= 0, d2.float(),
                                  torch.full_like(d2.float(), INF)))
    rows = [select_row(keys[i], ids[i], k) for i in range(d2.shape[0])]
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]), [r[2] for r in rows])


def _ids(rng, q, c, pad_frac=0.0):
    ids = np.tile(rng.permutation(1 << 20)[:c].astype(np.int32), (q, 1))
    ids[rng.random((q, c)) < pad_frac] = -1
    return torch.from_numpy(ids)


def _near(base, n, rng):
    """n distinct floats just above ``base``, all in its first-digit bin."""
    return base + rng.permutation(4096)[:n].astype(np.float32) * 2.0 ** -14


def _case(name, rng):
    """(d2 [Q, C], ids [Q, C], k, route): what at least one row of the
    case must reach (see select_row): "ties" (the stable tie compaction),
    "radix 3" (all three digit passes), or None."""
    if name == "all_equal_k10_few":
        return torch.full((3, 500), 7.0), _ids(rng, 3, 500, 0.3), 10, None
    if name in ("all_equal_k10", "all_equal_k64"):
        k = 10 if name == "all_equal_k10" else 64
        return torch.full((3, 3000), 7.0), _ids(rng, 3, 3000, 0.3), k, "ties"
    if name in ("ties_straddle_k_few", "ties_straddle_k"):
        # 6 distances below 3.0, then 20 exactly at 3.0 over places 7-26;
        # the rest integers above 4, or just above 3.0 in its first-digit
        # bin (the later digits decide)
        c = 900 if name == "ties_straddle_k_few" else 3000
        d2 = np.stack([rng.integers(4, 50, c).astype(np.float32)
                       if c == 900 else _near(3.0, c, rng) for _ in range(4)])
        for row in d2:
            at = rng.permutation(c)[:26]
            row[at[:6]] = np.arange(6, dtype=np.float32) * 0.5
            row[at[6:]] = 3.0
        return torch.from_numpy(d2), _ids(rng, 4, c, 0.2), 10, \
            "ties"
    if name in ("zeros_signed_and_clamped_few", "zeros_signed_and_clamped"):
        # -0.0 and +0.0 tie (the plain sort sees them equal); negative
        # expanded-form distances clamp to +0.0 as the kernel clamps
        c = 300 if name.endswith("few") else 3000
        d2 = torch.from_numpy(rng.standard_normal((4, c)).astype(
            np.float32)).mul(1e-6).clamp_min(0.0)
        d2[:, ::7] = -0.0
        assert torch.signbit(d2).any() and (d2 == 0).sum() > 4 * 64
        return d2, _ids(rng, 4, c, 0.1), 64, \
            "ties"
    if name in ("real_rows_at_inf_beside_padding_few",
                "real_rows_at_inf_beside_padding"):
        c = 400 if name.endswith("few") else 3000
        d2 = torch.from_numpy(rng.random((3, c)).astype(np.float32))
        d2[:, 1::2] = INF          # real rows at the sentinel distance
        ids = _ids(rng, 3, c)
        ids[:, 0::4] = -1          # padding interleaved among them
        d2[0, :] = INF             # a row of real INF rows and padding
        return d2, ids, 256, "ties"
    if name == "interleaved_padding":
        d2 = torch.from_numpy(rng.random((5, 3000)).astype(np.float32))
        return d2, _ids(rng, 5, 3000, 0.4), 64, None
    if name == "c_below_k":
        d2 = torch.from_numpy(rng.random((3, 40)).astype(np.float32))
        return d2, _ids(rng, 3, 40, 0.3), 64, None
    if name == "c_is_1":
        d2 = torch.from_numpy(rng.random((4, 1)).astype(np.float32))
        ids = _ids(rng, 4, 1)
        ids[1] = -1
        return d2, ids, 10, None
    if name == "k_256":
        d2 = torch.from_numpy(rng.random((3, 5000)).astype(np.float32))
        return d2, _ids(rng, 3, 5000, 0.25), 256, None
    if name == "no_real_candidate":
        d2 = torch.from_numpy(rng.random((3, 3000)).astype(np.float32))
        ids = _ids(rng, 3, 3000, 0.5)
        ids[1] = -1                # a row of masked keys only
        return d2, ids, 10, "ties"
    if name == "main_path_spread":
        # distances of one magnitude (SIFT-like norms): the first digit
        # holds thousands of keys, so the later digits decide
        d2 = torch.from_numpy((5e4 + 3e4 * rng.random((4, 15000))).astype(
            np.float32))
        return d2, _ids(rng, 4, 15000, 0.3), 10, "radix 2"
    if name == "three_passes":
        # 3000 keys one ulp apart in the low digits: the third pass decides
        bits = torch.full((2, 3000), 1000.0).view(torch.int32) + \
            torch.from_numpy(np.stack([rng.permutation(3000)] * 2).astype(
                np.int32))
        return bits.view(torch.float32), _ids(rng, 2, 3000), 64, "radix 3"
    if name == "negative_adc_sums":
        d2 = torch.from_numpy(rng.standard_normal((3, 800)).astype(np.float32))
        return d2, _ids(rng, 3, 800, 0.2), 32, None
    raise KeyError(name)


CASES = ["all_equal_k10_few", "all_equal_k10", "all_equal_k64",
         "ties_straddle_k_few", "ties_straddle_k",
         "zeros_signed_and_clamped_few", "zeros_signed_and_clamped",
         "real_rows_at_inf_beside_padding_few",
         "real_rows_at_inf_beside_padding", "interleaved_padding",
         "c_below_k", "c_is_1", "k_256", "no_real_candidate",
         "main_path_spread", "three_passes", "negative_adc_sums"]


@pytest.mark.parametrize("name", CASES)
def test_emulated_selection_matches_the_plain_select(name):
    rng = np.random.default_rng(CASES.index(name))
    d2, ids, k, route = _case(name, rng)
    got_d, got_i, routes = emulate(d2, ids, k)
    want_d, want_i = _masked_select(d2, ids, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    if route == "ties":
        assert any(r.endswith("ties") for r in routes), routes
    elif route is not None:
        assert any(r.startswith(route) for r in routes), routes


def test_float_keys_order_like_floats_and_invert():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(np.concatenate([
        rng.standard_normal(1000).astype(np.float32) * 1e3,
        np.float32([0.0, -0.0, INF, -INF, 1e-45, -1e-45, np.inf])]))
    keys = float_keys(v)
    order = torch.argsort(keys, stable=True)
    assert (torch.diff(v[order]) >= 0).all()
    back = key_floats(keys)
    assert torch.equal(back, v)          # -0.0 comes back as +0.0 == -0.0
    assert not torch.signbit(key_floats(float_keys(torch.tensor([-0.0])))).any()


# (kernel, C, d or M, keys in shared memory): the main path's shapes, the
# global-key shapes of chip_smoke's edge checks, and the M = 64 LUT
PLANS = [("l2", 14_973, 128, True), ("l2", 60_000, 128, False),
         ("l2", 1, 1024, True), ("l2", 47_000, 128, True),
         ("l2", 49_000, 128, False), ("pq", 14_941, 8, True),
         ("pq", 120_000, 8, False), ("pq", 30_000, 64, True),
         ("pq", 40_000, 64, False), ("pq", 900, 16, True)]


@pytest.mark.parametrize("kernel,c,width,shared", PLANS)
def test_select_smem_picks_the_branch_and_its_bytes(kernel, c, width, shared):
    head = 4 * width if kernel == "l2" else 1024 * width
    got_shared, smem = l2_topk.select_smem(c, head)
    assert got_shared == shared
    base = l2_topk.SELECT_HEAD + -(-head // 16) * 16
    keys = 16 * -(-c // 4)     # C rounded up to 4 (keys are read as uint4)
    assert smem == base + (keys if shared else 0)
    # within the budget, and the 227 KB a block may take with the static
    # shared state (< 1 KB) beside it
    assert smem <= l2_topk.SMEM_BUDGET < 227 * 1024 - 1024
    # shared exactly when the keys fit beside the rest
    assert shared == (base + keys <= l2_topk.SMEM_BUDGET)
