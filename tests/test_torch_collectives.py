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


# --------------------------------------------------------------------------
# the shared host segment (distributed/shm.py) against gloo's collectives
# --------------------------------------------------------------------------

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from repro_torch.distributed import shm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the meshes of each gloo world (ranks 0..world-1 of 8 processes)
WORLDS = {8: [(1, 8), (2, 4)], 4: [(2, 2)], 2: [(1, 2)]}
DTYPES = ("float32", "bfloat16", "int64")
SLOT = 4096       # bytes: the segment's least slot, so most cases take rounds
# name: (shape, dim); every dim a reduce-scatter cuts divides by 8
EXCHANGES = {
    "small": ((8,), 0),
    "rows/dim1": ((8, 24, 16), 1),     # 3072 elements: rounds of whole rows
    "rows/dim0": ((16, 24, 8), 0),
    "rows/dim2": ((3, 8, 40), 2),
    "row-pieces/dim0": ((4096,), 0),   # one row larger than a slot
    "row-pieces/dim1": ((2, 2400), 1),
}
# five exchanges in a row on one segment, of different sizes
SERIES = [(5,), (2000,), (3, 7, 9), (1,), (1027,)]

_RANK = r"""
import errno, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core.distributed import slice_sum
from repro_torch.distributed import compat, shm
from repro_torch.launch import mesh as pm
torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
worlds, dtypes, slot, exchanges, series = (eval(a) for a in sys.argv[3:8])
seg_dir = os.path.join(out, "shm")
res, errors = {}, {}

def bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy().copy()
    return t.numpy().copy()

def seeded(shape, dtype, salt):
    g = np.random.default_rng(1000 * rank + salt)
    if dtype == "int64":
        return torch.from_numpy(g.integers(-2 ** 40, 2 ** 40, shape))
    # magnitudes spread over six decades, so that every addition rounds
    x = g.standard_normal(shape) * 10.0 ** g.integers(-3, 3, shape)
    return torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))

def gathered(t, group, n, dim):
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts

for world in (8, 4, 2):
    if rank >= world:
        break
    compat.init_ranks("gloo", f"file://{out}/rendezvous{world}", rank, world)
    for shape in worlds[world]:
        mesh = pm.make_mesh(shape, ("data", "model"))
        for axis in ("data", "model"):
            n = mesh.shape[axis]
            if n == 1:
                continue
            group = mesh.groups[axis]
            seg = shm.Segment(group, slot_bytes=slot, directory=seg_dir)
            key = f"{shape}/{axis}"
            for dt in dtypes:
                for name, (tshape, dim) in exchanges.items():
                    t = seeded(tshape, dt, len(name))
                    parts = gathered(t, group, n, dim)
                    res[f"{key}/{dt}/{name}/gather"] = bits(seg.gather(t, dim))
                    res[f"{key}/{dt}/{name}/gather/want"] = bits(
                        torch.cat(parts, dim))
                    size = tshape[dim] // n
                    res[f"{key}/{dt}/{name}/reduce_scatter"] = bits(
                        seg.reduce_scatter(t, dim))
                    res[f"{key}/{dt}/{name}/reduce_scatter/want"] = bits(
                        slice_sum(torch.stack(parts), dim,
                                  mesh.axis_index(axis) * size, size, "cpu"))
                    if n == 2:
                        res[f"{key}/{dt}/{name}/sum_pair"] = bits(
                            seg.sum_pair(t))
                        want = t.clone()
                        dist.all_reduce(want, group=group)
                        res[f"{key}/{dt}/{name}/sum_pair/want"] = bits(want)
                for i, tshape in enumerate(series):
                    t = seeded(tshape, dt, 100 + i)
                    res[f"{key}/{dt}/series{i}/gather"] = bits(
                        seg.gather(t, 0))
                    res[f"{key}/{dt}/series{i}/gather/want"] = bits(
                        torch.cat(gathered(t, group, n, 0), 0))
            seg.close()
    if world == 2:
        # a directory that does not exist, a slot too large for any
        # file, and a mapping refused on member 1: every member raises
        group = dist.group.WORLD
        for case, kw in (("missing", dict(directory=seg_dir + "/missing",
                                          slot_bytes=slot)),
                         ("too-large", dict(directory=seg_dir,
                                            slot_bytes=1 << 56))):
            try:
                shm.Segment(group, **kw)
                errors[case] = ""
            except shm.SegmentError as e:
                errors[case] = str(e)
        real = shm.mmap.mmap
        if rank == 1:
            def refused(*a, **k):
                raise OSError(errno.ENOMEM, os.strerror(errno.ENOMEM))
            shm.mmap.mmap = refused
        try:
            shm.Segment(group, directory=seg_dir, slot_bytes=slot)
            errors["unmappable"] = ""
        except shm.SegmentError as e:
            errors["unmappable"] = str(e)
        shm.mmap.mmap = real
        # the group goes on after a failure: a segment made afresh works
        seg = shm.Segment(group, directory=seg_dir, slot_bytes=slot)
        t = seeded((6,), "float32", 7)
        res["after-failure/gather"] = bits(seg.gather(t, 0))
        res["after-failure/gather/want"] = bits(torch.cat(gathered(
            t, group, 2, 0)))
        seg.close()
    compat.shutdown()
errors["left"] = json.dumps(sorted(os.listdir(seg_dir)))
np.savez(out + f"/rank{rank}.npz", **res)
with open(out + f"/errors{rank}.json", "w") as f:
    json.dump(errors, f)
"""


@pytest.fixture(scope="module")
def segment_runs(tmp_path_factory):
    """8 rank processes on the CPU: gloo worlds of 8, 4 and 2 (``file://``
    rendezvous), each exchange through ``shm.Segment`` beside gloo's
    ``all_gather`` / ``all_reduce`` on the same tensors. Returns
    ({rank: {key: bits}}, {rank: {failure: message}})."""
    import json
    out = tmp_path_factory.mktemp("shm")
    (out / "shm").mkdir()
    (out / "rank.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(out / "rank.py"), str(r), str(out),
         repr(WORLDS), repr(DTYPES), str(SLOT), repr(EXCHANGES),
         repr(SERIES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(8)]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return ({r: dict(np.load(out / f"rank{r}.npz")) for r in range(8)},
            {r: json.loads((out / f"errors{r}.json").read_text())
             for r in range(8)})


def _axes(shape):
    return [a for a, n in zip(("data", "model"), shape) if n > 1]


GROUPS = [(world, shape, axis) for world, shapes in WORLDS.items()
          for shape in shapes for axis in _axes(shape)]


@pytest.mark.parametrize("op", ["gather", "reduce_scatter"])
@pytest.mark.parametrize("name", list(EXCHANGES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,shape,axis", GROUPS)
def test_segment_exchange_is_gloos_bit_for_bit(segment_runs, world, shape,
                                               axis, dtype, name, op):
    """A gather is ``dist.all_gather``'s parts concatenated, and a
    reduce-scatter this rank's slice of them summed in rank order
    (``slice_sum``), bit for bit, on every rank of the world; most of
    these take several rounds of a 4 KiB slot."""
    res, _ = segment_runs
    key = f"{shape}/{axis}/{dtype}/{name}/{op}"
    for r in range(world):
        got, want = res[r][key], res[r][key + "/want"]
        assert got.dtype == want.dtype and got.shape == want.shape, r
        assert np.array_equal(got, want), (r, key)


@pytest.mark.parametrize("name", list(EXCHANGES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,shape,axis", [
    g for g in GROUPS if g[1][("data", "model").index(g[2])] == 2])
def test_segment_two_rank_sum_is_all_reduce_bit_for_bit(
        segment_runs, world, shape, axis, dtype, name):
    """A two-rank group's sum is ``dist.all_reduce``'s, bit for bit, the
    same on both ranks."""
    res, _ = segment_runs
    key = f"{shape}/{axis}/{dtype}/{name}/sum_pair"
    for r in range(world):
        assert np.array_equal(res[r][key], res[r][key + "/want"]), (r, key)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,shape,axis", GROUPS)
def test_segment_reuses_its_slots_over_a_series(segment_runs, world, shape,
                                                axis, dtype):
    """Five gathers in a row of different sizes on one segment (the slots
    rewritten each round) give ``all_gather``'s bits each time."""
    res, _ = segment_runs
    for i in range(len(SERIES)):
        key = f"{shape}/{axis}/{dtype}/series{i}/gather"
        for r in range(world):
            assert np.array_equal(res[r][key], res[r][key + "/want"]), (
                r, key)


@pytest.mark.parametrize("case,what,code", [
    ("missing", "creation", "ENOENT"),
    ("too-large", "allocation", ""),
    ("unmappable", "mapping", "ENOMEM")])
def test_a_segment_that_cannot_be_made_or_mapped_raises_on_every_rank(
        segment_runs, case, what, code):
    """No fallback: a segment that cannot be created, allocated or mapped
    raises ``SegmentError`` on every member, naming the path, the size
    and the errno (a mapping refused on member 1 names that member); the
    group goes on, and a segment made afresh exchanges correctly."""
    res, errors = segment_runs
    for r in range(2):
        msg = errors[r][case]
        assert f"{what} of the shared segment " in msg, (r, msg)
        assert "bytes) failed" in msg and "errno " in msg, (r, msg)
        assert code in msg, (r, msg)
        if case == "unmappable":
            assert msg.startswith("member 1: "), (r, msg)
        assert np.array_equal(res[r]["after-failure/gather"],
                              res[r]["after-failure/gather/want"])


def test_no_segment_outlives_its_run(segment_runs):
    """Every segment was unlinked once its members had mapped it (or had
    failed to): the directory is empty after every run, failures
    included."""
    _, errors = segment_runs
    assert all(errors[r]["left"] == "[]" for r in range(8))


@pytest.mark.parametrize("rows,cols,cap", [
    (4, 6, 24), (4, 6, 13), (4, 6, 5), (1, 10, 3), (3, 1, 1), (0, 5, 4),
    (5, 0, 4)])
def test_blocks_cover_the_exchange_once_within_the_slot(rows, cols, cap):
    """``_blocks`` splits a [rows, cols] exchange into rounds of at most
    ``cap`` elements that cover every element exactly once, whole rows
    while a row fits."""
    seen = np.zeros((rows, cols), int)
    for r0, r1, a, b in shm._blocks(rows, cols, cap):
        assert 0 < (r1 - r0) * (b - a) <= cap
        assert (a, b) == (0, cols) if cols <= cap else r1 - r0 == 1
        seen[r0:r1, a:b] += 1
    assert (seen == 1).all()
