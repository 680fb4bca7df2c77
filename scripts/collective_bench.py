#!/usr/bin/env python3
"""Where the seconds of an exchange between ranks sharing one card go:
gloo's sockets against the shared host segment (``distributed/shm.py``).

    python3 scripts/collective_bench.py [--mib 528] [--kib 32] [--reps 2]
                                        [--small-reps 200] [--worlds 4 8]

Starts gloo ranks on ``cuda:0`` (the smoke's rank paths' layout,
``file://`` rendezvous), a world of 4 and then one of 8, and on every
rank at once (a barrier before each) times on the host's clock, the card
synchronised:

* world 4, mesh (data 2, model 2): a gather of a bf16 tensor of ``--mib``
  MiB over ``data`` (the FSDP gather of one expert weight of DBRX-132B
  at 1 layer on (2, 2) is 528 MiB a rank) and a reduce-scatter of the
  same tensor, each through gloo as the port exchanged before the
  segment (the pageable copy to the host, ``dist.all_gather`` of host
  tensors, each part copied to its place on the card) and through the
  segment, both split into the copy out, the exchange or barrier and the
  copy in; ``core/distributed.py``'s ``_gather`` as a whole;
* a small exchange of ``--kib`` KiB of bf16 (a decode step's) over
  ``model`` on (1, 4), on (1, 8) in the world of 8, and the two-rank sum
  over ``model`` on (2, 2) and over ``data`` on (2, 4): through gloo as
  before, through the segment with its barrier on the flags in the
  segment, and through the segment with ``dist.barrier`` as its barrier,
  ``--small-reps`` in a row, each split likewise.

Prints one JSON line a rank and world (seconds: the mean over the reps),
the card's name and power limit, and ``COLLECTIVE BENCH OK`` last.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("copy_out", "barrier", "copy_in")


def timed(fn, reps: int, barrier) -> float:
    out = 0.0
    for _ in range(reps):
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out += time.perf_counter() - t0
    return out / reps


def segment_kind(shm):
    class TimedSegment(shm.Segment):
        """``shm.Segment`` with each round's parts timed into ``split``:
        the copy out (with its synchronise), the barriers (the wait for
        the members' writes and for their reads) and the copy in; with
        ``gloo_barrier`` the barriers are ``dist.barrier`` on the group,
        not the flags."""
        gloo_barrier = False

        def reset(self):
            self.split = dict.fromkeys(PARTS, 0.0)

        def _round(self, t, write, read):
            import torch.distributed as dist
            split, clock = self.split, time.perf_counter
            sync = torch.cuda.current_stream(t.device).synchronize
            r = self.round
            t0 = clock()
            if self.gloo_barrier:
                dist.barrier(group=self.group)
            else:
                self._wait(2 * r)
            t1 = clock()
            write()
            sync()
            self._post(2 * r + 1)
            t2 = clock()
            if self.gloo_barrier:
                dist.barrier(group=self.group)
            else:
                self._wait(2 * r + 1)
            t3 = clock()
            read()
            sync()
            self._post(2 * r + 2)
            t4 = clock()
            self.round = r + 1
            split["barrier"] += (t1 - t0) + (t3 - t2)
            split["copy_out"] += t2 - t1
            split["copy_in"] += t4 - t3
    return TimedSegment


def gloo_exchange(t, group, n, dim, split, index=None):
    """The exchange as the port made it through gloo before the segment:
    ``t`` to the host (pageable), ``dist.all_gather`` there, then each
    part (a gather) or this rank's slice of each, summed in rank order (a
    reduce-scatter, ``index`` given) to the card."""
    import torch.distributed as dist
    from repro_torch.core.distributed import slice_sum
    clock = time.perf_counter
    t0 = clock()
    src = t.cpu()
    t1 = clock()
    parts = src.new_empty((n, *src.shape))
    dist.all_gather(list(parts.unbind(0)), src, group=group)
    t2 = clock()
    if index is None:
        size = t.shape[dim]
        shape = list(t.shape)
        shape[dim] *= n
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        for i, part in enumerate(parts.unbind(0)):
            out.narrow(dim, i * size, size).copy_(part)
    else:
        size = t.shape[dim] // n
        out = slice_sum(parts, dim, index * size, size, t.device)
    torch.cuda.synchronize()
    t3 = clock()
    for k, dt in zip(PARTS, (t1 - t0, t2 - t1, t3 - t2)):
        split[k] += dt
    return out


def gloo_sum_pair(t, group, split):
    """The two-rank sum as the port made it before the segment."""
    import torch.distributed as dist
    clock = time.perf_counter
    t0 = clock()
    out = t.cpu()
    t1 = clock()
    dist.all_reduce(out, group=group)
    t2 = clock()
    out = out.to(t.device)
    torch.cuda.synchronize()
    t3 = clock()
    for k, dt in zip(PARTS, (t1 - t0, t2 - t1, t3 - t2)):
        split[k] += dt
    return out


def rank_main(rank: int, world: int, tmp: str, a) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.core import distributed as pd
    from repro_torch.distributed import compat, shm
    from repro_torch.launch import mesh as pm

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", f"file://{tmp}/rendezvous{world}", rank, world)
    Seg = segment_kind(shm)
    barrier = dist.barrier
    rep = {"world": world, "rank": rank}
    try:
        if world == 4:
            mesh = pm.make_mesh((2, 2), ("data", "model"))
            group = mesh.groups["data"]
            n = a.mib * 2 ** 20 // 2
            t = torch.full((n,), float(rank), dtype=torch.bfloat16,
                           device=dev)
            t0 = time.perf_counter()
            seg = Seg(group, dev)
            rep["segment_setup_s"] = time.perf_counter() - t0
            rep["segment_bytes"] = seg.size
            rep["slot_is_pinned"] = bool(seg.slots[0].is_pinned())
            idx = mesh.axis_index("data")
            big = rep["large"] = {"bytes": n * 2}
            for op, index in (("gather", None), ("reduce_scatter", idx)):
                split = dict.fromkeys(PARTS, 0.0)
                big[f"gloo_{op}_s"] = timed(
                    lambda: gloo_exchange(t, group, 2, 0, split, index),
                    a.reps, barrier)
                big[f"gloo_{op}_split_s"] = {k: v / a.reps
                                             for k, v in split.items()}
                seg.reset()
                fn = seg.gather if index is None else seg.reduce_scatter
                big[f"segment_{op}_s"] = timed(lambda: fn(t, 0), a.reps,
                                               barrier)
                big[f"segment_{op}_split_s"] = {k: v / a.reps
                                                for k, v in seg.split.items()}
            want = torch.cat([torch.full((n,), float(mesh.coords[1] + 2 * i),
                                         dtype=torch.bfloat16, device=dev)
                              for i in range(2)])
            big["segment_gather_right"] = bool(torch.equal(seg.gather(t, 0),
                                                           want))
            big["port_gather_s"] = timed(lambda: pd._gather(mesh, "data", t,
                                                            0), a.reps,
                                         barrier)
            seg.close()
            del t, want
            torch.cuda.empty_cache()
            small = [((1, 4), "model", "gather"), ((2, 2), "model", "sum")]
        else:
            small = [((1, 8), "model", "gather"), ((2, 4), "data", "sum")]
        n = a.kib * 1024 // 2
        for shape, axis, op in small:
            mesh = pm.make_mesh(shape, ("data", "model"))
            group, m = mesh.groups[axis], mesh.shape[axis]
            t = torch.randn(n, device=dev).to(torch.bfloat16)
            key = f"small_{op}_{shape[0]}x{shape[1]}_{axis}"
            row = rep[key] = {"bytes": n * 2, "ranks": m,
                              "reps": a.small_reps}
            split = dict.fromkeys(PARTS, 0.0)
            if op == "gather":
                fn = lambda: gloo_exchange(t, group, m, 0, split)  # noqa
            else:
                fn = lambda: gloo_sum_pair(t, group, split)  # noqa
            row["gloo_s"] = timed(lambda: [fn() for _ in range(
                a.small_reps)], 1, barrier) / a.small_reps
            row["gloo_split_s"] = {k: v / a.small_reps
                                   for k, v in split.items()}
            for kind in ("flags", "gloo_barrier"):
                seg = Seg(group, dev)
                seg.gloo_barrier = kind == "gloo_barrier"
                seg.reset()
                fn = (lambda: seg.gather(t, 0)) if op == "gather" \
                    else (lambda: seg.sum_pair(t))
                row[f"segment_{kind}_s"] = timed(lambda: [fn() for _ in range(
                    a.small_reps)], 1, barrier) / a.small_reps
                row[f"segment_{kind}_split_s"] = {
                    k: v / a.small_reps for k, v in seg.split.items()}
                seg.close()
        print(json.dumps(rep), flush=True)
    finally:
        compat.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=528)
    ap.add_argument("--kib", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--small-reps", type=int, default=200)
    ap.add_argument("--worlds", type=int, nargs="+", default=[4, 8])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("collective_bench: no CUDA device")
    import torch.multiprocessing as mp
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        for world in a.worlds:
            mp.start_processes(rank_main, args=(world, tmp, a),
                               nprocs=world, start_method="spawn")
    print(card)
    print("COLLECTIVE BENCH OK")
