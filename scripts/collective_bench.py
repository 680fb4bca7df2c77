#!/usr/bin/env python3
"""Where the seconds of a gloo gather between ranks sharing one card go.

    python3 scripts/collective_bench.py [--mib 528] [--reps 2]

Starts 4 gloo ranks on ``cuda:0`` (the smoke's rank paths' layout: mesh
(data 2, model 2), ``file://`` rendezvous) and, on every rank at once
(a barrier before each), gathers a bf16 tensor of ``--mib`` MiB over the
``data`` axis (the FSDP gather of one expert weight of DBRX-132B at
1 layer on (2, 2) is 528 MiB a rank), timing on the host's clock with the
card synchronised:

* ``exchange``: ``core/distributed.py``'s ``_gather`` as a whole;
* its parts alone: the pageable copy to the host, ``dist.all_gather`` of
  host tensors, the concatenation, the pageable copy back;
* the same copies through pinned host buffers.

Prints one JSON line a rank (seconds, the mean of ``--reps``), the card's
name and power limit, and ``COLLECTIVE BENCH OK`` last.
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
RANKS = 4


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


def rank_main(rank: int, tmp: str, mib: int, reps: int) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.core import distributed as pd
    from repro_torch.distributed import compat
    from repro_torch.launch import mesh as pm

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", f"file://{tmp}/rendezvous", rank, RANKS)
    try:
        mesh = pm.make_mesh((2, 2), ("data", "model"))
        group = mesh.groups["data"]
        n = mib * 2 ** 20 // 2
        t = torch.full((n,), float(rank), dtype=torch.bfloat16, device=dev)
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(2)]
        pinned = torch.empty(n, dtype=t.dtype).pin_memory()
        whole = torch.cat(parts)
        barrier = dist.barrier
        rep = {"rank": rank, "bytes": n * 2}
        rep["exchange_s"] = timed(lambda: pd._gather(mesh, "data", t, 0),
                                  reps, barrier)
        rep["to_host_pageable_s"] = timed(lambda: t.cpu(), reps, barrier)
        rep["all_gather_host_s"] = timed(
            lambda: dist.all_gather(parts, host, group=group), reps, barrier)
        rep["cat_host_s"] = timed(lambda: torch.cat(parts), reps, barrier)
        rep["to_card_pageable_s"] = timed(lambda: whole.to(dev), reps,
                                          barrier)
        rep["to_host_pinned_s"] = timed(lambda: pinned.copy_(t), reps,
                                        barrier)
        rep["to_card_pinned_s"] = timed(
            lambda: t.copy_(pinned, non_blocking=True), reps, barrier)
        rep["loopback_all_gather_small_s"] = timed(
            lambda: dist.all_gather([torch.empty(1024) for _ in range(2)],
                                    torch.zeros(1024), group=group), 5,
            barrier)
        try:
            from torch.multiprocessing.reductions import reduce_tensor
            got = [None, None]

            def ipc():
                handles = [None, None]
                dist.all_gather_object(handles, reduce_tensor(t),
                                       group=group)
                for i, (fn, args) in enumerate(handles):
                    got[i] = fn(*args).clone()
                dist.barrier(group=group)
            rep["cuda_ipc_s"] = timed(ipc, reps, barrier)
            rep["cuda_ipc_peer_value"] = float(got[1 - mesh.coords[0]][0])
        except Exception as e:  # noqa: BLE001  (what the card allows)
            rep["cuda_ipc_error"] = repr(e)[:300]
        print(json.dumps(rep), flush=True)
    finally:
        compat.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=528)
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("collective_bench: no CUDA device")
    import torch.multiprocessing as mp
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(tmp, a.mib, a.reps),
                           nprocs=RANKS, start_method="spawn")
    print(card)
    print("COLLECTIVE BENCH OK")
