#!/usr/bin/env python3
"""What ``chip_smoke.py``'s own process holds on the card when its rank
paths begin.

    python3 scripts/main_memory.py

Runs ``chip_smoke.main()`` up to the ``dp_train`` path, then, in place of
its one-process side, lists every CUDA tensor the garbage collector
reaches, largest storage first, with what refers to it (two levels of
referrers: container types, dict keys, object attributes), and the
allocator's allocated and reserved bytes; then stops. Prints the card's
name and power limit and ``MAIN MEMORY OK`` last.
"""
import gc
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def describe(obj, seen) -> str:
    """A short name for a referrer: a dict's key pointing at ``seen``, an
    object's attribute, or the container's type."""
    if isinstance(obj, dict):
        keys = [str(k) for k, v in obj.items() if v is seen][:3]
        return f"dict[{','.join(keys)}]"
    return type(obj).__name__


def holders(t, depth: int = 2) -> list:
    out, frontier = [], [t]
    for _ in range(depth):
        nxt = []
        for x in frontier:
            for r in gc.get_referrers(x):
                if r is frontier or isinstance(r, type(sys._getframe())):
                    continue
                out.append(describe(r, x))
                nxt.append(r)
        frontier = nxt[:6]
    return out[:12]


def stop(*_a, **_k):
    gc.collect()
    torch.cuda.empty_cache()
    seen, rows = set(), []
    for obj in gc.get_objects():
        try:
            if not (torch.is_tensor(obj) and obj.is_cuda):
                continue
        except Exception:   # noqa: BLE001  (objects that refuse the test)
            continue
        ptr = obj.untyped_storage().data_ptr()
        if ptr in seen:
            continue
        seen.add(ptr)
        rows.append((obj.untyped_storage().nbytes(), list(obj.shape),
                     str(obj.dtype), holders(obj)))
    rows.sort(key=lambda r: -r[0])
    print(f"main process: allocated {torch.cuda.memory_allocated()}, "
          f"reserved {torch.cuda.memory_reserved()} bytes; "
          f"{len(rows)} CUDA storages reachable, "
          f"{sum(r[0] for r in rows)} bytes", flush=True)
    for nbytes, shape, dtype, refs in rows[:25]:
        print(f"  {nbytes} bytes {shape} {dtype} held by {refs}",
              flush=True)
    raise SystemExit(0)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cs.dp_reference = stop
    try:
        cs.main()
    except SystemExit:
        pass
    print(card)
    print("MAIN MEMORY OK")
