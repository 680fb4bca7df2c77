#!/usr/bin/env python3
"""Sum a chip_smoke.py log's ``[phase]`` lines by path.

    python3 scripts/smoke_clock.py LOG [LOG ...]

Prints one markdown row a log: the seconds of each path's phases (the
columns of PERF.md's clock table), in the smoke's order. A phase belongs
to the path its name starts with; ``device``, ``build``, the edge checks
and the REDUCED prefills have columns of their own. A phase timed
inside another (``PARTS``: phase E of ``tp_families``, phase T3 of
``tp``, ``tp_hd``'s M1 and M2 and ``tp_ssd``'s S1-S4, each run in its
path's ranks' phase)
has a column of its own after the sum, and is not summed.
"""
import re
import sys

COLUMNS = (
    ("build", ("device", "build")),
    ("edges", ("kernels vs plain", "REDUCED prefills")),
    ("quality", ("quality",)), ("rag", ("rag",)),
    ("moe", ("moe",)), ("ssm", ("ssm",)), ("hybrid", ("hybrid",)),
    ("audio", ("audio:",)), ("vlm", ("vlm:",)), ("train", ("train:",)),
    ("long_train", ("long_train",)),
    ("audio/vlm_train", ("audio_train", "vlm_train")),
    ("pod", ("pod",)), ("ep", ("ep:",)), ("dp_train", ("dp_train",)),
    ("tp", ("tp:",)), ("tp_families", ("tp_families",)),
    ("tp_hd", ("tp_hd",)), ("tp_ssd", ("tp_ssd",)),
    ("census", ("census",)), ("main", ("main",)),
    ("compare", ("compare", "cmp")), ("kernel rows", ("kernel timing",)))
# phases timed inside another path's phase: shown, not summed
PARTS = (("of which tp_families E", ("tp_families E",)),
         ("of which tp T3", ("tp T3",)),
         ("of which tp_hd M1", ("tp_hd M1",)),
         ("of which tp_hd M2", ("tp_hd M2",)),
         *((f"of which tp_ssd {t}", (f"tp_ssd {t}",))
           for t in ("S1", "S2", "S3", "S4")))
PHASE = re.compile(r"^\[phase\] (.*): ([0-9.]+) s$")


def column(name: str) -> str:
    for col, prefixes in PARTS + COLUMNS:
        if name.startswith(prefixes):
            return col
    return "other"


def main() -> int:
    cols = [c for c, _ in COLUMNS] + ["other"]
    parts = [c for c, _ in PARTS]
    print("| log | " + " | ".join(cols) + " | sum | " + " | ".join(parts)
          + " |")
    print("| --- " * (len(cols) + len(parts) + 2) + "|")
    for path in sys.argv[1:]:
        secs = dict.fromkeys(cols + parts, 0.0)
        with open(path) as f:
            for line in f:
                m = PHASE.match(line.strip())
                if m:
                    secs[column(m.group(1))] += float(m.group(2))
        print(f"| {path} | " + " | ".join(f"{secs[c]:.1f}" for c in cols)
              + f" | {sum(secs[c] for c in cols):.1f} | "
              + " | ".join(f"{secs[c]:.1f}" for c in parts) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
