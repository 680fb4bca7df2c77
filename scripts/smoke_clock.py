#!/usr/bin/env python3
"""Sum a chip_smoke.py log's ``[phase]`` lines by path.

    python3 scripts/smoke_clock.py LOG [LOG ...]

Prints one markdown row a log: the seconds of each path's phases (the
columns of PERF.md's clock table), in the smoke's order. A phase belongs
to the path its name starts with; ``device``, ``build``, the edge checks
and the REDUCED prefills have columns of their own.
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
    ("census", ("census",)), ("main", ("main",)),
    ("compare", ("compare", "cmp")), ("kernel rows", ("kernel timing",)))
PHASE = re.compile(r"^\[phase\] (.*): ([0-9.]+) s$")


def column(name: str) -> str:
    for col, prefixes in COLUMNS:
        if name.startswith(prefixes):
            return col
    return "other"


def main() -> int:
    cols = [c for c, _ in COLUMNS] + ["other"]
    print("| log | " + " | ".join(cols) + " | sum |")
    print("| --- " * (len(cols) + 2) + "|")
    for path in sys.argv[1:]:
        secs = dict.fromkeys(cols, 0.0)
        with open(path) as f:
            for line in f:
                m = PHASE.match(line.strip())
                if m:
                    secs[column(m.group(1))] += float(m.group(2))
        print(f"| {path} | " + " | ".join(f"{secs[c]:.1f}" for c in cols)
              + f" | {sum(secs.values()):.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
