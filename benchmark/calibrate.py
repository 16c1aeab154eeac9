"""Readings for setting a cell's limits: the port's numbers, and with
`--control 1` the control's, over many seeds in one process (the
kernels built once), one JSON line a seed. Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload CELL --seeds 11,12,13 \
        [--control 1] [--seconds 1]

The lower reading of a number is the largest the port gives over a dozen
seeds or more; the upper, the smallest the control gives (PERF.md, §6).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import common
    cell = common.find_cell(args.workload)
    common.require_cards(cell["chips"])
    from embodied_object_detection_tpu_torch.kernels import build
    build.build()
    kind = common.traffic_kind(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, _, extra = kind.run(cell, seed, args.seconds, False,
                               bool(args.control), "cuda")
        print(json.dumps({"cell": cell["name"], "seed": seed,
                          "readings": extra["readings"],
                          "control": extra.get("control"),
                          "worst_leaves": extra.get("worst_leaves"),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
