#!/usr/bin/env python3
"""Time one tree's segment-sum wrapper (kernel 1, zero fill included) on
the card, on chip_smoke.py's random, coherent and one-cell ids.

    python3 scripts/time_segment_sum.py                # this tree's port
    python3 scripts/time_segment_sum.py --repo DIR     # the port in DIR

The inputs and the timing (CUDA graphs of 20 calls x 10 replays, inputs
L2-warm) are this tree's chip_smoke.py's, so two trees timed in one call
are timed on the same rows; the port package, and so the kernel and the
build directory, come from DIR. Prints one JSON line of microseconds a
call, with the card's name and power limit.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(REPO),
                        help="the tree whose port is timed")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_segment_sum: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss
    if not Path(ss.__file__).resolve().is_relative_to(
            Path(args.repo).resolve()):
        raise RuntimeError(f"imported {ss.__file__}, not the port in "
                           f"{args.repo}")
    rng = np.random.RandomState(77)
    times = {}
    for ids in ("random", "coherent", "one_cell"):
        w, idx, cells = smoke.segment_sum_inputs(rng, ids)
        got = ss.segment_sum(w, idx, cells)
        want = ss.segment_sum_plain(w, idx, cells)
        if not torch.equal(got[:, -1], want[:, -1]):
            raise AssertionError(f"{ids}: the count lane differs")
        times[ids] = smoke.graph_ms(
            lambda: ss.segment_sum(w, idx, cells)) * 1e3
    print(json.dumps({"repo": str(args.repo), "segment_sum_us": times,
                      "card": smoke.smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
