"""The benchmark of the PyTorch + CUDA port, one run of one cell:

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the card(s) the cell asks
for. It finds the cell in BENCHMARK.json, its configuration under
configs/, its traffic mix under traffic/ and its checks under workloads/,
all by name; builds the port's kernels (into the checkout's build/), sets
up, warms up, measures (`--trace 0`: the cell's end-to-end metrics over
`--seconds`; `--trace 1`: its per-layer metrics over one traced unit),
checks the port's output against the plain reference, and prints the
result as one JSON line, the last of standard output.

`--control 1` also reads the control (the reference at fp8 at use, in
the port's place) on the same checked units and prints its numbers to
standard error. `--rehearse` runs a miniature of the cell on the CPU
(tests/miniature.json), with no card: a rehearsal of the code paths
that claims no device number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    # every cache the program may fill lives at a fixed path in the
    # checkout, so that only a cell's first run there builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, str(REPO / "build" / sub))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(REPO))
    from benchmark import common
    cell = common.find_cell(args.workload)
    device = "cpu" if args.rehearse else "cuda"
    if args.rehearse:
        common.miniature(cell)
    else:
        common.require_cards(cell["chips"])
        from embodied_object_detection_tpu_torch.kernels import build
        build.build()
    kind = common.traffic_kind(cell)
    result, checks, extra = kind.run(cell, args.seed, args.seconds,
                                     bool(args.trace), bool(args.control),
                                     device)
    if args.trace:
        view = common.TraceView(extra["trace"], extra["plain_clock"],
                                extra["frames"], extra["steps"],
                                extra["flops"], extra["f32_share"],
                                extra["bounds"],
                                result["device"]["memory_peak_bytes"],
                                extra["plain_s"])
        metrics = {}
        for m in cell["per_layer"]:
            value = common.metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = common.metric(value, m["unit"])
        result["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = view.breakdown()
        for k, (b, d) in sorted(view.eodt_by_kernel().items()):
            print(f"kernel {k}: bound {b * 1e3:.4f} ms, device "
                  f"{d * 1e3:.4f} ms in the traced unit", file=sys.stderr)
        print(f"flops {extra['flops']:.6g} a unit, f32 share "
              f"{extra['f32_share']:.4f}; the unit {extra['plain_s']:.4f} s "
              f"without the profiler, {view.window_s:.4f} s under it",
              file=sys.stderr)
    else:
        metrics = kind.report(result, extra, cell)
        metrics["setup_s"] = common.metric(extra["setup_s"], "s")
    if device == "cuda":
        print(f"card: {common.smi('name,power.limit')}", file=sys.stderr)
    if "unit_s" in extra:
        print("unit seconds " + " ".join(f"{t:.3f}" for t in extra["unit_s"]),
              file=sys.stderr)
    print("readings " + json.dumps(extra["readings"]), file=sys.stderr)
    if "control" in extra:
        print("control " + json.dumps(extra["control"]), file=sys.stderr)
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics,
           "device": result["device"]}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    common.emit(out, checks)


if __name__ == "__main__":
    main()
