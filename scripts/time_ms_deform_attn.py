#!/usr/bin/env python3
"""Time one tree's deformable-attention wrappers (kernel 8, the forward,
and 8b, the backward with its zero fill) on the card, on chip_smoke.py's
phase 7 inputs: the encoder's (Q = S = 6380) and the decoder's (Q = 100)
shapes at 480x640, on random and on the model's locations.

    python3 scripts/time_ms_deform_attn.py                 # this tree's port
    python3 scripts/time_ms_deform_attn.py --repo DIR      # the port in DIR
    python3 scripts/time_ms_deform_attn.py --repo DIR --detr

The inputs and the timing (CUDA graphs of 20 calls x 10 replays, inputs
L2-warm) are this tree's chip_smoke.py's, so two trees timed in one call
are timed on the same inputs; the port package, and so the kernels and
the build directory, come from DIR. Each forward is held to the plain
version bit for bit first. --detr also runs this tree's phase 12b on
DIR's port: both Deformable-DETR variants at 480x640 (ms a frame, device
busy ms a frame, the device time by op group, kernel 8's device time a
call in the frame). Prints one JSON line of microseconds a call (and the
phase's numbers), with the card's name and power limit. To compare two
trees, run them in turns in one call: parent, change, change, parent.
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
    parser.add_argument("--detr", action="store_true",
                        help="also run phase 12b on the tree's port")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_ms_deform_attn: no CUDA card", file=sys.stderr)
        return 1
    tree = Path(args.repo).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from embodied_object_detection_tpu_torch.ops import ms_deform_attn as ma
    if not Path(ma.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {ma.__file__}, not the port in "
                           f"{args.repo}")
    times = {}
    inputs = smoke.msda_timed_inputs(np.random.RandomState(78))
    for (name, locality), (value, locs, attn, grad) in inputs.items():
        out = ma.ms_deform_attn_cuda(value, smoke.DETR_LEVELS, locs, attn)
        plain = ma.ms_deform_attn_plain(value, smoke.DETR_LEVELS, locs, attn)
        if not torch.equal(out, plain):
            raise AssertionError(f"{name}, {locality}: the forward differs "
                                 f"from the plain version")
        fwd, bwd = smoke.msda_kernel_ms(ma, value, locs, attn, grad)
        times[f"{name}, {locality}"] = {"forward": fwd * 1e3,
                                        "backward": bwd * 1e3}
    result = {"repo": str(args.repo), "ms_deform_attn_us": times}
    if args.detr:
        _, result["detr"] = smoke.run_detr_inference()
    result["card"] = smoke.smi("name,power.limit")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
