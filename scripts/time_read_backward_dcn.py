#!/usr/bin/env python3
"""Time one tree's memory-read transpose (kernel 2b) and DCNv2 kernels (9,
the im2col, and 9b, its backward) on the card, on chip_smoke.py's phase
13 and 13b inputs: 2b on the eval frame's read at 8192 x 512 with 480x640
random and coherent ids and on the batched read at B = 4; 9 and 9b at the
five CenterNet levels of a 480x640 frame (60x80 to 4x5, 256 channels),
modulated and not.

    python3 scripts/time_read_backward_dcn.py                # this tree
    python3 scripts/time_read_backward_dcn.py --repo DIR     # the port in DIR
    python3 scripts/time_read_backward_dcn.py --passes       # and 2b's kernels

The inputs and the timing (CUDA graphs of 20 calls x 10 replays, inputs
L2-warm) are this tree's chip_smoke.py's, so two trees timed in one call
are timed on the same inputs; the port package, and so the kernels and
the build directory, come from DIR. Each 2b gradient is held first within
its f32-sum bound of the exact sum (`memory_read_grad_exact`), each
im2col's columns bit-equal to the plain version. --passes adds the device
time of each kernel (and memset) of one 2b call, from torch.profiler over
10 calls. Prints one JSON line of microseconds a call with the card's
name and power limit. To compare two trees, run them in turns in one
call: parent, change, change, parent.
"""

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def kernel_us(fn, calls: int = 10):
    """{device kernel (or memset): microseconds a call} over `calls` calls
    of fn, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None) or \
            getattr(event, "cuda_time_total", 0)
        if total:
            name = re.search(r"::(\w+(<\w+>)?)\(", event.key)
            out[name.group(1) if name else event.key] = total / calls
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(REPO),
                        help="the tree whose port is timed")
    parser.add_argument("--passes", action="store_true",
                        help="also time each of 2b's kernels with "
                             "torch.profiler")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_read_backward_dcn: no CUDA card", file=sys.stderr)
        return 1
    tree = Path(args.repo).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    from embodied_object_detection_tpu_torch.ops import memory_ops as mo
    if not Path(mo.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {mo.__file__}, not the port in "
                           f"{args.repo}")
    read, passes = {}, {}
    for name, _, obs, proj, grad in smoke.read_backward_cases(
            np.random.RandomState(14)):
        got = mo.memory_read_backward_cuda(grad, obs, proj)
        exact, _, tight, _ = mo.memory_read_grad_exact(grad, obs, proj)
        if not bool(((got.double() - exact).abs() <= tight).all()):
            raise AssertionError(f"2b, {name}: beyond its f32-sum bound")
        read[name] = smoke.graph_ms(
            lambda: mo.memory_read_backward_cuda(grad, obs, proj)) * 1e3
        if args.passes:
            passes[name] = kernel_us(
                lambda: mo.memory_read_backward_cuda(grad, obs, proj))
    im2col, backward = {}, {}
    blocks = smoke.dcn_blocks()
    for modulated, block in blocks.items():
        for x, grad_out in smoke.dcn_level_inputs(np.random.RandomState(13)):
            off, mask = smoke.dcn_offsets(block, x)
            key = (f"{'modulated' if modulated else 'unmodulated'} "
                   f"{x.shape[0]}x{x.shape[1]}x{x.shape[2]}")
            if not torch.equal(
                    dc.deform_im2col_cuda(x, off, mask, 3, 3, 1, 1, 1),
                    dc.deform_im2col_plain(x, off, mask, 3, 3, 1, 1, 1)):
                raise AssertionError(f"9, {key}: the columns differ from "
                                     f"the plain version")
            col_ms, bwd_ms = smoke.dcn_level_ms(block, x, grad_out)
            im2col[key], backward[key] = col_ms * 1e3, bwd_ms * 1e3
    print(json.dumps({"repo": str(args.repo),
                      "memory_read_backward_us": read,
                      **({"memory_read_backward_passes_us": passes}
                         if args.passes else {}),
                      "deform_im2col_us": im2col,
                      "deform_im2col_backward_us": backward,
                      "card": smoke.smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
