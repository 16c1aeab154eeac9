#!/usr/bin/env python3
"""Time the CenterNet head's canvas kernels (10, 10b and 10c) and the
proposals stage on the card, at the main path's shapes (480 x 640: five
levels of 256 channels on a 91 x 80 canvas; Res5: one 30 x 40 level of
1024 channels).

    python3 scripts/time_centernet.py

The kernels run as `chip_smoke.py`'s phase 7b runs them (each first held
to its plain version, then CUDA graphs of 20 calls x 10 replays, inputs
L2-warm, beside its plain version and its bound). The stage, per level
against packed (same seeded weights and features), is timed twice: its
device time a call (CUDA graphs) and its host time a call (eager calls,
the last one synchronised): "stage_before" the per-level head and the
five-sort decode (`tests/centernet_reference.py`), "stage_per_level" the
per-level head and the one-sort decode (the training forward's),
"stage_packed" `CenterNetHead.proposals`. Prints the compiler's register
report and one JSON line with the card's name and power limit.
"""

import collections
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FULL_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10), (4, 5))


def host_ms(torch, fn, reps: int = 50) -> float:
    """Host time of one eager call: `reps` calls, then one synchronise."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_centernet: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    from centernet_reference import decode_per_level
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from embodied_object_detection_tpu_torch.config import CenterNetConfig
    from embodied_object_detection_tpu_torch.kernels import build
    from embodied_object_detection_tpu_torch.models import centernet as tcn

    report = build.build(("centernet_pack", "nms"))
    for name, (secs, log) in report.items():
        print(f"built {name} in {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {line.strip()}")
    rng = np.random.RandomState(40)
    out = {"card": smoke.smi("name,power.limit")}
    for k in smoke.time_centernet(rng, collections.defaultdict(int)):
        out[k["name"]] = {"kernel_us": k["ms"] * 1e3,
                          "plain_us": k["plain_ms"] * 1e3,
                          "bound_us": k["bound_ms"] * 1e3}

    # the stage: the default head (bf16 tower) on seeded weights
    torch.manual_seed(41)
    head = tcn.CenterNetHead(5, 256, 4, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.endswith("weight") and "tower_gn" not in name:
                p.normal_(0.0, 0.01)
        head.agn_hm.bias.fill_(-4.6)
    feats = [torch.randn(h, w, 256, device="cuda").to(torch.bfloat16)
             for h, w in FULL_LEVELS]
    cfg = CenterNetConfig()

    def packed():
        return head.proposals(feats, cfg)

    def per_level(decode):
        head.packs = lambda f: False
        try:
            return decode(*head(feats), cfg)
        finally:
            del head.packs

    with torch.no_grad():
        for name, fn in (
                ("stage_before", lambda: per_level(decode_per_level)),
                ("stage_per_level",
                 lambda: per_level(tcn.decode_proposals)),
                ("stage_packed", packed)):
            out[name] = {"device_ms": smoke.graph_ms(fn),
                         "host_ms": host_ms(torch, fn)}
            print(name, out[name], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
