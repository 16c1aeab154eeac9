#!/usr/bin/env python3
"""Run one tree's eval-path phase (chip_smoke.py phase 5) with its
profiler pass on the card, to compare two trees' frames.

    python3 scripts/profile_frame.py DIR OUT   # DIR's chip_smoke.py and port

The tree's own chip_smoke.py builds its kernels, runs the counted 4-frame
chunk at 480x640 (ms per frame over 4 chunks, launches, no host sync) and
profiles one chunk into OUT: the device ops, the device busy ms a frame
and the op table (OUT/chunk_ops.txt; the chrome trace is deleted, it is
tens of MB). Run two trees in one call, in turns (parent, change, change,
parent), to compare them on one card; the card's name and power limit are
printed first.
"""

import os
import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    tree, out = Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import chip_smoke

    print(chip_smoke.smi("name,power.limit"))
    chip_smoke.build_kernels()
    chip_smoke.run_main_path(str(out))
    for trace in out.glob("*.json"):
        trace.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
