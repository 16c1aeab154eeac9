#!/usr/bin/env python3
"""Run one tree's card-against-CPU eval protocol (chip_smoke.py phase 10b)
on the card and report how far the two devices' write-paste boxes lie
apart in every frame, beside the frames whose pasted pixels differ.

    python3 scripts/paste_box_gaps.py DIR   # DIR's chip_smoke.py and port

Phase 10b counts a pasted pixel that differs between the card and the CPU
as an input flip only where the frame's boxes agree within 1e-2 px. This
script shows how often the boxes of frames with no differing pixel already
lie further apart than that, in the tree at hand: run it for two trees in
one call to compare them. Prints the card's name and power limit, the
phase's own lines and whether it passed, then per frame of the three
presets the largest box gap (its rows first put in the CPU's order where
the tree aligns them) and the pixels that differ, and a summary.
"""

import os
import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(sys.argv[1]).resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import chip_smoke

    print(chip_smoke.smi("name,power.limit"))
    chip_smoke.build_kernels()
    frames = []
    flips = chip_smoke.paste_flips
    align = getattr(chip_smoke, "align_write_rows", None)

    def recorded(cpu, card, h, w):
        same = card if align is None else align(cpu, card)
        gap = float((cpu.boxes - same.boxes).abs().max()) \
            if cpu.boxes.numel() and cpu.boxes.shape == same.boxes.shape \
            else float("nan")
        differ = int((cpu.out != same.out).sum()) \
            if cpu.out.shape == same.out.shape else -1
        frames.append((gap, differ))
        return flips(cpu, card, h, w)

    chip_smoke.paste_flips = recorded
    try:
        chip_smoke.eval_engine_against_cpu()
        print("phase 10b passed")
    except AssertionError as e:
        print(f"phase 10b failed: {e}")
    for i, (gap, differ) in enumerate(frames):
        print(f"  frame {i}: box gap {gap:.4e} px, {differ} pixels differ")
    calm = [g for g, d in frames if d == 0]
    print(f"{len(frames)} frames; {sum(g > 1e-2 for g in calm)} of the "
          f"{len(calm)} with no differing pixel have a box gap over 1e-2 "
          f"px (largest {max(calm, default=0.0):.4e}); frames with "
          f"differing pixels: gaps "
          f"{[f'{g:.4e}' for g, d in frames if d != 0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
