#!/usr/bin/env python3
"""Time the kernels of two checkouts of the PyTorch/CUDA port on one card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 scripts/compare_port_trees.py OTHER_ROOT [FUNCTION ...]

OTHER_ROOT is another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit). Each FUNCTION (default:
``time_yuv time_iou``) is a phase-7 timing function of this checkout's
``chip_smoke.py``, called as ``fn(device, scratch)``. The functions run
against OTHER_ROOT's ``repro_torch`` and against this checkout's in
turns (other, this, this, other), each turn in a process of its own that
builds its tree's kernels, so that two versions of a kernel are compared
on one card within one call. Each turn's lines follow a header naming its
tree; the exit code is non-zero if a turn failed.

A function runs against OTHER_ROOT only if every ``repro_torch`` name it
calls exists there too. ``time_yuv`` and ``time_iou`` call only the
wrappers ``preproc.yuv_to_rgb`` and ``preproc.iou_matrix`` and their
plain versions, which every tree since the IoU kernel was ported has; a
function that reads a route table or launches one route directly
(``launches_by_route``, ``linear_scan._launch``, ...) runs only against a
tree that has the same one.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke                  # puts this checkout's src first
sys.path.insert(0, {src!r})        # then the tree under test goes before it
import torch
import repro_torch
assert repro_torch.__file__.startswith({src!r}), repro_torch.__file__
device = torch.device("cuda", 0)
scratch = torch.zeros(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                      device=device)
for name in {fns!r}:
    getattr(chip_smoke, name)(device, scratch)
"""


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    fns = argv[1:] or ["time_yuv", "time_iou"]
    rc = 0
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        print(f"== {label} tree: {tree}", flush=True)
        code = TURN.format(root=str(ROOT), src=str(tree / "src"), fns=fns)
        rc |= subprocess.run([sys.executable, "-c", code]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
