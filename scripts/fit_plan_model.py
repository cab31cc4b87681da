#!/usr/bin/env python3
"""Fit the launch-plan model's constants for the matmul's rows route to a
plan sweep measured on the card.

``python3 chip_smoke.py --cost`` times every candidate plan of every
battery shape and writes them to ``build/plan_sweep.json`` (copy it out of
the card's machine in the same command). This script reads that file and
fits, by least squares on the relative error, the rows route's model in
``repro_torch.kernels.autotune`` (``matmul_cost_us``): a launch's cost,
per row of K a rank walks in its whole passes of 64 (per se and per row
of A), and per rank of the cluster (per se and per row of A), each
non-negative:

    us = launch + 64 ceil(k_chunk / 64) (row + M row_m)
         + cluster (rank + M rank_m)

The model is linear in its five constants, so the fit is a weighted
linear least squares (weights 1 / us), held non-negative by solving it on
every subset of the constants with the others at 0 and keeping the best
subset whose solution is non-negative. It prints the constants, each
shape's measured best against the model's pick, and the model's error
over every candidate. Run from the root of a checkout (no card needed, only
NumPy):

    python3 scripts/fit_plan_model.py [--sweep build/plan_sweep.json]

``scripts/plan_sweep_h100.json`` is the sweep the committed constants were
fitted to (NVIDIA H100 80GB HBM3, 700.00 W).
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rows_points(sweep: list[dict]) -> list[tuple]:
    """(M, K, N, cluster, k_chunk, us) of every rows-route candidate of the
    sweep the route still takes (up to ROWS_MAX_CLUSTER ranks): the mean
    of its two rounds."""
    from repro_torch.kernels import matmul as mm
    out = []
    for rec in sweep:
        if not rec["key"].startswith("matmul/"):
            continue
        shape = rec["label"].split(")")[0].lstrip("matmul (")
        M, K = (int(x) for x in shape.split(","))
        N = int(rec["label"].split("@(")[1].split(",")[1].split(")")[0])
        if mm._route(M) != "rows":
            continue
        for plan, times in rec["times"].items():
            p = json.loads(plan)
            if p["cluster"] > mm.ROWS_MAX_CLUSTER:
                continue
            out.append((M, K, N, p["cluster"], p["k_chunk"],
                        statistics.mean(times) * 1e3))
    return out


def terms(M, chunk, cluster):
    """The model's five terms, one column each: us = terms @ constants."""
    import numpy as np
    walked = 64 * np.ceil(chunk / 64)
    return np.stack([np.ones_like(M), walked, walked * M, cluster,
                     cluster * M], axis=1)


def fit_nonnegative(A, us):
    """The non-negative x that minimises sum(((A x - us) / us) ** 2)."""
    import numpy as np
    W, y = A / us[:, None], np.ones_like(us)
    best, best_x = np.inf, None
    for keep in itertools.product((False, True), repeat=A.shape[1]):
        x = np.zeros(A.shape[1])
        if any(keep):
            x[list(keep)] = np.linalg.lstsq(W[:, list(keep)], y, rcond=None)[0]
        cost = float(np.sum((W @ x - y) ** 2))
        if (x >= 0).all() and cost < best:
            best, best_x = cost, x
    return best_x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", default=str(ROOT / "build" / "plan_sweep.json"))
    args = ap.parse_args()
    import numpy as np
    pts = rows_points(json.loads(Path(args.sweep).read_text()))
    if not pts:
        print("fit_plan_model: no rows-route candidates in the sweep",
              file=sys.stderr)
        return 1
    M, K, N, cl, ch, us = (np.array(c, dtype=np.float64) for c in zip(*pts))
    A = terms(M, ch, cl)
    x = fit_nonnegative(A, us)
    names = ("_ROWS_US", "_ROWS_ROW_US[0]", "_ROWS_ROW_US[1]",
             "_ROWS_RANK_US[0]", "_ROWS_RANK_US[1]")
    for n, v in zip(names, x):
        print(f"{n} = {v:.4g}")
    err = np.abs(A @ x / us - 1.0)
    print(f"model error over {len(pts)} candidates: median {np.median(err):.3f}, "
          f"max {err.max():.3f}")
    for shape in sorted({(m, k, n) for m, k, n in zip(M, K, N)}):
        sel = (M == shape[0]) & (K == shape[1]) & (N == shape[2])
        best = int(np.argmin(np.where(sel, us, np.inf)))
        pick = int(np.argmin(np.where(sel, A @ x, np.inf)))
        print(f"({int(shape[0])},{int(shape[1])})@({int(shape[1])},{int(shape[2])}): "
              f"measured best cluster {int(cl[best])} {us[best]:.3f} us; "
              f"model's pick cluster {int(cl[pick])} {us[pick]:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
