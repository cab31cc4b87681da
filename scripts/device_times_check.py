#!/usr/bin/env python3
"""``chip_smoke.device_times`` against ``torch.profiler``'s
``key_averages()`` on one CUDA profile: the same entries, and what each
costs to read.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/device_times_check.py [--iters 5000,20000]

For each count, that many iterations of a (256, 256) product, an add, a
ReLU and a sum run under ``torch.profiler.profile`` (CUDA activity); then
the profile is read both ways. A line a count: the seconds of the run
(with the profiler's exit), of ``device_times`` and of ``key_averages()``,
both readings' device busy µs, and whether their (name, µs, count)
entries are equal; every entry that differs on a line of its own. Exits
with 1 where any differs.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", default="5000,20000")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("device_times_check: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    x = torch.randn(256, 256, device="cuda")
    w = torch.randn(256, 256, device="cuda")
    same = True
    for n in (int(i) for i in args.iters.split(",")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                (x @ w).add_(1.0).relu_().sum()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        mine = cs.device_times(prof)
        t2 = time.perf_counter()
        ref = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        t3 = time.perf_counter()
        a = {e.key: (round(e.self_device_time_total, 3), e.count)
             for e in mine}
        b = {e.key: (round(e.self_device_time_total, 3), e.count)
             for e in ref}
        print(f"iterations {n}: run {t1 - t0:.2f} s, device_times "
              f"{t2 - t1:.3f} s, key_averages {t3 - t2:.2f} s; busy "
              f"{sum(v[0] for v in a.values()):.3f} vs "
              f"{sum(v[0] for v in b.values()):.3f} us; entries equal "
              f"{a == b}")
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                print(f"  differs: {k[:80]}: {a.get(k)} vs {b.get(k)}")
        same = same and a == b
    print(cs.card_line())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
