#!/usr/bin/env python3
"""Producer lag of the live serving cluster below its knee, on a host
whose cores are busy.

Run from the root of a checkout:

    python3 scripts/cluster_lag.py [--src SRC] [--device cuda|cpu]
        [--multiple 0.65] [--stress 0,8,16] [--repeats 2]

The deployment is ``chip_smoke.py`` phase 8's bracket run: the default
deployment with real service on ``--device`` (placement device), priced
at the 6,912-byte crop, at time compression 1 and ``--multiple`` times
the closed-form knee. For each ``--stress`` count that many processes
spin on the host's cores while ``--repeats`` runs go. ``--src`` is the
``src`` directory of the tree under test (default: this checkout's), so
that two trees are compared on one host by running the script once for
each in turns. One line a run (produced, completed, diverged, mean
producer lag against its 5-period limit, in-flight growth, decode +
identify ms a batch, the process's CPU seconds), then one JSON line of
every run. Every process it starts is stopped before it exits.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spec_at(device: str, multiple: float):
    """The bracket run's spec at ``multiple`` x the knee."""
    from repro_torch.cluster import ClusterSpec
    from repro_torch.core.facerec import CROP_SIZE
    from repro_torch.core.simulator import FaceRecWorkload
    spec = ClusterSpec(wl=FaceRecWorkload(face_bytes=float(CROP_SIZE**2 * 3)),
                       service="real", device=device, placement="device",
                       time_compression=1.0)
    return replace(spec, speedup=multiple * spec.closed_form_knee())


def one_run(device: str, multiple: float) -> dict:
    from repro_torch.cluster import ServingCluster
    spec = spec_at(device, multiple)
    cl = ServingCluster(spec)
    cl.warm()
    cpu0 = sum(os.times()[:2])
    res = cl.run()
    cpu = sum(os.times()[:2]) - cpu0
    spans = [s for _, s in res.batch_spans]
    return {"produced": res.produced, "completed": res.completed,
            "diverged": bool(res.diverged), "lag_s": res.producer_lag_mean,
            "lag_limit_s": 5 * spec.period_s,
            "inflight_growth": res.inflight_growth,
            "batch_ms": 1e3 * sum(spans) / max(len(spans), 1),
            "cpu_s": cpu}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multiple", type=float, default=0.65)
    ap.add_argument("--stress", default="0,8,16")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.device.startswith("cuda"):
        from repro_torch.kernels import build
        build.build_all()
    rows = []
    for n in (int(s) for s in args.stress.split(",")):
        spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(n)]
        try:
            time.sleep(1.0)
            for rep in range(args.repeats):
                row = {"stress": n, "repeat": rep,
                       **one_run(args.device, args.multiple)}
                rows.append(row)
                print(f"stress {n}: produced {row['produced']} completed "
                      f"{row['completed']} diverged {row['diverged']} lag "
                      f"{row['lag_s']:.6f} / {row['lag_limit_s']:.6f} model "
                      f"s, growth {row['inflight_growth']:.1f}, batch "
                      f"{row['batch_ms']:.3f} ms, process CPU "
                      f"{row['cpu_s']:.2f} s", flush=True)
        finally:
            for p in spin:
                p.kill()
                p.wait()
    print(json.dumps({"src": args.src, "multiple": args.multiple,
                      "device": args.device, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
