#!/usr/bin/env python3
"""Several runs of one cell in a row, each a process of its own:

    python3 portbench/tools/runs.py --workload <name> --seeds 11 12 13 \
        --seconds 50 [--trace 0|1] [--out build/portbench/runs.jsonl]

Prints, for each run, its seed, exit code, wall seconds and result line
(or the end of its standard error), appends the same as a JSON line to
``--out``, and ends with each end-to-end metric's median and its quartile
spread over the runs (``statistics.quantiles(values, n=4)``: the distance
between the first and third quartiles over the median).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=str(ROOT / "build" / "portbench" /
                                        "runs.jsonl"))
    args = p.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    rows = []
    for seed in args.seeds:
        cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if proc.returncode == 0 else None
        except (IndexError, json.JSONDecodeError):
            res = None
        row = {"workload": args.workload, "seed": seed,
               "trace": args.trace, "rc": proc.returncode,
               "wall_s": wall, "result": res,
               "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({k: row[k] for k in ("seed", "rc", "wall_s")}),
              flush=True)
        print(json.dumps(res) if res else proc.stderr[-3000:], flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    if len(ok) >= 2:
        for name in ok[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            line = f"{name}: median {statistics.median(vals)!r} of {vals}"
            if len(vals) >= 3:
                line += f"; spread {spread(vals)!r}"
            print(line, flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
