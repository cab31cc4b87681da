#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 portbench/tools/control.py --workload <name> --seeds 1 2 3 ... \
        --seconds 15 --control 3

For every seed, a run of the cell as ``run.py`` makes it (a window of
``--seconds`` at the cell's own load) and the numbers its ``correct``
compares.
For the first ``--control`` seeds also the control: the reference put in
the program's place and computed a step below the configuration's
precision (bf16 -> fp8 e4m3: every matrix product's operands rounded to
float8), read against the float32 reference as a run reads the
program; for a training cell, besides, the fault of a batch half left out,
planted in the reference put in the program's place. One JSON line a seed.
``--fault <name>`` plants one of ``benchkit.faults`` in the program first,
so the numbers read are the fault's at the cell's own size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=str(ROOT / "build" / "portbench" /
                                        "control.jsonl"))
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]
    import run as entry
    for key, path in entry.CACHE_ENV.items():
        os.environ.setdefault(key, str(path))
    import torch
    from benchkit import checks, harness
    from reference.lm import serve_logits, served_gaps
    from reference.train import train_reference
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if args.fault:
        import pytest
        from benchkit import faults
        getattr(faults, args.fault)(pytest.MonkeyPatch())
    for i, seed in enumerate(args.seeds):
        run, _ = harness.make_run(args.workload, seed, args.seconds, False,
                                  args.device, time.perf_counter())
        out = harness.driver(run.traffic["driver"]).run(run)
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program": {c.name: c.value for c in out.checks}}
        if "ref_logits" in out.extra:
            # every number a serving cell's limits may hold
            row["program"] = checks.gap_numbers(served_gaps(
                out.extra["ref_logits"], out.extra["served"]))
        if i < args.control and "ref_logits" in out.extra:
            ex = out.extra
            seqs, lens = [], []
            for rid, toks, _ in ex["sample"]:
                pr = torch.as_tensor(ex["prompts"][rid], dtype=torch.int64)
                seqs.append(torch.cat([pr, torch.as_tensor(
                    toks[:-1], dtype=torch.int64)]))
                lens.append(len(pr))
            ctl = serve_logits(run.config, seed, seqs, lens,
                               torch.bfloat16, args.device, quant="fp8")
            # read as a run reads the program: the control serves at each
            # position the token it puts first
            row["control"] = checks.gap_numbers(served_gaps(
                ex["ref_logits"], [c.argmax(dim=-1).tolist() for c in ctl]))
            row["served_tokens"] = sum(len(s) for s in ex["served"])
        elif i < args.control and "ref" in out.extra:
            ex = out.extra
            ref = ex["ref"]
            for name, kw in (("control", {"quant": "fp8"}),
                             ("half_batch", {"fault": "half_batch"})):
                r = train_reference(run.config, run.traffic, seed,
                                    ex["batches"], args.device, **kw)
                row[name] = {
                    "loss_gap": max(abs(a - b) / abs(b) for a, b in
                                    zip(r["losses"], ref["losses"])),
                    "grad_gap": checks.leaf_gap(r["grad"], ref["grad"],
                                                list(ref["grad"]))[0],
                    "change_gap": checks.leaf_gap(
                        r["change"], ref["change"], ex["moving"])[0]}
            row["left_out"] = ex["left_out"]
        row["extra"] = {k: v for k, v in out.extra.items()
                        if isinstance(v, (int, float, str))}
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        del out
        checks.free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
