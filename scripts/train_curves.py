#!/usr/bin/env python3
"""Loss curves of ``chip_smoke.py``'s phase-11 training run of one arch at
several learning rates, through the kernels and through the plain
versions, on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/train_curves.py --arch chameleon-34b
        [--lr 3e-3,1.5e-3] [--plain 3e-3] [--out chiprun_out/curves.json]

The arch is cut to the depth ``chip_smoke.fit_train_depth`` measures, then
for each learning rate a Trainer runs ``chip_smoke.TRAIN_STEPS`` steps of
AdamW (warmup and schedule as ``chip_smoke.train_hp`` sets them) on the
same TokenLoader batches from the same initial weights; the learning
rates of ``--plain`` run again under ``chip_smoke.plain_ops()``, which
runs none of the port's kernels. A line a run: its losses, grad norms,
the means of the first and last five losses and whether they fall by
0.1 (phase 11's gate), the peak memory; for a learning rate run both
ways, the largest relative difference of the two loss curves. Then the
card's name and power limit and one JSON line of every run, also written
to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def run(model, device, lr: float, plain: bool) -> dict:
    """One TRAIN_STEPS run of ``model`` at ``lr``: {"losses", "grad_norms",
    "first", "last", "falls", "peak_gb"}."""
    import contextlib
    import torch
    import chip_smoke as cs
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    hp = dataclasses.replace(cs.train_hp(model.cfg), lr=lr)
    tc = TrainerConfig(steps=cs.TRAIN_STEPS, ckpt_dir=None, log_every=1000)
    torch.cuda.reset_peak_memory_stats(device)
    with cs.plain_ops() if plain else contextlib.nullcontext():
        _, _, hist = Trainer(model, make_train_step(model, hp),
                             cs.train_loader(model.cfg, device), tc).run()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    return {"lr": lr, "plain": plain, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist],
            "skipped": sum(h["skipped"] for h in hist), "first": first,
            "last": last, "falls": last <= first - 0.1,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--lr", default="3e-3",
                    help="comma-separated learning rates, kernels")
    ap.add_argument("--plain", default="",
                    help="comma-separated learning rates, plain versions")
    ap.add_argument("--out", default="chiprun_out/train_curves.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_curves: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    build.build_all()
    model = cs.fit_train_depth(device, get_config(args.arch))
    runs = []
    for lrs, plain in ((args.lr, False), (args.plain, True)):
        for lr in (float(x) for x in lrs.split(",") if x):
            r = run(model, device, lr, plain)
            runs.append(r)
            print(f"curve {args.arch} ({model.cfg.n_layers} layers) lr {lr:g}"
                  f" {'plain versions' if plain else 'kernels'}: losses "
                  f"{json.dumps([round(x, 4) for x in r['losses']])}; grad "
                  f"norms {json.dumps([round(x, 3) for x in r['grad_norms']])}"
                  f"; skipped {r['skipped']}; first 5 {r['first']:.4f}, last "
                  f"5 {r['last']:.4f}: falls by 0.1 {r['falls']}; peak "
                  f"{r['peak_gb']:.3f} GB", flush=True)
    for lr in {r["lr"] for r in runs if r["plain"]}:
        pair = [r for r in runs if r["lr"] == lr]
        if len(pair) == 2:
            a, b = (p["losses"] for p in pair)
            diff = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            print(f"curve {args.arch} lr {lr:g}: kernels vs plain versions, "
                  f"largest relative difference of a step's loss {diff:.3e}")
    print(cs.card_line())
    out = {"arch": args.arch, "n_layers": model.cfg.n_layers,
           "card": cs.card_line(), "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
