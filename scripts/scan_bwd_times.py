#!/usr/bin/env python3
"""Device times of the two scan backward kernels by route, batch and
length, on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/scan_bwd_times.py [--B 1,4] [--S 64,256,1024]
        [--profile] [--out chiprun_out/scan_bwd_times.json]

At rwkv6-3b's heads (40 x 64) and jamba's Mamba width (Di 8,192, N 16),
bf16 as training feeds them, zero initial state and no final-state
gradient: for every (B, S) the forward route the training step takes is
launched once for its checkpoints, then each backward route that takes
the shape is timed by CUDA-graph replay (median of 5 replays of 5 calls),
all in one process on one card, so that routes compare within one run.
Scaling with S at fixed B separates a serial chain (time linear in S,
flat in B while the blocks fit the card at once) from traffic (time
linear in B S). With ``--profile``, each route's launches of one call at
the largest B and S are also timed kernel by kernel under
``torch.profiler`` (CUDA activity, the device time of each kernel name
over 5 calls, divided by 5). One line a time, then the card's name and
power limit, then one JSON line of every time, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def thunks(kind: str, B: int, S: int, device):
    """{route: thunk} of the ``kind`` scan's backward at (B, S), on the
    checkpoints of the forward route training takes, as ``chip_smoke.py``'s
    phase 7 builds them (:func:`chip_smoke.scan_bwd_thunk`)."""
    import torch

    import chip_smoke as cs
    dims = ((cs.RWKV_H, cs.RWKV_K) if kind == "rwkv"
            else (cs.MAMBA_DI, cs.MAMBA_N))
    ins, _, _ = cs.scan_bwd_inputs(kind, B, S, dims, torch.bfloat16, device,
                                   False, False)
    out_shape = ins[3].shape if kind == "rwkv" else ins[4].shape
    dy = torch.randn(out_shape, generator=cs._gen(17)).to(device,
                                                          torch.bfloat16)
    return {rt: cs.scan_bwd_thunk(kind, ins, dy, None, rt)
            for rt in cs.scan_bwd_routes(kind, torch.bfloat16, dims)}


def profile_ms(fn, calls: int = 5) -> dict[str, float]:
    """Device ms a call of each kernel ``fn`` launches, by kernel name,
    from ``torch.profiler`` over ``calls`` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", default="1,4")
    ap.add_argument("--S", default="64,256,1024")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "scan_bwd_times.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    device = torch.device("cuda")
    rows, profiles = [], []
    Bs = [int(b) for b in args.B.split(",")]
    Ss = [int(s) for s in args.S.split(",")]
    for kind in ("rwkv", "mamba"):
        for B in Bs:
            for S in Ss:
                for route, fn in thunks(kind, B, S, device).items():
                    ms = cs.cuda_time_ms(fn, iters=5)
                    rows.append({"kernel": f"{kind}_scan_bwd", "route": route,
                                 "B": B, "S": S, "ms": ms})
                    print(f"time {kind}_scan_bwd ({route}) B={B} S={S}: "
                          f"{ms:.6f} ms")
                    if args.profile and (B, S) == (max(Bs), max(Ss)):
                        by_kernel = profile_ms(fn)
                        profiles.append({"kernel": f"{kind}_scan_bwd",
                                         "route": route, "B": B, "S": S,
                                         "ms_by_kernel": by_kernel})
                        print(f"profile {kind}_scan_bwd ({route}) B={B} "
                              f"S={S}: " + json.dumps(by_kernel))
                torch.cuda.empty_cache()
    card = cs.card_line()
    print(card)
    result = {"card": card, "times": rows, "profiles": profiles}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
