#!/usr/bin/env python3
"""Device times of the flash backward's bf16 routes at deepseek-v2's MLA
widths (H = KV = 128, D = 192, Dv = 128), by sequence length, on one CUDA
card, with a fit of where a block's time goes.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/flash_bwd_times.py [--S 256,1024,4096] [--B 4]
        [--routes wgmma_split] [--causal] [--alt-lib PATH] [--profile]
        [--out build/flash_bwd_times.json]

Each route of ``--routes`` is forced through ``flash_attention._bwd_route``
and timed by CUDA-graph replay (median of 5 replays of 3 calls) at every
S of ``--S`` (Sq = Skv, non-causal unless ``--causal``), all in one
process on one card. A block of a route owns a key tile (64 keys on the
split route, 128 on the kv128 one) and walks the q tiles of 64 rows that
see one of its keys, so a call's time over the card's SMs is about
``blocks x ms_block + iterations x ms_iter`` (one block an SM; the row
pass, dQ's zeroing and its cast, which grow with S too, fall into both
terms); a least-squares fit over the lengths gives those two figures for
each route. With ``--alt-lib`` the same is timed on a second
build of ``csrc/flash_attention_bwd.cu`` (for instance one with a step
compiled out), loaded in place of the checkout's library, beside the
first in the same run. With ``--profile``, each route's launches of one
call at the largest S are also timed kernel by kernel under
``torch.profiler`` (the dQ buffer's zeroing, the row pass, the route's
kernel, dQ's cast). One line a time, a fit and a profile, then the card's
name and power limit, then one JSON line of everything, also written to
``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# keys a block of each route owns
BLOCK_KEYS = {"wgmma_split": 64, "wgmma_kv128": 128}


def work(route: str, B: int, S: int, H: int, causal: bool) -> tuple[int, int]:
    """(blocks, iterations) of one call: a block per (key tile, kv head,
    batch row), an iteration per (query head of its kv head, q tile of 64
    rows that sees one of its keys); MLA has one query head a kv head."""
    bk = BLOCK_KEYS[route]
    n_kt, n_qt = -(-S // bk), -(-S // 64)
    iters = 0
    for kt in range(n_kt):
        first = (kt * bk) // 64 if causal else 0
        iters += n_qt - first
    return B * H * n_kt, B * H * iters


def fit(points: list[tuple[int, int, float]], n_sm: int) -> dict:
    """Least squares of ms x n_sm = blocks x ms_block + iters x ms_iter."""
    import numpy as np
    a = np.array([[b, i] for b, i, _ in points], dtype=np.float64)
    y = np.array([ms * n_sm for _, _, ms in points], dtype=np.float64)
    (c_block, c_iter), *_ = np.linalg.lstsq(a, y, rcond=None)
    pred = a @ np.array([c_block, c_iter])
    return {"ms_block": float(c_block), "ms_iter": float(c_iter),
            "block_share": [float(a[j, 0] * c_block / pred[j])
                            for j in range(len(points))]}


def load_alt(path: str):
    """The library at ``path`` with the flash backward's entry signatures,
    installed as the wrappers' ``flash_attention_bwd`` library; returns the
    library it replaced (or None)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(str(Path(path).resolve()))
    for name, argtypes in fa._BWD_SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    old = build._LIBS.get("flash_attention_bwd")
    build._LIBS["flash_attention_bwd"] = lib
    return old


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", default="256,1024,4096")
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--routes", default="wgmma_split")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--alt-lib", default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "flash_bwd_times.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    device = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    build.build_all()
    builds = [("checkout", None)]
    if args.alt_lib:
        builds.append(("alt", args.alt_lib))
    kw = {"causal": args.causal, "scale": cs.MLA_SCALE}
    from scan_bwd_times import profile_ms
    rows, fits, profiles = [], [], []
    Ss = [int(s) for s in args.S.split(",")]
    for S in Ss:
        q, k, v, do, o, lse = cs.bwd_case_inputs(
            device, torch.bfloat16, args.B, S, S, cs.MLA_HEADS, cs.MLA_DV,
            kw, seed=3)
        for lib_name, path in builds:
            old = load_alt(path) if path else None
            for route in args.routes.split(","):
                with cs.forced_route(fa, "_bwd_route", route):
                    ms = cs.cuda_time_ms(lambda: fa.flash_attention_bwd(
                        q, k, v, o, lse, do, **kw), iters=3)
                blocks, iters = work(route, args.B, S, cs.MLA_H, args.causal)
                rows.append({"lib": lib_name, "route": route, "B": args.B,
                             "S": S, "causal": args.causal, "ms": ms,
                             "blocks": blocks, "iterations": iters})
                print(f"time flash_attention_bwd ({route}, {lib_name} "
                      f"library) MLA B={args.B} S={S} causal={args.causal}: "
                      f"{ms:.6f} ms; {blocks} blocks, {iters} iterations")
                if args.profile and S == max(Ss):
                    with cs.forced_route(fa, "_bwd_route", route):
                        by_kernel = profile_ms(lambda: fa.flash_attention_bwd(
                            q, k, v, o, lse, do, **kw))
                    profiles.append({"lib": lib_name, "route": route,
                                     "S": S, "ms_by_kernel": by_kernel})
                    print(f"profile flash_attention_bwd ({route}, "
                          f"{lib_name} library) S={S}: "
                          + json.dumps(by_kernel))
            if path:
                build._LIBS["flash_attention_bwd"] = old
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for lib_name, _ in builds:
        for route in args.routes.split(","):
            pts = [(r["blocks"], r["iterations"], r["ms"]) for r in rows
                   if r["lib"] == lib_name and r["route"] == route]
            if len(pts) >= 2:
                f = {"lib": lib_name, "route": route, **fit(pts, n_sm)}
                fits.append(f)
                print(f"fit flash_attention_bwd ({route}, {lib_name} "
                      f"library): ms x {n_sm} SMs = blocks x "
                      f"{f['ms_block']:.6f} + iterations x "
                      f"{f['ms_iter']:.6f}; block share by S "
                      + json.dumps([round(x, 4) for x in f["block_share"]]))
    card = cs.card_line()
    print(card)
    result = {"card": card, "times": rows, "fits": fits,
              "profiles": profiles}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
