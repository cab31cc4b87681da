#!/usr/bin/env python3
"""Device times of the flash backward's routes and the skinny matmul on
this checkout's build and on another tree's build of the same sources, in
turns on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc,
with another tree of the repo at OTHER (for instance the parent commit,
unpacked by ``git archive`` into a directory that ``.gitignore`` lists):

    python3 scripts/tree_times.py --other OTHER [--out build/tree_times.json]

OTHER's ``csrc/flash_attention_bwd.cu`` and ``csrc/matmul.cu`` (with its
headers) are built by nvcc into ``build/tree_times/`` and loaded in place
of the wrappers' libraries for its turns; everything else, the launch
plans and the routes included, is this checkout's (``compare_port_trees.py``
runs another tree's whole package instead, which needs every name a timing
function calls to exist there). Each case is timed by
CUDA-graph replay (``chip_smoke.cuda_time_ms``) in the order other, this,
this, other, on the same inputs:

  * the flash backward (bf16) at gemma3-12b's training shape (the
    ``wgmma_split`` route) and at chip_smoke's ``BWD_SHAPES`` (llama3-8b,
    whisper's encoder: the ``wgmma`` route);
  * the matmul's skinny route at (8, 6912) @ (6912, 256) + tanh.

One line a case (the four times and this tree's mean over the other's),
then the card's name and power limit, then one JSON line of everything,
also written to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCES = {"flash_attention_bwd": "flash_attention_bwd.cu",
           "matmul": "matmul.cu"}


def build_other(other: Path, out: Path) -> dict[str, Path]:
    """OTHER's sources of SOURCES built into ``out``, all nvcc at once."""
    from repro_torch.kernels import build
    csrc = other / "src" / "repro_torch" / "kernels" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    nvcc, procs, libs = build._nvcc(), {}, {}
    for stem, src in SOURCES.items():
        (out / src).write_text((csrc / src).read_text())
        libs[stem] = out / f"{stem}.so"
        cmd = [a for a in build.nvcc_command(nvcc, out / src, libs[stem])
               if a not in ("-Xptxas", "-v")]
        procs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for stem, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"tree_times: {stem} of {other} failed\n"
                             f"{log[-3000:]}")
    return libs


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    """The library at ``path`` with the entries it has typed as the
    wrappers type them."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--out", default=str(ROOT / "build" / "tree_times.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tree_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    signatures = {"flash_attention_bwd": fa._BWD_SIGNATURES,
                  "matmul": mm._SIGNATURES}
    other_paths = build_other(Path(args.other).resolve(),
                              ROOT / "build" / "tree_times")
    this = {stem: build.library(stem, signatures[stem]) for stem in SOURCES}
    other = {stem: load(p, signatures[stem]) for stem, p in other_paths.items()}
    autotune.set_cache(autotune.AutotuneCache(path=cs.AUTOTUNE_OVERLAY))
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    cases = []
    label, B, Sq, Skv, heads, Dv, kw = cs.BWD_SPLIT_CASES[0]
    q, k, v, do, o, lse = cs.bwd_case_inputs(device, torch.bfloat16, B, Sq,
                                             Skv, heads, Dv, kw, seed=3)
    cases.append((f"flash_attention_bwd {label} bf16 q{tuple(q.shape)} "
                  f"k{tuple(k.shape)} {kw} "
                  f"({fa._bwd_route(q.dtype, q.shape[-1], v.shape[-1])} route)",
                  "flash_attention_bwd",
                  lambda q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw:
                  fa.flash_attention_bwd(q, k, v, o, lse, do, **kw), 3))
    for label, B, S, heads, causal in cs.BWD_SHAPES:
        q, k, v, o, lse, do = cs.bwd_inputs(B, S, heads, causal,
                                            torch.bfloat16, device)
        cases.append((f"flash_attention_bwd {label} bf16 q{tuple(q.shape)} "
                      f"kv{tuple(k.shape)} causal={causal} "
                      f"({fa._bwd_route(q.dtype, heads[2], heads[2])} route)",
                      "flash_attention_bwd",
                      lambda q=q, k=k, v=v, o=o, lse=lse, do=do, c=causal:
                      fa.flash_attention_bwd(q, k, v, o, lse, do, causal=c),
                      3))
    M, K, N = 8, 6912, 256
    a, b, _ = cs.matmul_inputs(M, K, N, False, device)
    cases.append((f"matmul ({M},{K})@({K},{N}) tanh ({mm._route(M)} route)",
                  "matmul", lambda: mm.matmul(a, b, epilogue="tanh"), 50))

    rows = []
    for name, stem, call, iters in cases:
        times = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            build._LIBS[stem] = other[stem] if which == "other" else this[stem]
            times[which].append(cs.cuda_time_ms(call, iters=iters))
        build._LIBS[stem] = this[stem]
        ratio = statistics.mean(times["this"]) / statistics.mean(times["other"])
        rows.append({"case": name, "other_ms": times["other"],
                     "this_ms": times["this"], "this_over_other": ratio})
        print(f"tree_times {name}: other {times['other'][0]:.6f} | "
              f"{times['other'][1]:.6f} ms, this {times['this'][0]:.6f} | "
              f"{times['this'][1]:.6f} ms, this / other {ratio:.4f}")
    card = cs.card_line()
    print(card)
    result = {"other": str(args.other), "card": card, "cases": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
