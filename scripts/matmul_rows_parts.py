#!/usr/bin/env python3
"""Where the matmul's rows kernel spends its time, from builds of
``csrc/matmul.cu`` with a step compiled out, on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 scripts/matmul_rows_parts.py [--M 64,16] [--clusters 6,4,3]

Each variant is the checkout's source with one edit, built by nvcc into
``build/matmul_parts/<variant>/`` and loaded in place of the wrappers'
library for its timings (the checkout's own build is not touched):

  * ``base``: the source as it is;
  * ``nocompute``: every pass skips its FMAs (the copies, their waits and
    the barriers stay);
  * ``nocopy``: the ring's copies after the first stages are not issued
    (the FMAs run on what the first stages loaded);
  * ``nocompute_nocopy``: both (what is left: launch, the first stages,
    the passes' waits and barriers, the cluster's sum).

Only ``base`` computes the product; the others are timings, not results.
At the cluster's first product, (M, 6912) @ (6912, 256) + tanh, for every
M and every cluster size given (the K chunk split evenly, a multiple of
4), each variant is timed by CUDA-graph replay (median of 5 replays of 50
calls). One line a time, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# the lines of matmul_rows_kernel's pass loop that the variants edit
PASS_FMAS = "    const float* As = ring + (p % R_STAGES) * S::STAGE;"
PASS_COPIES = """    if (pn < n_pass)
      rows_stage<MT, VEC>(ring + (pn % R_STAGES) * S::STAGE, a, b, M, N, K,
                          k_begin + pn * R_KT, k_end, col0, tid);"""


def variants(src: str) -> dict[str, str]:
    if PASS_FMAS not in src or PASS_COPIES not in src:
        raise SystemExit("matmul_rows_parts: the pass loop's lines moved")
    skip = "    if (k_chunk >= 0) continue;\n"
    return {"base": src,
            "nocompute": src.replace(PASS_FMAS, skip + PASS_FMAS),
            "nocopy": src.replace(PASS_COPIES, ""),
            "nocompute_nocopy": src.replace(PASS_FMAS, skip + PASS_FMAS)
                                   .replace(PASS_COPIES, "")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", default="64,16")
    ap.add_argument("--clusters", default="6,4,3")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("matmul_rows_parts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import matmul as mm
    out = ROOT / "build" / "matmul_parts"
    nvcc = build._nvcc()
    procs = {}
    for name, text in variants((build.CSRC / "matmul.cu").read_text()).items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "matmul.cu").write_text(text)
        for h in build.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [a for a in build.nvcc_command(nvcc, d / "matmul.cu", d / "lib.so")
               if a not in ("-Xptxas", "-v")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"matmul_rows_parts: {name} failed\n{log[-3000:]}",
                  file=sys.stderr)
            return 1
    autotune.set_cache(autotune.AutotuneCache(path=cs.AUTOTUNE_OVERLAY))
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    K, N = 48 * 48 * 3, 256
    for M in (int(m) for m in args.M.split(",")):
        a, b, _ = cs.matmul_inputs(M, K, N, False, device)
        for name in procs:
            lib = ctypes.CDLL(str(out / name / "lib.so"))
            for fn, argtypes in mm._SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            build._LIBS["matmul"] = lib
            for c in (int(x) for x in args.clusters.split(",")):
                chunk = -(-K // c)
                chunk += -chunk % 4
                plan = {"cluster": -(-K // chunk), "k_chunk": chunk}
                ms = cs.cuda_time_ms(lambda: mm.matmul(a, b, epilogue="tanh",
                                                       plan=plan), iters=50)
                print(f"parts matmul rows ({M},{K})@({K},{N}) tanh {name} "
                      f"plan {plan}: {ms:.6f} ms")
    build._LIBS.pop("matmul", None)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
