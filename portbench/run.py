#!/usr/bin/env python3
"""One run of one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (``--trace 0``: the cell's end-to-end metrics; ``--trace
1``: its per-layer metrics from a profiled window), and each number that
decides ``correct`` beside its limit as the last lines of standard error.
Exits non-zero, with no result, where the card (or the cards the cell
asks for) is missing or JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# every build and kernel cache of the program inside the checkout, at fixed
# paths, so that only a cell's first run in a checkout builds (the port's
# own kernels build into build/kernels/ of the checkout)
CACHE = ROOT / "build" / "portbench"
CACHE_ENV = {"REPRO_TORCH_AUTOTUNE_CACHE": CACHE / "autotune.json",
             "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "TRITON_CACHE_DIR": CACHE / "triton",
             "TORCHINDUCTOR_CACHE_DIR": CACHE / "inductor"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from benchkit import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
