"""Serving CLI: requests through the ServingEngine with an AI-tax
report (counterpart of ``repro.launch.serve``).

On the card, at full width in the config's dtype (bf16 for llama3-8b
and rwkv6-3b), with random weights drawn on the card from seed 0:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b

On the CPU, the float32 smoke config, as the reference's ``--smoke``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --smoke --device cpu --requests 8 --max-tokens 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=96)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    model = Model(cfg, device=args.device)
    params = model.init(seed=0)
    eng = ServingEngine(model, params, batch_slots=args.slots,
                        cache_len=args.cache_len)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        eng.submit(Request(rid,
                           rng.integers(0, cfg.vocab_size, args.prompt_len),
                           max_tokens=args.max_tokens))
    t0 = time.perf_counter()
    done = eng.run()
    secs = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    print(f"{cfg.name} ({cfg.dtype}) on {where}: served {len(done)} "
          f"requests ({sum(len(r.tokens) for r in done)} tokens) "
          f"in {secs:.3f} s")
    rep = eng.tax_report()
    print(f"AI fraction {rep['ai_fraction']:.1%}  "
          f"tax {rep['tax_fraction']:.1%}  d2h syncs {eng.d2h_syncs} "
          f"({eng.d2h_bytes} bytes)")
    for stage, v in sorted(rep["per_stage"].items()):
        print(f"  {stage:<10} {v*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
