"""Serving CLI: requests through the ServingEngine with an AI-tax
report (counterpart of ``repro.launch.serve``).

On the card, at full width and depth in the config's dtype (bf16 for
every ported arch: llama3-8b, qwen2.5-14b, chameleon-34b, jamba-v0.1-52b,
rwkv6-3b, granite-moe-3b-a800m), with random weights drawn on the card
from seed 0:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b

Before it draws anything it checks that the weights and the decode cache
fit in the card's free memory, and raises ``MemoryError`` naming both
numbers where they do not: jamba-v0.1-52b's published 32 layers are
103.1 GB of bf16 weights, more than one 80 GB card holds (``chip_smoke.py``
serves it at a reduced depth).

On the CPU, the float32 smoke config, as the reference's ``--smoke``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
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


def check_fits(model: Model, slots: int, cache_len: int,
               free_bytes: int) -> None:
    """Raise ``MemoryError`` unless ``model``'s weights and a decode cache of
    ``slots`` rows by ``cache_len`` fit in ``free_bytes`` (activations not
    counted)."""
    weights = model.weight_bytes()
    cache = model.cache_bytes(slots, cache_len)
    if weights + cache > free_bytes:
        raise MemoryError(
            f"{model.cfg.name} ({model.cfg.n_layers} layers, {model.cfg.dtype})"
            f" needs {weights:,} bytes of weights and {cache:,} bytes of "
            f"decode cache; the device has {free_bytes:,} bytes free")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a ported arch (repro_torch.configs.list_configs()): "
                    "llama3-8b, qwen2.5-14b, chameleon-34b, jamba-v0.1-52b, "
                    "rwkv6-3b, granite-moe-3b-a800m")
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
    if model.device.type == "cuda":
        check_fits(model, args.slots, args.cache_len,
                   torch.cuda.mem_get_info(model.device)[0])
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
