"""Multi-pod dry run: count every (arch x shape x mesh) cell on a fake mesh
(counterpart of ``repro.launch.dryrun``).

For each cell this shows that the distribution config is coherent on the
production mesh (every op finds a layout under DTensor's propagation, the
per-device peak fits the card's memory, the collectives are issued) and
extracts the roofline terms (:mod:`repro_torch.roofline.analysis`) from a
count of one rank's step. No array is ever allocated: the process joins a
*fake* process group of 512 ranks as rank 0 (:func:`repro_torch.launch.
mesh.make_production_mesh`, created when a cell is counted, never at
import), its parameters, optimizer state, caches and batches are DTensors
of fake shards, and :func:`repro_torch.roofline.analysis.count_step` books
the local ops and the collectives DTensor issues (their bytes by kind,
priced at NVLink's rate; the fake group moves nothing). The reference
compiles with XLA and reads ``memory_analysis()``; here the per-device
peak is op_cost's peak of live bytes in eager order. GSPMD and DTensor
choose their collectives differently, so the collective bytes are
DTensor's, not XLA's.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--variant baseline]

One JSON a cell goes to ``--out`` (``build/dryrun`` by default), under the
mesh's name; a cell that raises is recorded with ``status: "error"`` and
its message. The exit code is 0 when every cell passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_config, supports_shape
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.variants import get_variant
from repro_torch.models.model import build_model
from repro_torch.roofline import analysis


def mesh_name_of(mesh) -> str:
    sizes = shd.mesh_shape(mesh)
    if tuple(sizes) == ("pod", "data", "model") and \
            tuple(sizes.values()) == (2, 16, 16):
        return "pod2x16x16"
    if tuple(sizes) == ("data", "model") and tuple(sizes.values()) == (16, 16):
        return "pod16x16"
    return "x".join(f"{k}{v}" for k, v in sizes.items())


def _apply_variant(cfg, variant):
    if not variant.model_overrides:
        return cfg
    overrides = dict(variant.model_overrides)
    cf = overrides.pop("moe_capacity_factor", None)
    if cf is not None and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               variant_name: str = "baseline", mesh=None, cfg=None,
               shape=None):
    """Returns (roofline, meta) for one cell: ``arch`` at ``shape_name`` on
    the production mesh (``multi_pod``: 2x16x16) under the variant's rules.
    ``mesh``, ``cfg`` and ``shape`` replace the production mesh, the
    arch's published config and the named shape (the tests count a smoke
    config on a small fake mesh)."""
    variant = get_variant(variant_name)
    shape = shape or SHAPES[shape_name]
    cfg = _apply_variant(cfg or get_config(arch), variant)
    model = build_model(cfg, device="cpu")
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rules = (variant.train_rules if shape.kind == "train"
             else variant.serve_rules)
    t0 = time.time()
    count = analysis.count_step(model, None, shape, shape.kind, mesh=mesh,
                                rules=rules)
    t_count = time.time() - t0
    roof = analysis.from_counted(
        arch, shape_name, mesh_name_of(mesh), mesh.size(), count.counter,
        count.lib_flops, cfg, shape, param_bytes=count.param_bytes,
        cache_bytes=count.cache_bytes)
    meta = {"t_count_s": t_count, "variant": variant_name}
    return roof, meta


def run_cell(arch, shape_name, multi_pod, variant, out_dir) -> bool:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}"
    os.makedirs(f"{out_dir}/{mesh_name}", exist_ok=True)
    path = f"{out_dir}/{mesh_name}/{tag}.json"
    if variant != "baseline":
        path = f"{out_dir}/{mesh_name}/{tag}__{variant}.json"
    try:
        roof, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                variant_name=variant)
        print(f"== {tag} [{mesh_name}] ==")
        print({"bytes_per_device": roof.bytes_per_device,
               "peak_memory_ok": roof.peak_memory_ok})   # shows it fits
        print({"flops": roof.hlo_flops, "bytes accessed": roof.hlo_bytes,
               "collectives": roof.coll_breakdown})
        rec = roof.to_dict()
        rec.update(meta)
        rec["status"] = "ok"
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"OK {tag} flops/chip={roof.hlo_flops:.3e} "
              f"coll={roof.coll_bytes:.3e}B bottleneck={roof.bottleneck} "
              f"frac={roof.roofline_fraction:.3f} "
              f"peak={roof.bytes_per_device / 1e9:.2f}GB "
              f"(count {meta['t_count_s']:.1f}s)", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 — record and continue
        traceback.print_exc()
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "status": "error", "variant": variant,
                       "error": f"{type(e).__name__}: {e}"}, f, indent=1)
        print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape_name in SHAPES:
                cfg = get_config(arch)
                if not supports_shape(cfg, shape_name):
                    print(f"SKIP {arch}__{shape_name} (documented: needs "
                          "sub-quadratic attention)")
                    continue
                cells.append((arch, shape_name))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    make_production_mesh(multi_pod=args.multi_pod)   # the fake group
    ok = 0
    for arch, shape_name in cells:
        ok += run_cell(arch, shape_name, args.multi_pod, args.variant,
                       args.out)
    print(f"dry-run: {ok}/{len(cells)} cells passed")
    sys.exit(0 if ok == len(cells) else 1)


if __name__ == "__main__":
    main()
