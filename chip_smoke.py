#!/usr/bin/env python3
"""Build, check, run and time the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a), in parallel;
  2. hold each kernel against its plain PyTorch version on the card, at
     the face path's shapes and at ragged ones (YUV decode exactly);
  3. run the face-recognition StreamingPipeline on the card at the paper's
     1080p source, fused and unfused identify, with every launch counter
     set to 0 just before each run and read just after, and check its
     detections and identities against the same pipeline on the CPU
     (plain versions);
  4. time each kernel, its plain version and the matching PyTorch library
     call with CUDA events, beside the least time the card could take.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks at a 700 W power limit (NVIDIA data sheet): HBM3 bytes/s
# and fp32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12

MATMUL_ATOL, MATMUL_RTOL = 1e-4, 1e-5
LETTERBOX_ATOL = 1e-3
RESIZE_ATOL = 1e-4

# 1080p source, as the paper's (repro/data/video.py), resized 2:1 for detection
SRC_H, SRC_W = 1080, 1920
# identify batches on the face path are pow2-bucketed and at most batch_size
FACE_BATCHES = (1, 3, 8)
# (K, N, epilogue) of the path's three products: fused layer 1, layer 2,
# and the unfused Embedder's layer 1
MATMUL_SHAPES = ((48 * 48 * 3, 256, "tanh"), (256, 128, "none"),
                 (32 * 32 * 3, 256, "none"))


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls are captured in one CUDA
    graph after a warm-up, the graph is replayed between two CUDA events
    ``reps`` times, and the median per-call time is returned. Replaying
    leaves out the host's launch overhead (see :func:`eager_time_ms`)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def eager_time_ms(fn, iters: int = 200) -> float:
    """Time per call of back-to-back eager calls, between CUDA events: the
    larger of the device time and the host's cost of one call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# Inputs at the path's shapes (seeded on the host, then moved)
# --------------------------------------------------------------------------

def _gen(seed: int):
    import torch
    return torch.Generator().manual_seed(seed)


def matmul_inputs(M, K, N, bias, device, seed=0):
    import torch
    g = _gen(seed)
    a = torch.randn((M, K), generator=g).to(device)
    b = (torch.randn((K, N), generator=g) / K**0.5).to(device)
    c = torch.randn((N,), generator=g).to(device) if bias else None
    return a, b, c


def all_yuv_triples(device):
    """Every (y, u, v) triple once, as one planar 4096 x 4096 frame."""
    import torch
    idx = torch.arange(1 << 24, device=device, dtype=torch.int32)
    planes = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255])
    return planes.to(torch.uint8).reshape(1, 3, 4096, 4096)


def letterbox_inputs(H, W, out_h, out_w, device, seed=0):
    import numpy as np
    import torch
    from repro_torch.preprocess import host
    g = _gen(seed)
    planes = torch.randint(0, 256, (3, H, W), generator=g,
                           dtype=torch.uint8).to(device)
    ly, lx = host.embedded_interp_matrices(H, W, out_h, out_w)
    sb = torch.stack([torch.rand(3, generator=g) + 0.5,
                      torch.randn(3, generator=g)], dim=1)
    return (planes, torch.from_numpy(np.array(ly)).to(device),
            torch.from_numpy(np.array(lx)).to(device), sb.to(device),
            host.letterbox_geometry(H, W, out_h, out_w))


def resize_inputs(N, H, W, device, seed=0):
    import torch
    return (torch.rand((N, H, W, 3), generator=_gen(seed)) * 255).to(device)


# --------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on the card
# --------------------------------------------------------------------------

def check_kernels(device) -> dict[str, float]:
    """Max abs error per kernel over its checks; raises on a disagreement."""
    import torch
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc, resize
    err = {}

    worst = 0.0
    cases = [(B, K, N, epi, False) for K, N, epi in MATMUL_SHAPES
             for B in FACE_BATCHES]
    # ragged, and the epilogue once across K splits (first) and fused
    # into a single split (second)
    cases += [(13, 200, 37, "tanh", True), (8, 48 * 48 * 3, 256, "tanh", True),
              (2048, 256, 256, "tanh", True)]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for M, K, N, epi, bias in cases:
        a, b, c = matmul_inputs(M, K, N, bias, device)
        got = mm.matmul(a, b, bias=c, epilogue=epi)
        want = mm.matmul_plain(a, b, bias=c, epilogue=epi)
        e = (got - want).abs().max().item()
        splits = mm.split_k(M, N, K, n_sm)[0]
        print(f"check matmul ({M},{K})@({K},{N}) bias={bias} {epi} "
              f"splits={splits}: max_abs_err={e:.3e}")
        require(torch.allclose(got, want, atol=MATMUL_ATOL, rtol=MATMUL_RTOL),
                f"matmul ({M},{K},{N}) disagrees: {e}")
        worst = max(worst, e)
    require(mm.split_k(8, 256, 48 * 48 * 3, n_sm)[0] > 1
            and mm.split_k(2048, 256, 256, n_sm)[0] == 1,
            "the epilogue checks must cover a split and an unsplit K")
    err["matmul"] = worst

    yuv = all_yuv_triples(device)
    got, want = preproc.yuv_to_rgb(yuv), preproc.yuv_to_rgb_plain(yuv)
    n_bad = int((got != want).sum().item())
    print(f"check yuv_to_rgb all 2^24 triples: {n_bad} channel values differ")
    require(n_bad == 0, f"yuv_to_rgb differs on {n_bad} values")
    err["yuv_to_rgb"] = float((got.int() - want.int()).abs().max().item())

    worst = 0.0
    for H, W, oh, ow, pad in ((SRC_H, SRC_W, SRC_H // 2, SRC_W // 2, 0.0),
                              (216, 384, 108, 192, 0.0),
                              (SRC_H, SRC_W, 512, 512, -1.0)):
        planes, ly, lx, sb, geom = letterbox_inputs(H, W, oh, ow, device)
        got = preproc.letterbox_normalize(planes, ly, lx, sb, geom,
                                          pad_value=pad)
        want = preproc.letterbox_normalize_plain(planes, ly, lx, sb, geom,
                                                 pad_value=pad)
        e = (got - want).abs().max().item()
        print(f"check letterbox_normalize {H}x{W}->{oh}x{ow} pad={pad}: "
              f"max_abs_err={e:.3e}")
        require(e <= LETTERBOX_ATOL, f"letterbox {H}x{W}->{oh}x{ow}: {e}")
        worst = max(worst, e)
    err["letterbox_normalize"] = worst

    worst = 0.0
    for N, H, W, oh, ow in ((8, 48, 48, 32, 32), (3, 50, 70, 21, 33)):
        img = resize_inputs(N, H, W, device)
        got = resize.resize_bilinear(img, oh, ow)
        want = resize.resize_bilinear_plain(img, oh, ow)
        e = (got - want).abs().max().item()
        print(f"check resize_bilinear ({N},{H},{W},3)->({oh},{ow}): "
              f"max_abs_err={e:.3e}")
        require(e <= RESIZE_ATOL, f"resize ({N},{H},{W})->({oh},{ow}): {e}")
        worst = max(worst, e)
    err["resize_bilinear"] = worst
    torch.cuda.synchronize()
    return err


# --------------------------------------------------------------------------
# Phase 3: the pipeline on the card, against the same pipeline on the CPU
# --------------------------------------------------------------------------

def run_pipeline(device, fast_path: bool, *, n_frames: int, src_hw,
                 wrappers=()):
    """One pipeline run; returns (result, seconds, launches per wrapper),
    the counts set to 0 just before ``run()`` and read just after."""
    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.video import VideoStream
    import torch
    pipe = StreamingPipeline(device=device, placement="device", batch_size=8,
                             n_frames=n_frames, seed=0, fast_path=fast_path)
    pipe.video = VideoStream(height=src_hw[0], width=src_hw[1], seed=0)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    res = pipe.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, secs, {w: w.launches for w in wrappers}


def identities(res) -> list:
    return sorted((rid, name) for rid, name, _ in res.identities)


def check_pipeline(device, kernels, *, n_frames: int, src_hw) -> dict:
    """Fused and unfused runs on ``device`` and on the CPU; returns the
    launch totals per kernel name and the per-run summaries."""
    wrappers = [k["wrapper"] for k in kernels]
    # warm-up: CUDA context, kernel libraries and caches, outside any count
    run_pipeline(device, True, n_frames=2, src_hw=src_hw)
    totals = dict.fromkeys((k["name"] for k in kernels), 0)
    runs = {}
    for fast in (True, False):
        res, secs, launches = run_pipeline(device, fast, n_frames=n_frames,
                                           src_hw=src_hw, wrappers=wrappers)
        ref, ref_secs, _ = run_pipeline("cpu", fast, n_frames=n_frames,
                                        src_hw=src_hw)
        fr = res.ai_tax()["fractions"]
        label = "fused" if fast else "unfused"
        counts = {k["name"]: launches[k["wrapper"]] for k in kernels}
        print(f"pipeline {label}: {n_frames} frames in {secs:.3f} s "
              f"({n_frames / secs:.2f} frames/s; cpu plain {ref_secs:.3f} s); "
              f"detected={res.detected} gt={res.ground_truth} "
              f"matched={res.matched} identities={len(res.identities)}; "
              f"launches={counts}; five-way="
              + json.dumps({k: round(v, 4) for k, v in fr.items()}))
        print(f"pipeline {label} stage means (ms): " + json.dumps(
            {s: round(v * 1e3, 4) for s, v in
             sorted(res.log.breakdown().items())}))
        require(abs(sum(fr.values()) - 1.0) < 1e-9,
                f"{label}: five-way split sums to {sum(fr.values())}")
        require(res.detected > 0 and len(res.identities) == res.detected,
                f"{label}: {res.detected} detections, "
                f"{len(res.identities)} identities")
        require((res.detected, res.ground_truth, res.matched)
                == (ref.detected, ref.ground_truth, ref.matched),
                f"{label}: card {(res.detected, res.ground_truth, res.matched)}"
                f" vs cpu {(ref.detected, ref.ground_truth, ref.matched)}")
        require(identities(res) == identities(ref),
                f"{label}: identities differ between the card and the cpu")
        used = ({"matmul", "yuv_to_rgb", "letterbox_normalize"}
                | (set() if fast else {"resize_bilinear"}))
        for name in used:
            require(counts[name] > 0, f"{label}: {name} never launched")
        for name, n in counts.items():
            totals[name] += n
        runs[label] = {"res": res, "secs": secs, "fractions": fr}
    require(identities(runs["fused"]["res"])
            == identities(runs["unfused"]["res"]),
            "fused and unfused identify disagree")
    for name, n in totals.items():
        require(n > 0, f"{name} was not launched on the main path")
    return {"launches": totals, "runs": runs}


# --------------------------------------------------------------------------
# Phase 4: times
# --------------------------------------------------------------------------

def _timed(name: str, shape: str, kernel, plain, library, nbytes: float,
           flops: float, iters: int) -> dict:
    """Device times of kernel, plain version and library call (ms), the
    kernel's eager per-call time, and the bound for this work."""
    t = {"ms": cuda_time_ms(kernel, iters=iters),
         "plain_ms": cuda_time_ms(plain, iters=iters),
         "library_ms": (None if library is None
                        else cuda_time_ms(library, iters=iters))}
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
    t["eager_ms"] = eager_time_ms(kernel, iters=10 * iters)
    print(f"time {name} {shape}: " + json.dumps(t))
    return t


def time_kernels(device) -> dict[str, dict]:
    """Times at the path's shapes; the first shape of each kernel is the
    one reported in the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc, resize
    out = {}

    for K, N, epi in MATMUL_SHAPES:
        for M in FACE_BATCHES[::-1]:
            a, b, _ = matmul_inputs(M, K, N, False, device)
            library = ((lambda: torch.tanh(torch.matmul(a, b)))
                       if epi == "tanh" else (lambda: torch.matmul(a, b)))
            t = _timed("matmul", f"({M},{K})@({K},{N}) {epi}",
                       lambda: mm.matmul(a, b, epilogue=epi),
                       lambda: mm.matmul_plain(a, b, epilogue=epi), library,
                       4 * (M * K + K * N + M * N), 2 * M * N * K, iters=50)
            out.setdefault("matmul", t)

    yuv = torch.randint(0, 256, (1, 3, SRC_H, SRC_W), generator=_gen(1),
                        dtype=torch.uint8).to(device)
    # ~20 operations a pixel: 2 centrings, 4 fmas, 3 roundings, 6 clamps
    out["yuv_to_rgb"] = _timed(
        "yuv_to_rgb", f"(1,3,{SRC_H},{SRC_W})",
        lambda: preproc.yuv_to_rgb(yuv), lambda: preproc.yuv_to_rgb_plain(yuv),
        None, 2 * yuv.numel(), 20 * SRC_H * SRC_W, iters=20)

    oh, ow = SRC_H // 2, SRC_W // 2
    planes, ly, lx, sb, geom = letterbox_inputs(SRC_H, SRC_W, oh, ow, device)
    planes_f = planes.float()     # einsum takes one dtype; cast not timed
    nb = planes.shape[0]
    out["letterbox_normalize"] = _timed(
        "letterbox_normalize", f"(3,{SRC_H},{SRC_W})->(3,{oh},{ow})",
        lambda: preproc.letterbox_normalize(planes, ly, lx, sb, geom),
        lambda: preproc.letterbox_normalize_plain(planes, ly, lx, sb, geom),
        lambda: torch.einsum("oh,nhw,pw->nop", ly, planes_f, lx),
        planes.numel() + 4 * (ly.numel() + lx.numel() + sb.numel()
                              + nb * oh * ow),
        nb * (2 * oh * SRC_H * SRC_W + 2 * oh * SRC_W * ow), iters=5)

    img = resize_inputs(8, 48, 48, device)
    ry, rx = resize._operators(32, 32, 48, 48, str(img.device))
    out["resize_bilinear"] = _timed(
        "resize_bilinear", "(8,48,48,3)->(8,32,32,3)",
        lambda: resize.resize_bilinear(img, 32, 32),
        lambda: resize.resize_bilinear_plain(img, 32, 32),
        lambda: F.interpolate(img.permute(0, 3, 1, 2), size=(32, 32),
                              mode="bilinear", align_corners=False),
        4 * (img.numel() + ry.numel() + rx.numel() + 8 * 32 * 32 * 3),
        8 * 3 * (2 * 32 * 48 * 48 + 2 * 32 * 48 * 32), iters=50)
    return out


def profile_pipeline(device, *, n_frames: int, src_hw) -> None:
    """Where one fused run's time goes: the synthetic camera's cost per
    frame on the host, and the device's busy share of the run's wall time
    (kernel time summed by torch.profiler)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.video import VideoStream
    from repro_torch.preprocess import host
    video = VideoStream(height=src_hw[0], width=src_hw[1], seed=1)
    t0 = time.perf_counter()
    for _ in range(4):
        host.rgb_to_yuv(np.asarray(video.next_frame().pixels))
    camera_ms = (time.perf_counter() - t0) / 4 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _res, secs, _ = run_pipeline(device, True, n_frames=n_frames,
                                     src_hw=src_hw)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    print(f"profile fused pipeline: camera frame + encode {camera_ms:.1f} ms "
          f"on the host; wall {secs:.3f} s; device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / secs:.5f} of the wall")
    for e in top[:8]:
        print(f"profile device time {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}: {e.key[:90]}")


def kernel_table():
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import preproc, resize
    csrc = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "matmul", "wrapper": mm.matmul, "source": csrc + "matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:106"},
        {"name": "yuv_to_rgb", "wrapper": preproc.yuv_to_rgb,
         "source": csrc + "preproc.cu",
         "replaces": "src/repro/kernels/preproc.py:56"},
        {"name": "letterbox_normalize", "wrapper": preproc.letterbox_normalize,
         "source": csrc + "preproc.cu",
         "replaces": "src/repro/kernels/preproc.py:111"},
        {"name": "resize_bilinear", "wrapper": resize.resize_bilinear,
         "source": csrc + "resize.cu",
         "replaces": "src/repro/kernels/resize.py:65"},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {sorted(build.BUILD_LOG) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for stem, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}")

    kernels = kernel_table()
    errors = check_kernels(device)
    path = check_pipeline(device, kernels, n_frames=16, src_hw=(SRC_H, SRC_W))
    times = time_kernels(device)
    profile_pipeline(device, n_frames=16, src_hw=(SRC_H, SRC_W))

    rows = []
    for k in kernels:
        t = times[k["name"]]
        rows.append({"name": k["name"], "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"],
                     "launches": path["launches"][k["name"]],
                     "max_abs_err": errors[k["name"]], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(card)        # as nvidia-smi reports it: name, power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
