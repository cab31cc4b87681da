"""Launch-plan autotuner for the port's kernels, with a persistent JSON
cache (counterpart of ``repro.kernels.autotune``, which tunes the Pallas
kernels' block sizes for a TPU v5e).

The CUDA kernels fix their tiles at compile time; what a launch still
chooses is how the work is split over the card's SMs, and those are
arguments of the C entries:

  * the matmul's skinny route (M <= 8): ``(cluster, k_chunk)``, K split
    over a thread-block cluster (``matmul.skinny_plan`` is the formula);
  * its rows route (9 <= M <= 64): ``(cluster, k_chunk)`` likewise
    (``matmul.rows_plan``);
  * its tile route (M > 64): ``(splits, k_chunk)``, the split-K grid
    (``matmul.split_k``);
  * decode attention's ``n_split``, blocks along the cache
    (``decode_attention.split_l``).

The formulas stay as the anchors of the candidate spaces (each is always a
candidate). Routes and their thresholds (``matmul.SKINNY_M``,
``linear_scan.CHUNK_MIN_S``, ``linear_scan.MAMBA_SEG_MIN_S``) are not
tuned: ``chip_smoke.py``'s route gates depend on them (``matmul.ROWS_M``
too).

Two scoring modes:

* ``analytic`` — a deterministic model of each route on
  :mod:`repro_torch.roofline.hw`: a launch's overhead, the rows of K (keys
  of the cache) its blocks walk, the share of the blocks each of the SMs
  runs beyond the ones it holds at full speed, the tile route's split-K
  reduce pass and decode's combine pass, and no less than the bytes over
  HBM (the tile route's B read once per 16-row block). Its constants are
  fitted to the card's sweep (``chip_smoke.py``'s phase 12). The wrappers
  take this mode on a miss, the only one that needs no card, and the
  committed seed holds its picks;
* ``measured`` — times each candidate on the card by CUDA-graph replay
  between CUDA events (median of 5, :func:`device_time_ms`). Without a
  card, or inside a graph capture, it raises: it never falls back.

Cache layout: the committed seed (``tilings.json`` beside this file,
written by ``python -m repro_torch.kernels.autotune``) holds the analytic
picks of the hot-path battery (:func:`hot_path_battery`) for the H100's
132 SMs; a user-writable overlay (``$REPRO_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/repro_torch/autotune.json``) takes the shapes tuned at run time,
so a checkout never dirties itself. ``python -m repro_torch.kernels.
autotune --check`` asserts the seed equals the battery. A plan read from
the cache is fixed for its key for the life of the process.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import tempfile
from dataclasses import dataclass

from repro_torch.roofline import hw

# Committed seed cache: the analytic picks of the hot-path battery.
SEED_PATH = pathlib.Path(__file__).resolve().parent / "tilings.json"

# Bump when a kernel's plan constraints or a candidate space change
# incompatibly: entries stamped with an older version are ignored at load,
# so a stale overlay can never shadow a refreshed seed with plans the
# current kernels would reject.
SCHEMA_VERSION = 2

# The analytic model's constants, fitted to the H100's sweep of
# chip_smoke.py's phase 12 (every candidate plan of the battery, NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md, section 6, has the model before and after).
# The kernels are latency-bound at these shapes: a block's time grows with
# the rows of K (keys of the cache) it walks, and an SM runs a few blocks at
# once at that speed, more only by sharing it.
# matmul, skinny route (fitted to three sweeps): launch + the larger of a
# rank's rows of K (per row, and per row and row of A) and the operands'
# bytes at the rate the replayed calls stream them (above HBM's: B stays in
# the L2), + a cluster whose size is not a power of two
_SKINNY_US = 3.92
_SKINNY_ROW_US = (6.54e-4, 3.02e-4)
_SKINNY_BPS = 4.30e12
_SKINNY_ODD_US = 0.280
# rows route (fitted by scripts/fit_plan_model.py to the H100's sweep,
# scripts/plan_sweep_h100.json):
# launch + the rows of K a rank walks in its whole passes (per row, and per
# row and row of A) + the
# cluster's ranks (per rank, and per rank and row of A: the cluster's
# launch and its sum through distributed shared memory), which makes a
# smaller cluster faster at the cluster batches' rows
_ROWS_US = 3.508
_ROWS_ROW_US = (4.436e-3, 1.380e-4)
_ROWS_RANK_US = (0.0, 4.526e-3)
# tile route: launch + k_chunk x per row x the SM's share of blocks beyond
# the ones it runs at full speed; the reduce pass: a launch and its bytes
_TILE_US = 0.926
_TILE_ROW_US = 0.0741
_TILE_RESIDENT = 2.51
_REDUCE_US = 1.96
_REDUCE_BPS = 3.36e11
# decode, by route: launch + (per 64-key step: a + b D + c D G) x the
# longest row's steps a block + per wave of blocks past the resident ones,
# + decode_combine's launch
_DECODE = {"mma": dict(launch=2.30, step=(0.0, 0.0157, 0.00106),
                       resident=0.5, wave=1.04, combine=0.0),
           "simt": dict(launch=4.05, step=(0.122, 0.0191, 0.00891),
                        resident=3.64, wave=6.11, combine=5.11)}
# the mean row's share of L in a serving batch: the rows' bytes read once
# are the decode model's floor
_DECODE_FILL = 0.25
# the analytic pick leaves the formula's plan (the anchor) only for a
# predicted gain beyond this share: the model's resolution
_RESOLUTION = 0.05

_F32 = 4


def _itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[str(dtype).replace("torch.", "")]


def _bucket_m(M: int) -> int:
    """Rows bucketed to their power of two, matching the face pipeline's
    batch padding, so ragged batches share keys."""
    return 1 << (max(1, M) - 1).bit_length()


@dataclass
class TuneResult:
    plan: dict[str, int]
    score_us: float
    mode: str
    n_candidates: int

    def to_json(self) -> dict:
        return {"plan": self.plan, "score_us": round(self.score_us, 3),
                "mode": self.mode, "n_candidates": self.n_candidates,
                "v": SCHEMA_VERSION}


# --------------------------------------------------------------------------
# Cache
# --------------------------------------------------------------------------

class AutotuneCache:
    """Seed (committed, read-only) + overlay (user-writable) JSON cache."""

    def __init__(self, path: str | os.PathLike | None = None,
                 seed_path: str | os.PathLike | None = SEED_PATH):
        env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
        self.path = pathlib.Path(
            path if path is not None else
            env if env else
            pathlib.Path.home() / ".cache" / "repro_torch" / "autotune.json")
        self.seed_path = pathlib.Path(seed_path) if seed_path else None
        self._entries: dict[str, dict] | None = None

    def _load(self) -> dict[str, dict]:
        if self._entries is None:
            # lazy load may race a concurrent first lookup: both
            # threads parse the same immutable file and install
            # equivalent dicts — idempotent, worst case a wasted parse
            self._entries = {}  # lint: waive race-check -- idempotent lazy load; duplicate parse of the same file is the worst case
            for p in (self.seed_path, self.path):
                if p is not None and p.is_file():
                    try:
                        raw = json.loads(p.read_text())
                    except (json.JSONDecodeError, OSError):
                        continue  # corrupt cache == empty cache
                    self._entries.update(
                        {k: v for k, v in raw.items()
                         if isinstance(v, dict)
                         and v.get("v") == SCHEMA_VERSION})
        return self._entries

    def lookup(self, key: str) -> dict | None:
        return self._load().get(key)

    def store(self, key: str, entry: dict) -> None:
        """Memoize + persist to the overlay (never the committed seed)."""
        self._load()[key] = entry
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            on_disk = {}
            if self.path.is_file():
                try:
                    on_disk = json.loads(self.path.read_text())
                except json.JSONDecodeError:
                    pass
            on_disk[key] = entry
            fd, tmp = tempfile.mkstemp(dir=self.path.parent, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(on_disk, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only filesystem: in-process memo still works


_CACHE: AutotuneCache | None = None


def get_cache() -> AutotuneCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache()
    return _CACHE


def set_cache(cache: AutotuneCache | None) -> None:
    """Swap the process-wide cache (tests point it at a tmp path)."""
    global _CACHE
    _CACHE = cache


def _tune(key: str, anchor: dict, cands: list, score,
          cache: AutotuneCache | None, mode: str) -> dict[str, int]:
    """The cached plan for ``key``, or the best of ``cands`` by ``score``
    (lowest; ties to the first in sorted order), stored. The analytic mode
    keeps ``anchor`` (the formula's plan) unless the best scores more than
    :data:`_RESOLUTION` below it."""
    cache = cache or get_cache()
    hit = cache.lookup(key)
    if hit is not None:
        return dict(hit["plan"])
    if mode not in ("analytic", "measured"):
        raise ValueError(f"mode must be analytic or measured, got {mode!r}")
    scored = [(score(c), c) for c in cands]
    best_us, best = min(scored, key=lambda sc: (sc[0], sorted(sc[1].items())))
    anchor_us = next(us for us, c in scored if c == anchor)
    if mode == "analytic" and anchor_us <= best_us * (1 + _RESOLUTION):
        best_us, best = anchor_us, anchor
    cache.store(key, TuneResult(best, best_us, mode, len(cands)).to_json())
    return dict(best)


# --------------------------------------------------------------------------
# Measuring on the card
# --------------------------------------------------------------------------

def device_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls are captured in
    one CUDA graph after a warm-up, the graph is replayed between two CUDA
    events ``reps`` times, and the median per-call time is returned.
    Replaying leaves out the host's launch overhead."""
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


def _card():
    """The current CUDA device, or RuntimeError: measured mode needs the
    card and must not run inside a graph capture."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("measured autotuning needs a CUDA card")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("measured autotuning inside a CUDA graph capture")
    return torch.device("cuda", torch.cuda.current_device())


# --------------------------------------------------------------------------
# matmul
# --------------------------------------------------------------------------

def matmul_key(M: int, K: int, N: int, n_sm: int) -> str:
    return f"matmul/m{_bucket_m(M)}k{K}n{N}/float32/sm{n_sm}"


def matmul_formula(M: int, K: int, N: int, n_sm: int) -> dict[str, int]:
    """The plan of ``matmul.skinny_plan`` / ``rows_plan`` / ``split_k``."""
    from repro_torch.kernels import matmul as mm
    route = mm._route(M)
    if route == "skinny":
        return dict(zip(("cluster", "k_chunk"), mm.skinny_plan(N, K, n_sm)))
    if route == "rows":
        return dict(zip(("cluster", "k_chunk"), mm.rows_plan(N, K, n_sm)))
    return dict(zip(("splits", "k_chunk"), mm.split_k(M, N, K, n_sm)))


def matmul_candidates(M: int, K: int, N: int,
                      n_sm: int) -> list[dict[str, int]]:
    """The plans ``matmul.check_plan`` takes for the route of M, K split
    as evenly as the chunk allows, with the formula's plan among them:
    skinny and rows ``cluster`` 1 to MAX_CLUSTER (rows: ROWS_MAX_CLUSTER)
    and to ceil(K / _SKINNY_MIN_ROWS) (rows' ``k_chunk`` a multiple of 4);
    tile ``splits``
    1 to twice the formula's (at least 8, at most 64), ``k_chunk`` a
    multiple of the tile's K step; no empty rank or split."""
    from repro_torch.kernels import matmul as mm
    formula = matmul_formula(M, K, N, n_sm)
    plans = {tuple(formula.values())}
    route = mm._route(M)
    if route != "tile":
        names = ("cluster", "k_chunk")
        most = mm.MAX_CLUSTER if route == "skinny" else mm.ROWS_MAX_CLUSTER
        for c in range(1, min(most, -(-K // mm._SKINNY_MIN_ROWS)) + 1):
            chunk = -(-K // c)
            if route == "rows":
                chunk += -chunk % 4
            plans.add((-(-K // chunk), chunk))
    else:
        names = ("splits", "k_chunk")
        k_tiles = max(1, -(-K // mm._BK))
        for n in range(1, min(k_tiles, max(2 * formula["splits"], 8), 64) + 1):
            per = -(-k_tiles // n)
            plans.add((-(-k_tiles // per), per * mm._BK))
    return [dict(zip(names, p)) for p in sorted(plans)]


def matmul_cost_us(M: int, K: int, N: int, n_sm: int,
                   plan: dict[str, int]) -> float:
    """Analytic time of one matmul launch plan on ``n_sm`` SMs, in µs; the
    skinny and tile routes' at least their bytes (the tile route's over HBM:
    B read once per 16-row block, the partial sums written and read back)."""
    from repro_torch.kernels import matmul as mm
    route = mm._route(M)
    if route == "rows":
        cluster, chunk = plan["cluster"], plan["k_chunk"]
        walked = mm.ROWS_PASS * -(-chunk // mm.ROWS_PASS)
        return (_ROWS_US + walked * (_ROWS_ROW_US[0] + M * _ROWS_ROW_US[1])
                + cluster * (_ROWS_RANK_US[0] + M * _ROWS_RANK_US[1]))
    if route == "skinny":
        cluster, chunk = plan["cluster"], plan["k_chunk"]
        rows_us = chunk * (_SKINNY_ROW_US[0] + M * _SKINNY_ROW_US[1])
        bytes_us = (M * K + K * N + M * N) * _F32 / _SKINNY_BPS * 1e6
        return (_SKINNY_US + max(rows_us, bytes_us)
                + (cluster & (cluster - 1) != 0) * _SKINNY_ODD_US)
    splits, chunk = plan["splits"], plan["k_chunk"]
    rows = -(-M // mm._BM)
    blocks = rows * -(-N // mm._BN) * splits
    t = _TILE_US + chunk * _TILE_ROW_US * max(
        1.0, blocks / (n_sm * _TILE_RESIDENT))
    partial = splits * M * N * _F32 if splits > 1 else 0
    if splits > 1:
        t += _REDUCE_US + partial / _REDUCE_BPS * 1e6
    hbm = (rows * K * N + M * K * -(-N // mm._BN) + M * N) * _F32 + 2 * partial
    return max(t, hbm / hw.HBM_BW * 1e6)


def _measure_matmul(M: int, K: int, N: int, plan: dict[str, int]) -> float:
    import torch

    from repro_torch.kernels import matmul as mm
    device = _card()
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((M, K), generator=gen, device=device)
    b = torch.randn((K, N), generator=gen, device=device)
    return device_time_ms(lambda: mm.matmul(a, b, plan=plan)) * 1e3


def matmul_plan(M: int, K: int, N: int, n_sm: int, *,
                cache: AutotuneCache | None = None,
                mode: str = "analytic") -> dict[str, int]:
    """The launch plan for an (M, K) @ (K, N) on ``n_sm`` SMs: skinny and
    rows ``{"cluster", "k_chunk"}`` for M <= 64, tile ``{"splits",
    "k_chunk"}`` above; tunes on a cache miss (at M's bucket)."""
    Mb = _bucket_m(M)
    if mode == "measured":
        def score(c):
            return _measure_matmul(Mb, K, N, c)
    else:
        def score(c):
            return matmul_cost_us(Mb, K, N, n_sm, c)
    return _tune(matmul_key(M, K, N, n_sm), matmul_formula(Mb, K, N, n_sm),
                 matmul_candidates(Mb, K, N, n_sm), score, cache, mode)


# --------------------------------------------------------------------------
# decode attention
# --------------------------------------------------------------------------

def decode_key(B: int, KV: int, G: int, D: int, Dv: int, L: int, dtype: str,
               n_sm: int) -> str:
    return (f"decode/bkv{B * KV}g{G}d{D}v{Dv}l{L}/"
            f"{str(dtype).replace('torch.', '')}/sm{n_sm}")


def decode_candidates(L: int) -> list[dict[str, int]]:
    """``n_split`` from 1 to ceil(L / 128): at least 128 cache entries a
    block (the formula's floor, ``decode_attention.split_l``)."""
    return [{"n_split": n} for n in range(1, max(1, -(-L // 128)) + 1)]


def decode_cost_us(B: int, KV: int, G: int, D: int, Dv: int, L: int,
                   dtype: str, n_sm: int, plan: dict[str, int]) -> float:
    """Analytic time of one decode launch plan, in µs, for rows as the
    serving engine fills them: the longest at L, whose blocks walk their
    chunk 64 keys a step (16 a warp), behind the waves of blocks past what
    the SMs hold, plus the combine pass; at least the rows' keys (a
    quarter of L on average) over HBM."""
    import torch

    from repro_torch.kernels import decode_attention as da
    n = plan["n_split"]
    m = _DECODE[da._route(getattr(torch, str(dtype).replace("torch.", "")),
                          G, D, Dv)]
    a, b, c = m["step"]
    steps = -(-(-(-L // n)) // 64)
    t = (m["launch"] + (a + b * D + c * D * G) * steps
         + m["wave"] * max(0.0, B * KV * n / (n_sm * m["resident"]) - 1))
    if n > 1:
        t += m["combine"]
    read = B * L * _DECODE_FILL * KV * (D + Dv) * _itemsize(dtype)
    return max(t, read / hw.HBM_BW * 1e6)


def _measure_decode(B, KV, G, D, Dv, L, dtype, plan) -> float:
    import torch

    from repro_torch.kernels import decode_attention as da
    device = _card()
    dt = getattr(torch, str(dtype).replace("torch.", ""))
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((B, 1, KV * G, D), generator=gen, device=device).to(dt)
    k = torch.randn((B, L, KV, D), generator=gen, device=device).to(dt)
    v = torch.randn((B, L, KV, Dv), generator=gen, device=device).to(dt)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    return device_time_ms(lambda: da.decode_attention(
        q, k, v, kv_len=lens, plan=plan)) * 1e3


def decode_plan(B: int, KV: int, G: int, D: int, Dv: int, L: int,
                dtype: str, n_sm: int, *, cache: AutotuneCache | None = None,
                mode: str = "analytic") -> dict[str, int]:
    """``{"n_split"}`` for a decode of B rows x KV kv heads x G query heads
    against a cache of L; tunes on a miss (measured: every row full)."""
    from repro_torch.kernels.decode_attention import split_l
    if mode == "measured":
        def score(c):
            return _measure_decode(B, KV, G, D, Dv, L, dtype, c)
    else:
        def score(c):
            return decode_cost_us(B, KV, G, D, Dv, L, dtype, n_sm, c)
    anchor = {"n_split": split_l(B, KV, L, n_sm)}
    return _tune(decode_key(B, KV, G, D, Dv, L, dtype, n_sm), anchor,
                 decode_candidates(L), score, cache, mode)


# --------------------------------------------------------------------------
# Battery: the shapes chip_smoke.py and the served configs launch
# --------------------------------------------------------------------------

# (K, N) of the face path's products: the fused identify's layer 1 (a
# 48x48x3 crop), the embedder's layer 2, the unfused embedder's layer 1 (a
# 32x32x3 thumbnail); M: the identify batches (1, 3 -> 4, 8), the skinny
# checks' 2, the cluster's replica batches (16-64) and the reference
# battery's 64 and 512
MATMUL_BATTERY = [(m, k, n) for k, n in ((6912, 256), (256, 128), (3072, 256))
                  for m in (1, 2, 4, 8, 16, 32, 64, 512)]
# (B, KV, G, D, L) of the served configs' decode at 8 slots: whisper
# (MHA, cache 448), gemma3-12b (global 2048, windowed 1024), granite,
# llama3-8b and jamba, qwen2.5-14b, chameleon-34b and qwen1.5-110b
DECODE_BATTERY = [(8, 20, 1, 64, 448), (8, 8, 2, 256, 2048),
                  (8, 8, 2, 256, 1024), (8, 8, 3, 64, 2048),
                  (8, 8, 4, 128, 2048), (8, 8, 5, 128, 2048),
                  (8, 8, 8, 128, 2048)]
DECODE_DTYPES = ("bfloat16", "float32")


def hot_path_battery() -> dict[str, dict]:
    """key -> entry of every battery shape tuned analytically for the
    H100's SMs: the committed seed. Deterministic, so ``--check`` can
    compare it with the committed file."""
    n_sm = hw.SM_COUNT
    with tempfile.TemporaryDirectory() as tmp:
        scratch = AutotuneCache(path=pathlib.Path(tmp) / "battery.json",
                                seed_path=None)
        for M, K, N in MATMUL_BATTERY:
            matmul_plan(M, K, N, n_sm, cache=scratch)
        for B, KV, G, D, L in DECODE_BATTERY:
            for dtype in DECODE_DTYPES:
                decode_plan(B, KV, G, D, D, L, dtype, n_sm, cache=scratch)
        return dict(scratch._load())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the committed seed of analytic launch plans "
                    "(or, with --check, compare it with the battery).")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if the seed differs from the battery")
    args = ap.parse_args(argv)
    swept = hot_path_battery()
    if args.check:
        committed = (json.loads(SEED_PATH.read_text())
                     if SEED_PATH.is_file() else {})
        want = {k: v["plan"] for k, v in swept.items()}
        have = {k: v.get("plan") for k, v in committed.items()}
        if have != want:
            diff = sorted(k for k in set(want) | set(have)
                          if want.get(k) != have.get(k))
            print(f"autotune: seed out of date at {len(diff)} keys: "
                  + ", ".join(diff[:8]), file=sys.stderr)
            return 1
        print(f"autotune: seed matches the battery ({len(want)} plans)")
        return 0
    SEED_PATH.write_text(json.dumps(swept, indent=1, sort_keys=True) + "\n")
    print(f"autotune: wrote {len(swept)} plans to {SEED_PATH.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
