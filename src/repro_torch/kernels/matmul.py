"""fp32 matmul with a fused bias + tanh epilogue: CUDA kernels and plain
version.

Counterpart of ``repro.kernels.matmul`` (the Pallas TPU kernel). The
kernels are in ``csrc/matmul.cu``; its source note says what bounds them
on an H100. Three routes, chosen by the row count (:func:`_route`): the
face batches (M <= 8) take the skinny kernel, one launch that splits K over
a thread-block cluster (:func:`skinny_plan`) and sums the splits through
distributed shared memory; the serving cluster's replica batches (9 to 64
rows) the rows kernel, the same structure with a register tile of rows x 4
columns a thread (:func:`rows_plan`); larger M takes the tiled kernel,
whose K split (:func:`split_k`) sums in a second launch. How K is split is the launch
plan: a CUDA call takes it from :mod:`repro_torch.kernels.autotune`'s cache
(the formulas are its candidates' anchors), or from the caller, and
:func:`check_plan` refuses one the kernel would not take. :func:`matmul`
launches a kernel for a CUDA tensor and takes :func:`matmul_plain` only for
a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import autotune, build

EPILOGUES = ("none", "tanh")
_BM, _BN, _BK = 16, 64, 32        # the tile route's tile (csrc/matmul.cu)
SKINNY_M = 8                      # the most rows the skinny route takes
_SN = 16                          # the skinny route's columns a block
MAX_CLUSTER = 8                   # blocks a cluster: the portable limit
_SKINNY_MIN_ROWS = 32             # K rows a cluster rank reads at least
ROWS_M = 64                       # the most rows the rows route takes
_RN = 16                          # the rows route's columns a block
# the rows route's largest cluster: at the cluster batches' K of 3,072 and
# 6,912 clusters of 7 and 8 ranks ran slower than 6 on the H100 at every M
# (fewer of them fit the card at once: phase 12's sweep of chip_smoke.py)
ROWS_MAX_CLUSTER = 6
ROWS_PASS = 64                    # K rows a pass of the rows route's ring
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
               "matmul_skinny_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _P],
               "matmul_rows_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _P]}


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 bias: torch.Tensor | None = None,
                 epilogue: str = "none") -> torch.Tensor:
    """The same function in plain PyTorch: fp32 product, then bias, then
    tanh, each once (``repro.kernels.matmul._apply_epilogue``)."""
    out = torch.matmul(a.float(), b.float())
    if bias is not None:
        out = out + bias.float()
    if epilogue == "tanh":
        out = torch.tanh(out)
    return out


def _route(M: int) -> str:
    """The kernel that takes a CUDA call with M rows: ``"skinny"`` for
    M <= 8 (the face batches), ``"rows"`` for 9 to 64 (the serving
    cluster's replica batches), ``"tile"`` above."""
    if M <= SKINNY_M:
        return "skinny"
    return "rows" if M <= ROWS_M else "tile"


def skinny_plan(N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(cluster, k_chunk) of the skinny route: the K split across a
    cluster of at most MAX_CLUSTER blocks, enough for about one block an SM
    over the ceil(N / 16) column slabs, each rank at least 32 rows of K and
    none empty: (cluster - 1) * k_chunk < K <= cluster * k_chunk. K = 0 is
    one block with nothing to read."""
    if K == 0:
        return 1, 0
    slabs = -(-N // _SN)
    want = max(1, min(MAX_CLUSTER, -(-n_sm // slabs),
                      -(-K // _SKINNY_MIN_ROWS)))
    chunk = -(-K // want)
    return -(-K // chunk), chunk


def rows_plan(N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(cluster, k_chunk) of the rows route: as :func:`skinny_plan` over
    ceil(N / 16) column slabs, up to ROWS_MAX_CLUSTER ranks, with k_chunk
    a multiple of 4 (a rank's K range starts on a 16-byte boundary of A's
    rows)."""
    if K == 0:
        return 1, 0
    slabs = -(-N // _RN)
    want = max(1, min(ROWS_MAX_CLUSTER, -(-n_sm // slabs),
                      -(-K // _SKINNY_MIN_ROWS)))
    chunk = -(-K // want)
    chunk += -chunk % 4
    return -(-K // chunk), chunk


def split_k(M: int, N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(splits, k_chunk) of the tile route: enough K splits to give every
    SM about two blocks when the output has few tiles, with no empty
    split."""
    tiles = -(-M // _BM) * -(-N // _BN)
    k_tiles = max(1, -(-K // _BK))
    want = max(1, min(k_tiles, -(-2 * n_sm // tiles)))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per * _BK


def check_plan(M: int, K: int, plan: dict) -> tuple[int, int]:
    """``plan`` as the route of M launches it: skinny and rows (cluster,
    k_chunk), cluster 1..MAX_CLUSTER (rows: ROWS_MAX_CLUSTER) and at most
    ceil(K / 32), no empty rank ((1, 0) at K = 0), rows' k_chunk a
    multiple of 4; tile (splits,
    k_chunk), k_chunk a multiple of the tile's K step, no empty split.
    Anything else raises ValueError."""
    route = _route(M)
    names = ("splits", "k_chunk") if route == "tile" \
        else ("cluster", "k_chunk")
    if set(plan) != set(names):
        raise ValueError(f"a {route} plan has keys {names}, got {plan}")
    n, chunk = (int(plan[k]) for k in names)
    if route != "tile":
        most = min(MAX_CLUSTER if route == "skinny" else ROWS_MAX_CLUSTER,
                   max(1, -(-K // _SKINNY_MIN_ROWS)))
        ok = (n, chunk) == (1, 0) if K == 0 else (
            1 <= n <= most and (n - 1) * chunk < K <= n * chunk
            and (route == "skinny" or chunk % 4 == 0))
    else:
        ok = (n >= 1 and chunk > 0 and chunk % _BK == 0
              and (n - 1) * chunk < max(K, 1) and K <= n * chunk)
    if not ok:
        raise ValueError(f"matmul plan {plan} is not one the {route} "
                         f"kernel takes at K = {K}")
    return n, chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           bias: torch.Tensor | None = None,
           epilogue: str = "none", plan: dict | None = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) float32, with ``bias`` ((N,)) and
    ``epilogue`` (``"none"``/``"tanh"``) applied once to the fp32 sum.

    A CPU tensor goes to :func:`matmul_plain`; a CUDA tensor to the kernel
    of its route (:func:`_route`), which takes contiguous float32 operands
    and raises on anything else, launched with ``plan`` or, for None, the
    autotuned plan of the shape (``last_plan`` keeps the one launched). A
    plan the kernel does not take raises on either device. ``launches``
    counts the launches, ``launches_by_route`` each route's.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias shape {tuple(bias.shape)}, want ({N},)")
    if plan is not None:
        check_plan(M, K, plan)
    if a.device.type == "cpu":
        return matmul_plain(a, b, bias=bias, epilogue=epilogue)
    build.refuse_grad("matmul", a, b, bias)
    operands = [a, b] + ([bias] if bias is not None else [])
    for t in operands:
        if (t.device != a.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("matmul kernel takes contiguous float32 CUDA "
                             "tensors on one device")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("matmul", _SIGNATURES)
    route = _route(M)
    bias_ptr = bias.data_ptr() if bias is not None else None
    tanh = int(epilogue == "tanh")
    if plan is None:
        plan = autotune.matmul_plan(M, K, N, _sm_count(a.device))
    n, k_chunk = check_plan(M, K, plan)
    with torch.cuda.device(a.device):
        stream = build.stream_ptr(a.device)
        if route == "skinny":
            rc = lib.matmul_skinny_f32(a.data_ptr(), b.data_ptr(), bias_ptr,
                                       out.data_ptr(), M, N, K, n,
                                       k_chunk, tanh, stream)
        elif route == "rows":
            rc = lib.matmul_rows_f32(a.data_ptr(), b.data_ptr(), bias_ptr,
                                     out.data_ptr(), M, N, K, n, k_chunk,
                                     tanh, stream)
        else:
            partial = (torch.empty((n, M, N), dtype=torch.float32,
                                   device=a.device) if n > 1 else None)
            rc = lib.matmul_f32(
                a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                M, N, K, n, k_chunk, tanh, stream)
    build.check(lib, rc, f"matmul ({route})")
    build.count_launch(matmul, route)
    matmul.last_plan = plan
    return out


matmul.last_plan = None
matmul.launches = 0
matmul.launches_by_route = {"skinny": 0, "rows": 0, "tile": 0}
