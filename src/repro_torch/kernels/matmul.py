"""fp32 matmul with a fused bias + tanh epilogue: CUDA kernels and plain
version.

Counterpart of ``repro.kernels.matmul`` (the Pallas TPU kernel). The
kernels are in ``csrc/matmul.cu``; its source note says what bounds them
on an H100. Two routes, chosen by the row count (:func:`_route`): the face
batches (M <= 8) take the skinny kernel, one launch that splits K over a
thread-block cluster (:func:`skinny_plan`) and sums the splits through
distributed shared memory; larger M takes the tiled kernel, whose K split
(:func:`split_k`) sums in a second launch. :func:`matmul` launches a kernel
for a CUDA tensor and takes :func:`matmul_plain` only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

EPILOGUES = ("none", "tanh")
_BM, _BN, _BK = 16, 64, 32        # the tile route's tile (csrc/matmul.cu)
SKINNY_M = 8                      # the most rows the skinny route takes
_SN = 16                          # the skinny route's columns a block
MAX_CLUSTER = 8                   # blocks a cluster: the portable limit
_SKINNY_MIN_ROWS = 32             # K rows a cluster rank reads at least
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
               "matmul_skinny_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
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
    M <= 8 (the face batches), ``"tile"`` above."""
    return "skinny" if M <= SKINNY_M else "tile"


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


def split_k(M: int, N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(splits, k_chunk) of the tile route: enough K splits to give every
    SM about two blocks when the output has few tiles, with no empty
    split."""
    tiles = -(-M // _BM) * -(-N // _BN)
    k_tiles = max(1, -(-K // _BK))
    want = max(1, min(k_tiles, -(-2 * n_sm // tiles)))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per * _BK


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           bias: torch.Tensor | None = None,
           epilogue: str = "none") -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) float32, with ``bias`` ((N,)) and
    ``epilogue`` (``"none"``/``"tanh"``) applied once to the fp32 sum.

    A CPU tensor goes to :func:`matmul_plain`; a CUDA tensor to the kernel
    of its route (:func:`_route`), which takes contiguous float32 operands
    and raises on anything else. ``launches`` counts the launches,
    ``launches_by_route`` each route's.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias shape {tuple(bias.shape)}, want ({N},)")
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
    with torch.cuda.device(a.device):
        stream = build.stream_ptr(a.device)
        if route == "skinny":
            cluster, k_chunk = skinny_plan(N, K, _sm_count(a.device))
            rc = lib.matmul_skinny_f32(a.data_ptr(), b.data_ptr(), bias_ptr,
                                       out.data_ptr(), M, N, K, cluster,
                                       k_chunk, tanh, stream)
        else:
            splits, k_chunk = split_k(M, N, K, _sm_count(a.device))
            partial = (torch.empty((splits, M, N), dtype=torch.float32,
                                   device=a.device) if splits > 1 else None)
            rc = lib.matmul_f32(
                a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                M, N, K, splits, k_chunk, tanh, stream)
    build.check(lib, rc, f"matmul ({route})")
    build.count_launch(matmul, route)
    return out


matmul.launches = 0
matmul.launches_by_route = {"skinny": 0, "tile": 0}
