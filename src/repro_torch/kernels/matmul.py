"""fp32 matmul with a fused bias + tanh epilogue: CUDA kernel and plain version.

Counterpart of ``repro.kernels.matmul`` (the Pallas TPU kernel). The
kernel is ``csrc/matmul.cu``; its source note says what bounds it on an
H100 and how the split-K grid deals with the skinny face-batch shapes.
:func:`matmul` launches it for a CUDA tensor and takes
:func:`matmul_plain` only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

EPILOGUES = ("none", "tanh")
_BM, _BN, _BK = 16, 64, 32        # the tile of csrc/matmul.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}


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


def split_k(M: int, N: int, K: int, n_sm: int) -> tuple[int, int]:
    """(splits, k_chunk): enough K splits to give every SM about two
    blocks when the output has few tiles, with no empty split."""
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

    A CPU tensor goes to :func:`matmul_plain`; a CUDA tensor to the kernel,
    which takes contiguous float32 operands and raises on anything else.
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
    splits, k_chunk = split_k(M, N, K, _sm_count(a.device))
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    with torch.cuda.device(a.device):
        rc = lib.matmul_f32(
            a.data_ptr(), b.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            M, N, K, splits, k_chunk, int(epilogue == "tanh"),
            build.stream_ptr(a.device))
    build.check(lib, rc, "matmul")
    build.count_launch(matmul)
    return out


matmul.launches = 0
