"""Bilinear resize (align_corners=False): CUDA kernel and plain version.

Counterpart of ``repro.kernels.resize`` (Pallas TPU kernel): separable
bilinear as two dense products per channel plane, ``Ry @ plane @ Rx^T``.
The CUDA source is ``csrc/resize.cu``; it shares its plane product with
the letterbox kernel. :func:`resize_bilinear` launches it for a CUDA
tensor and takes :func:`resize_bilinear_plain` only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"resize_bilinear_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _P]}


def _interp_matrix(out_n: int, in_n: int) -> np.ndarray:
    """Rows are bilinear weights (align_corners=False)."""
    c = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
    c = np.clip(c, 0.0, in_n - 1.0)
    lo = np.floor(c).astype(np.int32)
    hi = np.minimum(lo + 1, in_n - 1)
    frac = (c - lo).astype(np.float32)
    m = np.zeros((out_n, in_n), np.float32)
    m[np.arange(out_n), lo] += 1.0 - frac
    m[np.arange(out_n), hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _operators(out_h: int, out_w: int, H: int, W: int, device: str):
    """(Ry, Rx) on ``device``, built and uploaded once per geometry."""
    return (torch.from_numpy(_interp_matrix(out_h, H)).to(device),
            torch.from_numpy(_interp_matrix(out_w, W)).to(device))


def resize_bilinear_plain(img: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    """The same function in plain PyTorch: per plane ``(Ry @ plane) @ Rx^T``."""
    *lead, H, W, C = img.shape
    ry, rx = _operators(out_h, out_w, H, W, str(img.device))
    planes = img.reshape(-1, H, W, C).permute(0, 3, 1, 2).float()
    out = torch.matmul(torch.matmul(ry, planes), rx.T)     # (N, C, oh, ow)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, C) \
        .to(img.dtype)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """img: (..., H, W, C) -> (..., out_h, out_w, C).

    The kernel takes float32 on the card; a CPU tensor of any real dtype
    goes to the plain version, which returns the input's dtype.
    """
    if img.ndim < 3:
        raise ValueError(f"want (..., H, W, C), got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return resize_bilinear_plain(img, out_h, out_w)
    if img.dtype != torch.float32:
        raise ValueError(f"resize kernel takes float32, got {img.dtype}")
    *lead, H, W, C = img.shape
    x = img.reshape(-1, H, W, C).contiguous()
    N = x.shape[0]
    out = torch.empty((N, out_h, out_w, C), dtype=torch.float32,
                      device=img.device)
    if out.numel() == 0:
        return out.reshape(*lead, out_h, out_w, C)
    ry, rx = _operators(out_h, out_w, H, W, str(img.device))
    tmp = torch.empty((N * C, out_h, W), dtype=torch.float32, device=img.device)
    lib = build.library("resize", _SIGNATURES)
    with torch.cuda.device(img.device):
        rc = lib.resize_bilinear_f32(
            x.data_ptr(), ry.data_ptr(), rx.data_ptr(), tmp.data_ptr(),
            out.data_ptr(), N, H, W, C, out_h, out_w,
            build.stream_ptr(img.device))
    build.check(lib, rc, "resize_bilinear")
    build.count_launch(resize_bilinear)
    return out.reshape(*lead, out_h, out_w, C)


resize_bilinear.launches = 0
