"""Bilinear resize (align_corners=False): CUDA kernel and plain version.

Counterpart of ``repro.kernels.resize`` (Pallas TPU kernel), which
computes a separable bilinear resize as two dense products per channel
plane, ``Ry @ plane @ Rx^T``. Each row of those operators has at most 2
non-zeros, so the CUDA kernel (``csrc/resize.cu``) takes them as 2-tap
tables (:func:`interp_taps`) and gathers in one pass; the plain version
keeps the reference's dense form. :func:`resize_bilinear` launches the
kernel for a CUDA tensor and takes :func:`resize_bilinear_plain` only for
a CPU tensor. The letterbox kernel (:mod:`repro_torch.kernels.preproc`)
takes the same tap tables.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"resize_bilinear_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _P]}


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


def interp_taps(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A dense interpolation operator (out_n, in_n) -> its 2-tap table:
    ``idx`` int32 (out_n, 2) and ``w`` float32 (out_n, 2).

    The taps are the operator's non-zeros in ascending column order, each
    weight the operator's own float32 entry (so a tap merged at a clamped
    edge keeps its merged value). A row with fewer than 2 non-zeros is
    padded with weight 0 at a valid index: the row's last non-zero, or 0
    for an all-zero row. Raises on a row with more than 2 non-zeros.
    """
    m = np.asarray(m, np.float32)
    counts = np.count_nonzero(m, axis=1)
    if (counts > 2).any():
        raise ValueError(f"row {int(np.argmax(counts > 2))} has "
                         f"{int(counts.max())} non-zeros; taps take at most 2")
    rows, cols = np.nonzero(m)                  # row-major: ascending cols
    pos = np.arange(len(rows)) - (np.cumsum(counts) - counts)[rows]
    idx = np.zeros((m.shape[0], 2), np.int32)
    w = np.zeros((m.shape[0], 2), np.float32)
    idx[rows, pos] = cols
    w[rows, pos] = m[rows, cols]
    idx[:, 1] = np.where(counts == 2, idx[:, 1], idx[:, 0])
    return idx, w


class Taps(NamedTuple):
    """One axis's tap table on a device: ``idx`` int32 (out_n, 2) into an
    axis of ``n_in`` samples, ``w`` float32 (out_n, 2)."""
    idx: torch.Tensor
    w: torch.Tensor
    n_in: int


def upload_taps(idx: np.ndarray, w: np.ndarray, n_in: int, device) -> Taps:
    return Taps(torch.from_numpy(np.ascontiguousarray(idx)).to(device),
                torch.from_numpy(np.ascontiguousarray(w)).to(device), n_in)


def expand_taps(taps: Taps) -> torch.Tensor:
    """The dense operator (out_n, n_in) the taps were read from, exactly:
    a row's two weights lie at distinct columns or one of them is 0."""
    m = torch.zeros((taps.idx.shape[0], taps.n_in), dtype=torch.float32,
                    device=taps.w.device)
    return m.scatter_add_(1, taps.idx.long(), taps.w)


def check_taps(taps: Taps, n_in: int, device, what: str) -> None:
    """Raise unless ``taps`` holds an int32 and a float32 (rows, 2) table
    on ``device``, built for an axis of ``n_in`` samples."""
    idx, w, t_in = taps
    if idx.ndim != 2 or idx.shape[1] != 2 or w.shape != idx.shape \
            or t_in != n_in:
        raise ValueError(f"{what} taps idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)} over {t_in} samples do not fit "
                         f"an axis of {n_in}")
    if (idx.dtype, w.dtype) != (torch.int32, torch.float32) or \
            idx.device != device or w.device != device:
        raise ValueError(f"{what} taps must be int32 and float32 on {device}")


@functools.lru_cache(maxsize=64)
def _operators(out_h: int, out_w: int, H: int, W: int, device: str):
    """(Ry, Rx) dense on ``device`` for the plain version, built and
    uploaded once per geometry."""
    return (torch.from_numpy(_interp_matrix(out_h, H)).to(device),
            torch.from_numpy(_interp_matrix(out_w, W)).to(device))


@functools.lru_cache(maxsize=64)
def _taps(out_h: int, out_w: int, H: int, W: int, device: str):
    """(Taps of Ry, Taps of Rx) on ``device`` for the kernel, built and
    uploaded once per geometry."""
    return (upload_taps(*interp_taps(_interp_matrix(out_h, H)), H, device),
            upload_taps(*interp_taps(_interp_matrix(out_w, W)), W, device))


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
    ty, tx = _taps(out_h, out_w, H, W, str(img.device))
    lib = build.library("resize", _SIGNATURES)
    with torch.cuda.device(img.device):
        rc = lib.resize_bilinear_f32(
            x.data_ptr(), ty.idx.data_ptr(), ty.w.data_ptr(),
            tx.idx.data_ptr(), tx.w.data_ptr(), out.data_ptr(), N, H, W, C,
            out_h, out_w, build.stream_ptr(img.device))
    build.check(lib, rc, "resize_bilinear")
    build.count_launch(resize_bilinear)
    return out.reshape(*lead, out_h, out_w, C)


resize_bilinear.launches = 0
