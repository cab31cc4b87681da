"""Frame pre-processing kernels: planar YUV decode and fused letterbox.

Counterparts of ``repro.kernels.preproc.yuv_to_rgb`` and
``letterbox_normalize`` (Pallas TPU kernels). The CUDA source is
``csrc/preproc.cu``; its notes say what bounds each kernel on an H100 and
what the design does about it. Each wrapper launches its kernel for a
CUDA tensor and takes the plain PyTorch version beside it only for a CPU
tensor. (``repro.kernels.preproc.iou_matrix`` is not ported yet.)
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "yuv_to_rgb_u8": [_P, _P, _I, _I, _I, _P],
    "letterbox_normalize_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _F, _P],
}

# BT.601 full-range decode constants, as float32 values held exactly in
# float64 (the plain version's fma emulation).
_C_RV = float(np.float32(1.402))
_C_GU = float(np.float32(-0.344136))
_C_GV = float(np.float32(-0.714136))
_C_BU = float(np.float32(1.772))


def _lib():
    return build.library("preproc", _SIGNATURES)


# --------------------------------------------------------------------------
# Planar YUV -> RGB
# --------------------------------------------------------------------------

def yuv_to_rgb_plain(yuv: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 -> (B, H, W, 3) uint8, the kernel's exact chain.

    Each fma of the chain ``r = fma(1.402, v, y)``,
    ``g = fma(-0.714136, v, fma(-0.344136, u, y))``,
    ``b = fma(1.772, u, y)`` is emulated in float64, where product and sum
    of these operands are exact, followed by one rounding to float32; then
    round half to even and clamp. Equal to the host decode
    (``repro.preprocess.host.yuv_to_rgb``) on all 256^3 triples.
    """
    x = yuv.to(torch.float64)
    y = x[:, 0]
    u = x[:, 1] - 128.0
    v = x[:, 2] - 128.0
    r = (_C_RV * v + y).float()
    g = (_C_GV * v + (_C_GU * u + y).float().double()).float()
    b = (_C_BU * u + y).float()
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp_(0.0, 255.0).to(torch.uint8)


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) planar uint8 YUV -> (B, H, W, 3) uint8 RGB (BT.601 full)."""
    if yuv.ndim != 4 or yuv.shape[1] != 3 or yuv.dtype != torch.uint8:
        raise ValueError(f"want (B, 3, H, W) uint8, got {tuple(yuv.shape)} "
                         f"{yuv.dtype}")
    if yuv.device.type == "cpu":
        return yuv_to_rgb_plain(yuv)
    yuv = yuv.contiguous()
    B, _, H, W = yuv.shape
    out = torch.empty((B, H, W, 3), dtype=torch.uint8, device=yuv.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(yuv.device):
        rc = lib.yuv_to_rgb_u8(yuv.data_ptr(), out.data_ptr(), B, H, W,
                               build.stream_ptr(yuv.device))
    build.check(lib, rc, "yuv_to_rgb")
    build.count_launch(yuv_to_rgb)
    return out


yuv_to_rgb.launches = 0


# --------------------------------------------------------------------------
# Fused letterbox resize + normalisation
# --------------------------------------------------------------------------

def _inside(geometry, out_h: int, out_w: int, device) -> torch.Tensor:
    ch, cw, top, left = geometry
    rows = torch.arange(out_h, device=device)[:, None]
    cols = torch.arange(out_w, device=device)[None, :]
    return (rows >= top) & (rows < top + ch) & (cols >= left) & (cols < left + cw)


def letterbox_normalize_plain(planes: torch.Tensor, ly: torch.Tensor,
                              lx: torch.Tensor, sb: torch.Tensor,
                              geometry: tuple[int, int, int, int], *,
                              pad_value: float = 0.0) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's order:
    ``(Ly @ plane) @ Lx^T``, then ``* scale + offset``, then the pad mask."""
    t = torch.matmul(torch.matmul(ly, planes.float()), lx.T)
    norm = t * sb[:, 0, None, None] + sb[:, 1, None, None]
    inside = _inside(geometry, ly.shape[0], lx.shape[0], planes.device)
    return torch.where(inside, norm, float(pad_value))


def letterbox_normalize(planes: torch.Tensor, ly: torch.Tensor,
                        lx: torch.Tensor, sb: torch.Tensor,
                        geometry: tuple[int, int, int, int], *,
                        pad_value: float = 0.0) -> torch.Tensor:
    """Fused letterbox + normalize over channel-major planes.

    ``planes``: (NB, H, W) uint8 (batch * channel, channel fastest);
    ``ly``/``lx``: letterbox-embedded interpolation operators (out_h, H)
    and (out_w, W) float32; ``sb``: (NB, 2) per-plane [scale, offset];
    ``geometry``: (content_h, content_w, top, left) from
    :func:`repro_torch.preprocess.host.letterbox_geometry`. Returns
    (NB, out_h, out_w) float32, ``pad_value`` outside the content window.
    """
    NB, H, W = planes.shape
    out_h, out_w = ly.shape[0], lx.shape[0]
    if (ly.shape[1], lx.shape[1], tuple(sb.shape)) != (H, W, (NB, 2)):
        raise ValueError(f"operators {tuple(ly.shape)}, {tuple(lx.shape)}, "
                         f"sb {tuple(sb.shape)} do not fit planes "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return letterbox_normalize_plain(planes, ly, lx, sb, geometry,
                                         pad_value=pad_value)
    if planes.dtype != torch.uint8:
        raise ValueError(f"letterbox kernel takes uint8 planes, got {planes.dtype}")
    for t in (ly, lx, sb):
        if t.dtype != torch.float32 or t.device != planes.device:
            raise ValueError("letterbox kernel takes float32 operators on the "
                             "planes' device")
    planes, ly, lx, sb = (t.contiguous() for t in (planes, ly, lx, sb))
    out = torch.empty((NB, out_h, out_w), dtype=torch.float32,
                      device=planes.device)
    if out.numel() == 0:
        return out
    tmp = torch.empty((NB, out_h, W), dtype=torch.float32, device=planes.device)
    ch, cw, top, left = (int(g) for g in geometry)
    lib = _lib()
    with torch.cuda.device(planes.device):
        rc = lib.letterbox_normalize_f32(
            planes.data_ptr(), ly.data_ptr(), lx.data_ptr(), sb.data_ptr(),
            tmp.data_ptr(), out.data_ptr(), NB, H, W, out_h, out_w, top, ch,
            left, cw, float(pad_value), build.stream_ptr(planes.device))
    build.check(lib, rc, "letterbox_normalize")
    build.count_launch(letterbox_normalize)
    return out


letterbox_normalize.launches = 0
