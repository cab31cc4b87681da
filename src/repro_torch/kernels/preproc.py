"""Frame pre/post-processing kernels: planar YUV decode, fused letterbox
and the pairwise IoU of NMS.

Counterparts of ``repro.kernels.preproc.yuv_to_rgb``,
``letterbox_normalize`` and ``iou_matrix`` (Pallas TPU kernels). The CUDA
sources are ``csrc/preproc.cu`` and ``csrc/iou.cu``; their notes say what
bounds each kernel on an H100 and what the design does about it. Each
wrapper launches its kernel for a CUDA tensor and takes the plain PyTorch
version beside it only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.resize import Taps, check_taps, expand_taps

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "yuv_to_rgb_u8": [_P, _P, _I, _I, _I, _I, _P],
    "letterbox_normalize_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _P],
}
_IOU_SIGNATURES = {"iou_f32": [_P, _P, _I, _P]}

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


YUV_ROUTES = ("scalar", "vec4", "vec16")     # index = the C entry's route


def _yuv_route(H: int, W: int, ptr_alignment: int) -> str:
    """The YUV kernel's route for frames of H x W pixels whose input and
    output buffers are both ``ptr_alignment``-byte aligned: ``"vec16"``
    (16 pixels a thread, uint4 loads and stores) when a frame is a multiple
    of 16 pixels and the buffers 16-byte aligned, ``"vec4"`` (4 pixels a
    thread, words) for 4 and 4, else ``"scalar"``. The batch does not
    matter: a group of pixels never spans two frames."""
    hw = H * W
    if hw % 16 == 0 and ptr_alignment % 16 == 0:
        return "vec16"
    if hw % 4 == 0 and ptr_alignment % 4 == 0:
        return "vec4"
    return "scalar"


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) planar uint8 YUV -> (B, H, W, 3) uint8 RGB (BT.601 full).

    On a CUDA tensor the kernel's route is :func:`_yuv_route`'s;
    ``yuv_to_rgb.launches_by_route`` counts each route's launches."""
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
    route = _yuv_route(H, W, math.gcd(yuv.data_ptr(), out.data_ptr(), 16))
    lib = _lib()
    with torch.cuda.device(yuv.device):
        rc = lib.yuv_to_rgb_u8(yuv.data_ptr(), out.data_ptr(), B, H, W,
                               YUV_ROUTES.index(route),
                               build.stream_ptr(yuv.device))
    build.check(lib, rc, f"yuv_to_rgb ({route})")
    build.count_launch(yuv_to_rgb, route)
    return out


yuv_to_rgb.launches = 0
yuv_to_rgb.launches_by_route = dict.fromkeys(YUV_ROUTES, 0)


# --------------------------------------------------------------------------
# Fused letterbox resize + normalisation
# --------------------------------------------------------------------------

def _inside(geometry, out_h: int, out_w: int, device) -> torch.Tensor:
    ch, cw, top, left = geometry
    rows = torch.arange(out_h, device=device)[:, None]
    cols = torch.arange(out_w, device=device)[None, :]
    return (rows >= top) & (rows < top + ch) & (cols >= left) & (cols < left + cw)


def letterbox_normalize_plain(planes: torch.Tensor, taps_y: Taps,
                              taps_x: Taps, sb: torch.Tensor,
                              geometry: tuple[int, int, int, int], *,
                              pad_value: float = 0.0) -> torch.Tensor:
    """The same function in plain PyTorch, in the reference's dense form:
    the taps expanded (exactly) to ``Ly`` and ``Lx``, ``(Ly @ plane) @
    Lx^T``, then ``* scale + offset``, then the pad mask."""
    ly, lx = expand_taps(taps_y), expand_taps(taps_x)
    t = torch.matmul(torch.matmul(ly, planes.float()), lx.T)
    norm = t * sb[:, 0, None, None] + sb[:, 1, None, None]
    inside = _inside(geometry, ly.shape[0], lx.shape[0], planes.device)
    return torch.where(inside, norm, float(pad_value))


def letterbox_normalize(planes: torch.Tensor, taps_y: Taps, taps_x: Taps,
                        sb: torch.Tensor,
                        geometry: tuple[int, int, int, int], *,
                        pad_value: float = 0.0) -> torch.Tensor:
    """Fused letterbox + normalize over channel-major planes.

    ``planes``: (NB, H, W) uint8 (batch * channel, channel fastest);
    ``taps_y``/``taps_x``: the 2-tap tables (:class:`~repro_torch.kernels.
    resize.Taps`) of the letterbox-embedded interpolation operators,
    (out_h, 2) over H and (out_w, 2) over W; ``sb``: (NB, 2) per-plane
    [scale, offset]; ``geometry``: (content_h, content_w, top, left) from
    :func:`repro_torch.preprocess.host.letterbox_geometry`. Returns
    (NB, out_h, out_w) float32, ``pad_value`` outside the content window.
    """
    NB, H, W = planes.shape
    out_h, out_w = taps_y.idx.shape[0], taps_x.idx.shape[0]
    check_taps(taps_y, H, planes.device, "row")
    check_taps(taps_x, W, planes.device, "column")
    if tuple(sb.shape) != (NB, 2) or sb.device != planes.device:
        raise ValueError(f"sb {tuple(sb.shape)} on {sb.device} does not fit "
                         f"planes {tuple(planes.shape)} on {planes.device}")
    if planes.device.type == "cpu":
        return letterbox_normalize_plain(planes, taps_y, taps_x, sb,
                                         geometry, pad_value=pad_value)
    if planes.dtype != torch.uint8 or sb.dtype != torch.float32:
        raise ValueError(f"letterbox kernel takes uint8 planes and float32 "
                         f"sb, got {planes.dtype} and {sb.dtype}")
    planes, sb, iy, wy, ix, wx = (
        t.contiguous() for t in (planes, sb, taps_y.idx, taps_y.w,
                                 taps_x.idx, taps_x.w))
    out = torch.empty((NB, out_h, out_w), dtype=torch.float32,
                      device=planes.device)
    if out.numel() == 0:
        return out
    ch, cw, top, left = (int(g) for g in geometry)
    lib = _lib()
    with torch.cuda.device(planes.device):
        rc = lib.letterbox_normalize_f32(
            planes.data_ptr(), iy.data_ptr(), wy.data_ptr(), ix.data_ptr(),
            wx.data_ptr(), sb.data_ptr(), out.data_ptr(), NB, H, W, out_h,
            out_w, top, ch, left, cw, float(pad_value),
            build.stream_ptr(planes.device))
    build.check(lib, rc, "letterbox_normalize")
    build.count_launch(letterbox_normalize)
    return out


letterbox_normalize.launches = 0


# --------------------------------------------------------------------------
# Pairwise IoU (the dense half of NMS)
# --------------------------------------------------------------------------

def iou_matrix_plain(boxes_t: torch.Tensor) -> torch.Tensor:
    """(4, ..., N) float32 [y0, x0, y1, x1] -> (..., N, N) IoU in the
    host's float32 order (``repro.preprocess.host.iou_matrix``): every step
    is one IEEE operation, ``union = (area_i + area_j) - inter``, clamped
    at 1e-12. Leading dimensions after the first are a batch."""
    y0, x0, y1, x1 = boxes_t.float()
    area = (y1 - y0) * (x1 - x0)
    ih = torch.clamp_min(torch.minimum(y1[..., :, None], y1[..., None, :])
                         - torch.maximum(y0[..., :, None], y0[..., None, :]),
                         0.0)
    iw = torch.clamp_min(torch.minimum(x1[..., :, None], x1[..., None, :])
                         - torch.maximum(x0[..., :, None], x0[..., None, :]),
                         0.0)
    inter = ih * iw
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def iou_matrix(boxes_t: torch.Tensor) -> torch.Tensor:
    """(4, N) component-major float32 boxes -> (N, N) pairwise IoU, equal
    to :func:`iou_matrix_plain` (``csrc/iou.cu``)."""
    if boxes_t.ndim != 2 or boxes_t.shape[0] != 4:
        raise ValueError(f"want (4, N) boxes, got {tuple(boxes_t.shape)}")
    if boxes_t.device.type == "cpu":
        return iou_matrix_plain(boxes_t)
    if boxes_t.dtype != torch.float32:
        raise ValueError(f"iou kernel takes float32 boxes, got {boxes_t.dtype}")
    boxes_t = boxes_t.contiguous()
    n = boxes_t.shape[1]
    out = torch.empty((n, n), dtype=torch.float32, device=boxes_t.device)
    if n == 0:
        return out
    lib = build.library("iou", _IOU_SIGNATURES)
    with torch.cuda.device(boxes_t.device):
        rc = lib.iou_f32(boxes_t.data_ptr(), out.data_ptr(), n,
                         build.stream_ptr(boxes_t.device))
    build.check(lib, rc, "iou_matrix")
    build.count_launch(iou_matrix)
    return out


iou_matrix.launches = 0
