"""Host-side (NumPy) pre/post-processing the port's frame path needs.

A copy of part of ``repro.preprocess.host``: the camera's encoder
(:func:`rgb_to_yuv`, outside every taxed span), the letterbox geometry
and its embedded operators (and their 2-tap tables, which the letterbox
kernel takes), and the detection post-processing of the
host placement (top-k candidates + greedy IoU NMS). Decode and letterbox
have no NumPy copy here: the host placement runs the kernels' plain
PyTorch versions on the CPU (:mod:`repro_torch.preprocess.device` with
CPU tensors), which equal the reference's host baselines.

Numeric discipline as in the reference: every float op runs in float32
with the same expression order as the device path, so host/device NMS
decisions are bit-identical.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.kernels.resize import _interp_matrix as interp_matrix
from repro_torch.kernels.resize import interp_taps

_RGB_TO_YUV = np.array([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], np.float32)


def rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 RGB -> (..., 3, H, W) planar uint8 YUV.

    The *encoder* — it emulates what the camera/codec put on the wire,
    so it is deliberately not part of any taxed stage.
    """
    x = rgb.astype(np.float32)
    yuv = x @ _RGB_TO_YUV.T
    yuv[..., 1:] += 128.0
    yuv = np.clip(np.round(yuv), 0, 255).astype(np.uint8)
    return np.moveaxis(yuv, -1, -3)


def letterbox_geometry(in_h: int, in_w: int, out_h: int, out_w: int,
                       ) -> tuple[int, int, int, int]:
    """(content_h, content_w, top, left): aspect-preserving fit + center."""
    r = min(out_h / in_h, out_w / in_w)
    ch = max(1, min(out_h, round(in_h * r)))
    cw = max(1, min(out_w, round(in_w * r)))
    return ch, cw, (out_h - ch) // 2, (out_w - cw) // 2


@functools.lru_cache(maxsize=64)
def embedded_interp_matrices(in_h: int, in_w: int, out_h: int, out_w: int,
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Letterbox-embedded operators ``Ly (out_h, in_h)``, ``Lx (out_w,
    in_w)``: interpolation rows on the content window, zero rows
    elsewhere. Cached per geometry (read-only consumers)."""
    ch, cw, top, left = letterbox_geometry(in_h, in_w, out_h, out_w)
    ly = np.zeros((out_h, in_h), np.float32)
    ly[top:top + ch] = interp_matrix(ch, in_h)
    lx = np.zeros((out_w, in_w), np.float32)
    lx[left:left + cw] = interp_matrix(cw, in_w)
    return ly, lx


@functools.lru_cache(maxsize=64)
def embedded_interp_taps(in_h: int, in_w: int, out_h: int, out_w: int):
    """The 2-tap tables ``((iy, wy), (ix, wx))`` of
    :func:`embedded_interp_matrices` (:func:`~repro_torch.kernels.resize.
    interp_taps`): rows outside the content window have weight 0.
    Cached per geometry (read-only consumers)."""
    return tuple(interp_taps(m) for m in
                 embedded_interp_matrices(in_h, in_w, out_h, out_w))


@functools.lru_cache(maxsize=64)
def _content_mask(in_h: int, in_w: int, out_h: int, out_w: int,
                  ) -> np.ndarray:
    ch, cw, top, left = letterbox_geometry(in_h, in_w, out_h, out_w)
    mask = np.zeros((out_h, out_w), bool)
    mask[top:top + ch, left:left + cw] = True
    return mask


def iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """(N, 4) float32 [y0, x0, y1, x1] -> (N, N) float32 pairwise IoU,
    in the device path's float32 expression order."""
    b = boxes.astype(np.float32)
    y0, x0, y1, x1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = (y1 - y0) * (x1 - x0)
    ih = np.maximum(
        np.float32(0.0),
        np.minimum(y1[:, None], y1[None, :])
        - np.maximum(y0[:, None], y0[None, :]))
    iw = np.maximum(
        np.float32(0.0),
        np.minimum(x1[:, None], x1[None, :])
        - np.maximum(x0[:, None], x0[None, :]))
    inter = ih * iw
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, np.float32(1e-12))


def nms(boxes: np.ndarray, scores: np.ndarray, *,
        iou_thresh: float = 0.5, score_thresh: float = 0.0,
        max_out: int | None = None) -> list[int]:
    """Greedy IoU NMS -> kept indices (into the input), best-first; ties
    broken by index (stable descending sort)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    order = np.argsort(-scores, kind="stable")
    alive = scores[order] >= np.float32(score_thresh)
    iou = iou_matrix(boxes[order])
    thr = np.float32(iou_thresh)
    keep: list[int] = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(int(order[i]))
        if max_out is not None and len(keep) >= max_out:
            break
        alive[i + 1:] &= ~(iou[i, i + 1:] > thr)
    return keep


def topk_boxes_from_heatmap(hm: np.ndarray, k: int, *, box_cells: float,
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Dense heatmap -> top-k candidate boxes + scores (cell units), the
    k highest cells with a stable flat-index tie-break."""
    Hc, Wc = hm.shape
    flat = hm.astype(np.float32).reshape(-1)
    k = min(k, flat.size)
    idx = np.argsort(-flat, kind="stable")[:k]
    cy = (idx // Wc).astype(np.float32) + np.float32(0.5)
    cx = (idx % Wc).astype(np.float32) + np.float32(0.5)
    h = np.float32(box_cells / 2.0)
    boxes = np.stack([cy - h, cx - h, cy + h, cx + h], axis=1)
    return boxes, flat[idx]
