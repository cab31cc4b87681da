"""Device-side pre/post-processing (counterpart of ``repro.preprocess.device``).

Decode and letterbox go through the hand-written kernels of
:mod:`repro_torch.kernels.preproc`, in the layout of the reference's
Pallas branch (channel-major planes, per-plane [scale, offset]); for CPU
tensors the kernels' wrappers take their plain versions. Detection
post-processing is plain PyTorch on the heatmaps' device: a stable
descending argsort picks the top-k candidate cells, and the greedy IoU
scan is a Python loop over the k candidates, vectorised over the batch.
The IoU keeps the reference's float32 expression order, so keep
decisions equal the host NMS bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import preproc
from repro_torch.preprocess import host as _host


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) planar uint8 -> (B, H, W, 3) uint8, on yuv's device."""
    return preproc.yuv_to_rgb(yuv)


@functools.lru_cache(maxsize=64)
def _letterbox_operators(in_h: int, in_w: int, out_h: int, out_w: int,
                         device: str):
    """(ly, lx) on ``device`` per geometry: the operator build and upload
    happen once, not per taxed call."""
    ly, lx = _host.embedded_interp_matrices(in_h, in_w, out_h, out_w)
    return torch.from_numpy(ly).to(device), torch.from_numpy(lx).to(device)


def letterbox_normalize(img: torch.Tensor, out_h: int, out_w: int, *,
                        scale, offset, pad_value: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, out_h, out_w, C) float32 on img's device.

    Aspect-preserving bilinear into a centered window, per-channel
    ``x * scale + offset`` on the content, ``pad_value`` outside.
    """
    B, H, W, C = img.shape
    ly, lx = _letterbox_operators(H, W, out_h, out_w, str(img.device))
    geom = _host.letterbox_geometry(H, W, out_h, out_w)
    planes = img.permute(0, 3, 1, 2).reshape(B * C, H, W)
    sb = np.tile(np.stack([np.asarray(scale, np.float32),
                           np.asarray(offset, np.float32)], axis=1), (B, 1))
    out = preproc.letterbox_normalize(
        planes, ly, lx, torch.from_numpy(sb).to(img.device), geom,
        pad_value=pad_value)
    return out.reshape(B, C, out_h, out_w).permute(0, 2, 3, 1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) -> (..., N, N) pairwise IoU, the reference's order."""
    y0, x0, y1, x1 = boxes.unbind(-1)
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


def _postprocess(hms: torch.Tensor, k: int, box_cells: float,
                 score_thresh: float, iou_thresh: float, max_out: int):
    B, Hc, Wc = hms.shape
    flat = hms.float().reshape(B, -1)
    order = torch.argsort(-flat, dim=1, stable=True)[:, :k]
    scores = torch.gather(flat, 1, order)
    cy = (order // Wc).float() + 0.5
    cx = (order % Wc).float() + 0.5
    h = float(np.float32(box_cells / 2.0))
    boxes = torch.stack([cy - h, cx - h, cy + h, cx + h], dim=-1)
    iou = _iou_matrix(boxes)
    n = order.shape[1]
    alive = scores >= float(np.float32(score_thresh))
    keep = torch.zeros_like(alive)
    count = torch.zeros(B, dtype=torch.int64, device=hms.device)
    later = torch.arange(n, device=hms.device)
    thr = float(np.float32(iou_thresh))
    for i in range(n):
        sel = alive[:, i] & (count < max_out)
        keep[:, i] = sel
        count += sel
        suppress = sel[:, None] & (later > i)[None, :] & (iou[:, i] > thr)
        alive &= ~suppress
    return boxes, scores, keep


def postprocess_heatmaps(hms: np.ndarray, *, k: int, box_cells: float,
                         score_thresh: float, iou_thresh: float, max_out: int,
                         device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched device post-processing; returns (boxes, scores, keep).

    ``hms``: (B, Hc, Wc). Candidates come back score-sorted per frame (the
    argsort IS the NMS visit order), so ``keep[b]`` marks survivors
    best-first. B is padded to its pow2 bucket with all-zero heatmaps,
    which detect nothing, as in the reference.
    """
    hms = np.asarray(hms)
    B = hms.shape[0]
    pad = (1 << (B - 1).bit_length()) - B
    if pad:
        hms = np.concatenate(
            [hms, np.zeros((pad, *hms.shape[1:]), hms.dtype)], axis=0)
    boxes, scores, keep = _postprocess(
        torch.from_numpy(hms).to(device), int(k), float(box_cells),
        float(score_thresh), float(iou_thresh), int(max_out))
    return (boxes.cpu().numpy()[:B], scores.cpu().numpy()[:B],
            keep.cpu().numpy()[:B])
