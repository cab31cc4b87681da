"""Device-side pre/post-processing (counterpart of ``repro.preprocess.device``).

Decode, letterbox and the IoU of :func:`nms` go through the hand-written
kernels of :mod:`repro_torch.kernels.preproc`, in the layout of the
reference's Pallas branch (channel-major planes, per-plane [scale,
offset], component-major boxes); for CPU tensors the kernels' wrappers
take their plain versions. Batched heatmap post-processing keeps its
plain IoU, as the reference does (``repro.preprocess.device`` calls
``_iou_matrix_jnp`` there): a stable descending argsort picks the top-k
candidate cells, and the greedy IoU scan is a Python loop over the
candidates, vectorised over the batch. Every IoU keeps the reference's
float32 expression order, so keep decisions equal the host NMS bit for
bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import preproc
from repro_torch.kernels.resize import upload_taps
from repro_torch.preprocess import host as _host


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) planar uint8 -> (B, H, W, 3) uint8, on yuv's device."""
    return preproc.yuv_to_rgb(yuv)


@functools.lru_cache(maxsize=64)
def _letterbox_operators(in_h: int, in_w: int, out_h: int, out_w: int,
                         device: str):
    """The tap tables (rows, columns) on ``device`` per geometry: the build
    and upload happen once, not per taxed call."""
    ty, tx = _host.embedded_interp_taps(in_h, in_w, out_h, out_w)
    return (upload_taps(*ty, in_h, device), upload_taps(*tx, in_w, device))


def letterbox_normalize(img: torch.Tensor, out_h: int, out_w: int, *,
                        scale, offset, pad_value: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, out_h, out_w, C) float32 on img's device.

    Aspect-preserving bilinear into a centered window, per-channel
    ``x * scale + offset`` on the content, ``pad_value`` outside.
    """
    B, H, W, C = img.shape
    taps_y, taps_x = _letterbox_operators(H, W, out_h, out_w,
                                          str(img.device))
    geom = _host.letterbox_geometry(H, W, out_h, out_w)
    planes = img.permute(0, 3, 1, 2).reshape(B * C, H, W)
    sb = np.tile(np.stack([np.asarray(scale, np.float32),
                           np.asarray(offset, np.float32)], axis=1), (B, 1))
    out = preproc.letterbox_normalize(
        planes, taps_y, taps_x, torch.from_numpy(sb).to(img.device), geom,
        pad_value=pad_value)
    return out.reshape(B, C, out_h, out_w).permute(0, 2, 3, 1)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) float32 [y0, x0, y1, x1] -> (N, N) pairwise IoU, through the
    IoU kernel for a CUDA tensor (its plain version for a CPU one)."""
    return preproc.iou_matrix(boxes.float().T)


def _greedy_keep(iou: torch.Tensor, alive: torch.Tensor, thr: float,
                 max_out: int) -> torch.Tensor:
    """Greedy NMS over candidates already in visit order: (B, n, n) IoU and
    (B, n) ``alive`` -> (B, n) keep mask. Visiting a dead row is a no-op,
    so the scan is one loop over n, vectorised over the batch, with no
    host round trip."""
    B, n = alive.shape
    alive = alive.clone()
    keep = torch.zeros_like(alive)
    count = torch.zeros(B, dtype=torch.int64, device=alive.device)
    later = torch.arange(n, device=alive.device)
    for i in range(n):
        sel = alive[:, i] & (count < max_out)
        keep[:, i] = sel
        count += sel
        alive &= ~(sel[:, None] & (later > i)[None, :] & (iou[:, i] > thr))
    return keep


def nms(boxes: np.ndarray, scores: np.ndarray, *, iou_thresh: float = 0.5,
        score_thresh: float = 0.0, max_out: int | None = None,
        device="cuda") -> list[int]:
    """Device greedy NMS; same contract as :func:`repro_torch.preprocess.
    host.nms` (kept indices into the input, best-first, ties by index).

    The candidates are padded to their pow2 bucket with ``-inf`` scores,
    which sort last and are masked out of ``alive``; sorting, the IoU
    kernel and the scan run on ``device``, and only the keep mask and the
    visit order come back.
    """
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    N = len(scores)
    if N == 0:
        return []
    dev = resolve_device(device)
    Np = 1 << (N - 1).bit_length()
    cap = Np if max_out is None else max_out
    boxes_p = np.zeros((Np, 4), np.float32)
    boxes_p[:N] = boxes
    scores_p = np.full((Np,), -np.inf, np.float32)
    scores_p[:N] = scores
    sc = torch.from_numpy(scores_p).to(dev)
    order = torch.argsort(-sc, stable=True)
    alive = (sc[order] >= float(np.float32(score_thresh))) & (order < N)
    iou = iou_matrix(torch.from_numpy(boxes_p).to(dev)[order])
    keep = _greedy_keep(iou[None], alive[None], float(np.float32(iou_thresh)),
                        cap)[0].cpu().numpy()
    order = order.cpu().numpy()
    return [int(order[i]) for i in range(Np) if keep[i]]


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
    alive = scores >= float(np.float32(score_thresh))
    iou = preproc.iou_matrix_plain(boxes.movedim(-1, 0))
    keep = _greedy_keep(iou, alive, float(np.float32(iou_thresh)), max_out)
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
