"""PreprocessStage: placement-switchable pre/post-processing with tax
accounting (counterpart of ``repro.preprocess.stage``).

One object owns decode (planar YUV -> RGB), letterbox resize +
normalization, and detection post-processing (score threshold + greedy
IoU NMS) behind one ``placement`` switch:

  * ``placement="host"``   — the work rides the CPU: decode and letterbox
    run the kernels' plain PyTorch versions on CPU tensors, NMS the NumPy
    baseline (:mod:`repro_torch.preprocess.host`);
  * ``placement="device"`` — decode and letterbox run the hand-written
    CUDA kernels and NMS runs in PyTorch on ``device``; the host<->device
    boundary bytes are logged as transfer events.

Every call logs the reference's per-request events (``pre_decode``,
``pre_letterbox``, ``post_nms``) and the same transfer bytes, so the
five-way attribution is computed alike in both packages. Each device
span ends after its result is back on the host (``.cpu()`` waits for the
card), so no kernel time leaks into a later span.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.events import EventLog, categorize
from repro_torch.preprocess import device as _device
from repro_torch.preprocess import host as _host


@dataclass(frozen=True)
class NormSpec:
    """Per-channel affine normalization ``x_norm = x * scale + offset``:
    ``to_unit`` first maps 0..255 to 0..1, then ``(x - mean) / std``.
    The default is the identity (the detector's frame norm); the identify
    stage uses ``NormSpec(to_unit=True)``, the historical ``/255``."""
    mean: tuple = (0.0, 0.0, 0.0)
    std: tuple = (1.0, 1.0, 1.0)
    to_unit: bool = False

    @property
    def scale(self) -> np.ndarray:
        base = 255.0 if self.to_unit else 1.0
        return (1.0 / (base * np.asarray(self.std, np.float64))) \
            .astype(np.float32)

    @property
    def offset(self) -> np.ndarray:
        return (-np.asarray(self.mean, np.float64)
                / np.asarray(self.std, np.float64)).astype(np.float32)


@dataclass(frozen=True)
class DetectPostConfig:
    """Detection post-processing knobs (heatmap-cell units)."""
    score_thresh: float = 60.0
    iou_thresh: float = 0.12
    box_cells: float = 6.0
    max_candidates: int = 32
    max_faces: int = 5


class PreprocessStage:
    """Placement-switchable decode / letterbox / NMS with event logging.

    ``device`` is where ``placement="device"`` runs (default the card;
    without one it raises unless ``device="cpu"``). ``log`` may be
    attached after construction.
    """

    def __init__(self, placement: str = "host", *,
                 frame_norm: NormSpec | None = None,
                 crop_norm: NormSpec | None = None,
                 post: DetectPostConfig | None = None,
                 log: EventLog | None = None, device="cuda"):
        if placement not in ("host", "device"):
            raise ValueError(f"placement must be host|device, got "
                             f"{placement!r}")
        self.placement = placement
        self.device = resolve_device(device)
        self.frame_norm = frame_norm or NormSpec()
        self.crop_norm = crop_norm or NormSpec(to_unit=True)
        self.post = post or DetectPostConfig()
        self.log = log

    @property
    def _work_device(self) -> torch.device:
        return self.device if self.placement == "device" \
            else torch.device("cpu")

    # ---- accounting helpers ----------------------------------------------

    def _log_span(self, stage: str, rids, t0: float, t1: float,
                  payload_bytes: int) -> None:
        if categorize(stage, default=None) not in ("pre", "post"):
            raise ValueError(
                f"preprocess stage {stage!r} does not categorize as "
                "pre/post through repro_torch.core.events.STAGE_CATEGORIES")
        if self.log is None:
            return
        self.log.log_batch_span(rids, stage, t0, t1, payload_bytes,
                                split_payload=True,
                                placement=self.placement)

    def _log_transfers(self, rids, boundary: str, h2d: int,
                       d2h: int) -> None:
        if self.log is None or self.placement != "device":
            return
        self.log.log_batch_transfers(rids, boundary, h2d, d2h)

    # ---- pre-processing ---------------------------------------------------

    def decode(self, yuv: np.ndarray, rids=None) -> np.ndarray:
        """(B, 3, H, W) planar uint8 YUV -> (B, H, W, 3) uint8 RGB."""
        rids = list(rids) if rids is not None else list(range(len(yuv)))
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(yuv)).to(self._work_device)
        rgb = _device.yuv_to_rgb(x).cpu().numpy()
        self._log_span("pre_decode", rids, t0, time.perf_counter(),
                       yuv.nbytes)
        self._log_transfers(rids, "pre_decode", yuv.nbytes, rgb.nbytes)
        return rgb

    def letterbox(self, frames: np.ndarray, out_h: int, out_w: int,
                  rids=None, *, pad_value: float = 0.0) -> np.ndarray:
        """(B, H, W, C) -> (B, out_h, out_w, C) float32, frame-normed."""
        rids = list(rids) if rids is not None else list(range(len(frames)))
        n = self.frame_norm
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(frames)) \
            .to(self._work_device)
        out = _device.letterbox_normalize(
            x, out_h, out_w, scale=n.scale, offset=n.offset,
            pad_value=pad_value).cpu().numpy()
        self._log_span("pre_letterbox", rids, t0, time.perf_counter(),
                       frames.nbytes)
        self._log_transfers(rids, "pre_letterbox", frames.nbytes, out.nbytes)
        return out

    def ingest(self, yuv: np.ndarray, out_h: int, out_w: int,
               rids=None) -> np.ndarray:
        """Decode + letterbox, the full taxed ingest path."""
        return self.letterbox(self.decode(yuv, rids), out_h, out_w, rids)

    # ---- post-processing --------------------------------------------------

    def postprocess(self, hms: np.ndarray, pool: int, rids=None, *,
                    skip_nms: bool = False) -> list[list[tuple[int, int]]]:
        """(B, Hc, Wc) detection heatmaps -> face centers per frame, in
        full-resolution coordinates (``cell * pool + pool//2``),
        best-first. Host and device placements make bit-identical keep
        decisions.

        ``skip_nms=True`` is the degrade ladder's cheap rung
        (``DegradePolicy`` levels with ``post_nms`` False): threshold +
        plain top-k by score on the host whatever the placement, since the
        saving is not launching the suppression; logged as ``post_nms``.
        """
        rids = list(rids) if rids is not None else list(range(len(hms)))
        p = self.post
        t0 = time.perf_counter()
        centers: list[list[tuple[int, int]]] = []
        if skip_nms:
            for hm in hms:
                boxes, scores = _host.topk_boxes_from_heatmap(
                    hm, p.max_candidates, box_cells=p.box_cells)
                # scores come back best-first: the first max_faces over
                # the bar are the plain top-k keeps
                keep = [i for i in range(len(scores))
                        if scores[i] >= p.score_thresh][:p.max_faces]
                centers.append(self._centers(boxes[keep], pool))
            self._log_span("post_nms", rids, t0, time.perf_counter(),
                           hms.nbytes)
            return centers
        if self.placement == "host":
            for hm in hms:
                boxes, scores = _host.topk_boxes_from_heatmap(
                    hm, p.max_candidates, box_cells=p.box_cells)
                keep = _host.nms(boxes, scores, iou_thresh=p.iou_thresh,
                                 score_thresh=p.score_thresh,
                                 max_out=p.max_faces)
                centers.append(self._centers(boxes[keep], pool))
        else:
            boxes, scores, keep = _device.postprocess_heatmaps(
                hms, k=p.max_candidates, box_cells=p.box_cells,
                score_thresh=p.score_thresh, iou_thresh=p.iou_thresh,
                max_out=p.max_faces, device=self.device)
            for b in range(len(hms)):
                centers.append(self._centers(boxes[b][keep[b]], pool))
            out_bytes = boxes.nbytes + scores.nbytes + keep.nbytes
            # padding included — the pow2-padded heatmap rows cross too
            Bp = 1 << (len(hms) - 1).bit_length()
            self._log_transfers(rids, "post_nms", Bp * hms[0].nbytes,
                                out_bytes)
        self._log_span("post_nms", rids, t0, time.perf_counter(), hms.nbytes)
        return centers

    @staticmethod
    def _centers(kept_boxes: np.ndarray, pool: int,
                 ) -> list[tuple[int, int]]:
        out = []
        for y0, x0, y1, x1 in np.asarray(kept_boxes, np.float32):
            cy = int((y0 + y1) / 2.0 - 0.5)     # back to the cell index
            cx = int((x0 + x1) / 2.0 - 0.5)
            out.append((cy * pool + pool // 2, cx * pool + pool // 2))
        return out
