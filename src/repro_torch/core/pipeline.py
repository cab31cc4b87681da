"""Live streaming pipeline on PyTorch (counterpart of
``repro.core.pipeline``): the paper's application shape, on the card.

Same stages, threads, broker topics, micro-batchers, spans and
transfer-byte bookkeeping as the reference; what ran as jitted JAX
programs runs here as PyTorch on ``device`` with the hand-written CUDA
kernels (decode and letterbox with ``placement="device"``, the
embedder's products, the unfused chain's crop resize). Host<->device
crossings are explicit ``.to(device)`` and ``.cpu()`` calls, and every
taxed span closes only after its result is on the host, so asynchronous
launches cannot leak AI time into the ``post`` or ``transfer`` buckets.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import facerec
from repro_torch.core.batching import Batcher, BatchStats
from repro_torch.core.events import EventLog, Timer
from repro_torch.data.video import VideoStream
from repro_torch.preprocess import host as pre_host

_STOP = object()


@dataclass
class PipelineResult:
    log: EventLog
    identities: list
    detected: int
    ground_truth: int
    matched: int
    batch_stats: dict = field(default_factory=dict)   # stage -> BatchStats

    @property
    def recall(self) -> float:
        return self.matched / self.ground_truth if self.ground_truth else 1.0

    def ai_tax(self) -> dict:
        return self.log.ai_tax(ai_stages={"detect", "identify"},
                               category_of=facerec.stage_category)


class StreamingPipeline:
    """The reference's constructor, plus ``device`` (default the card;
    without one it raises unless ``device="cpu"``, which runs every
    kernel's plain PyTorch version)."""

    def __init__(self, *, n_frames: int = 60, fuse_ingest_detect: bool = True,
                 n_identify_workers: int = 2, seed: int = 0,
                 gallery_size: int = 8, batch_size: int = 1,
                 batch_timeout_ms: float = 5.0, fast_path: bool = True,
                 placement: str = "host", device="cuda"):
        self.device = resolve_device(device)
        self.n_frames = n_frames
        self.fused = fuse_ingest_detect
        self.n_workers = n_identify_workers
        self.batch_size = max(1, batch_size)
        self.batch_timeout_s = batch_timeout_ms / 1e3
        self.fast_path = fast_path
        self.video = VideoStream(seed=seed)
        self.log = EventLog()
        stack = facerec.build_identify_stack(
            seed=seed, gallery_size=gallery_size, fast_path=fast_path,
            placement=placement, log=self.log, device=self.device)
        self.embedder = stack.embedder
        self.classifier = stack.classifier
        self.fused_identifier = stack.fused
        self.preprocess = stack.preprocess
        # broker topics (queues); maxsize models bounded broker capacity
        self.faces_topic: queue.Queue = queue.Queue(maxsize=4096)
        self.frames_topic: queue.Queue = queue.Queue(maxsize=1024)
        self.identities: list = []
        self._ident_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.batch_stats: dict[str, BatchStats] = {}
        self.detected = 0
        self.ground_truth = 0
        self.matched = 0

    def _merge_stats(self, stage: str, stats: BatchStats) -> None:
        with self._stats_lock:
            base = self.batch_stats.get(stage, BatchStats())
            self.batch_stats[stage] = base.merge(stats)

    def _log_batch_transfers(self, items, boundary: str, h2d: int,
                             d2h: int) -> None:
        self.log.log_batch_transfers([it[0] for it in items], boundary,
                                     h2d, d2h)

    # ---- stages ------------------------------------------------------------

    def _ingest_frames(self):
        """Decode + letterbox resize (pre-processing only — no AI); the
        camera's ``rgb_to_yuv`` stays outside every taxed span."""
        batcher = (Batcher(batch_size=self.batch_size,
                           timeout_s=self.batch_timeout_s)
                   if self.fused else None)
        for i in range(self.n_frames):
            frame = self.video.next_frame()
            H, W = frame.pixels.shape[:2]
            yuv = pre_host.rgb_to_yuv(frame.pixels)[None]    # wire format
            small_f = self.preprocess.ingest(yuv, H // 2, W // 2,
                                             rids=[frame.index])[0]
            with Timer(self.log, frame.index, "ingest",
                       payload_bytes=frame.pixels.nbytes):
                small = np.clip(small_f, 0, 255).astype(np.uint8)
            item = (frame.index, small, frame.true_boxes, time.perf_counter())
            if self.fused:
                if (batch := batcher.push(item)) is not None:
                    self._log_frame_waits(batch)
                    self._detect_batch(batch)
            else:
                self.frames_topic.put(item)
        if self.fused:
            if (tail := batcher.flush()) is not None:
                self._log_frame_waits(tail)
                self._detect_batch(tail)
            self._merge_stats("detect", batcher.stats)
        else:
            self.frames_topic.put(_STOP)

    def _log_frame_waits(self, batch):
        t = time.perf_counter()
        for rid, small, _boxes, t_q in batch:
            self.log.log(rid, "wait_frames", t_q, t,
                         payload_bytes=small.nbytes)

    def _detect_loop(self):
        batcher = Batcher(self.frames_topic, batch_size=self.batch_size,
                          timeout_s=self.batch_timeout_s, stop=_STOP)
        for batch in batcher:
            self._log_frame_waits(batch)
            self._detect_batch(batch)
        self._merge_stats("detect", batcher.stats)

    def _detect_batch(self, items):
        """Heatmap (``detect``, AI) + threshold/NMS (``post_nms``) + crop
        (``pre_crop``) over a stacked frame batch."""
        B = len(items)
        rids = [it[0] for it in items]
        frames = [it[1] for it in items]
        smalls = np.stack(frames)
        t0 = time.perf_counter()
        x = torch.from_numpy(facerec._pad_rows_pow2(smalls)).to(self.device)
        hms = facerec.detect_heatmap_batch(x).cpu().numpy()[:B]
        t1 = time.perf_counter()
        self.log.log_batch_span(rids, "detect", t0, t1,
                                payload_bytes=smalls[0].nbytes)
        centers_per = self.preprocess.postprocess(
            hms, facerec.DETECT_POOL, rids=rids)
        t2 = time.perf_counter()
        if self.fast_path:
            crops, counts = facerec.crop_stacks(frames, centers_per)
            faces_per = (facerec._regroup(crops, counts) if crops is not None
                         else [[] for _ in items])
        else:
            faces_per = facerec.crop_thumbnails_batch(frames, centers_per,
                                                      device=self.device)
        t3 = time.perf_counter()
        crop_bytes = sum(f.nbytes for faces in faces_per for f in faces)
        self.log.log_batch_span(rids, "pre_crop", t2, t3,
                                payload_bytes=crop_bytes, split_payload=True)
        Bp = facerec._pad_pow2(B)
        H, W = smalls.shape[1:3]
        pool = facerec.DETECT_POOL
        self._log_batch_transfers(
            items, "detect",
            h2d=Bp * H * W * 3 * smalls.itemsize,
            d2h=Bp * (H // pool) * (W // pool) * 4)
        n_faces = sum(len(c) for c in centers_per)
        if not self.fast_path and n_faces:
            Np = facerec._pad_pow2(n_faces)
            crop_px = facerec.CROP_SIZE * facerec.CROP_SIZE * 3
            thumb_px = facerec.THUMB * facerec.THUMB * 3
            self._log_batch_transfers(items, "crop_resize",
                                      h2d=Np * crop_px * 4,
                                      d2h=Np * thumb_px * 4)
        for (rid, _small, true_boxes, _), centers, faces in zip(
                items, centers_per, faces_per):
            with self._stats_lock:
                self.ground_truth += len(true_boxes)
                self.detected += len(centers)
                # match detections to ground truth (within 1.5x blob size)
                for (ty, tx, ts) in true_boxes:
                    if any(abs(cy - ty / 2) < 1.5 * ts
                           and abs(cx - tx / 2) < 1.5 * ts
                           for cy, cx in centers):
                        self.matched += 1
            for face in faces:
                self.faces_topic.put((rid, face, time.perf_counter()))

    def _identify_loop(self):
        batcher = Batcher(self.faces_topic, batch_size=self.batch_size,
                          timeout_s=self.batch_timeout_s, stop=_STOP)
        for batch in batcher:
            t_deq = time.perf_counter()
            for rid, face, t_q in batch:
                self.log.log(rid, "wait", t_q, t_deq,
                             payload_bytes=face.nbytes)
            B = len(batch)
            stack = np.stack([face for _, face, _ in batch])
            t0 = time.perf_counter()
            if self.fused_identifier is not None:
                named = self.fused_identifier.identify_crops(stack)
            else:
                embs = self.embedder.embed_batch(stack)
                named = self.classifier.identify_batch(embs)
            t1 = time.perf_counter()
            Bp = facerec._pad_pow2(B)
            if self.fused_identifier is not None:
                # downlink: one int32 name-index + one f32 score per row
                self._log_batch_transfers(batch, "identify_fused",
                                          h2d=Bp * stack[0].nbytes,
                                          d2h=Bp * (np.int32().nbytes
                                                    + np.float32().nbytes))
            else:
                self._log_batch_transfers(batch, "embed",
                                          h2d=Bp * stack[0].nbytes,
                                          d2h=Bp * facerec.EMBED_DIM * 4)
            self.log.log_batch_span([rid for rid, _, _ in batch],
                                    "identify", t0, t1,
                                    payload_bytes=stack[0].nbytes)
            results = [(rid, name, sim) for (rid, _, _), (name, sim)
                       in zip(batch, named)]
            with self._ident_lock:
                self.identities.extend(results)
        self._merge_stats("identify", batcher.stats)

    # ---- run ---------------------------------------------------------------

    def run(self) -> PipelineResult:
        workers = [threading.Thread(target=self._identify_loop)
                   for _ in range(self.n_workers)]
        for w in workers:
            w.start()
        det = None
        if not self.fused:
            det = threading.Thread(target=self._detect_loop)
            det.start()
        self._ingest_frames()
        if det is not None:
            det.join()
        for _ in workers:
            self.faces_topic.put(_STOP)
        for w in workers:
            w.join()
        return PipelineResult(self.log, self.identities, self.detected,
                              self.ground_truth, self.matched,
                              dict(self.batch_stats))
