"""Face-recognition models of the pipeline (counterpart of
``repro.core.facerec``).

A blob detector (mean-pooled brightness heatmap), a thumbnail embedder
(two-layer MLP, the FaceNet stand-in) and a nearest-centroid classifier
over a gallery (the "SVM"). The embedder's two products go through the
hand-written matmul kernel (:func:`repro_torch.kernels.ops.matmul`) and
the unfused chain's crop resize through the resize kernel; with
``fast_path`` the :class:`FusedIdentifier` folds resize and crop norm
into the first layer, exactly as the reference does.

Weights: the reference draws them from ``jax.random``, which PyTorch
cannot reproduce. :func:`embedder_params_from_numpy` carries the
reference's ``w1``/``w2`` across as numpy arrays; without them the port
draws its own from a ``torch.Generator``. The gallery is built by the
same code from the same numpy seed in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.events import categorize
from repro_torch.kernels import ops
from repro_torch.kernels.resize import _interp_matrix
from repro_torch.preprocess.stage import NormSpec, PreprocessStage

THUMB = 32          # thumbnail side (paper: 160x160)
EMBED_DIM = 128     # paper: 128-byte feature vector
CROP_SIZE = 48      # detection crop window fed to the THUMB resize
DETECT_POOL = 8     # heatmap downsampling factor (full-res / pool)


def stage_category(stage: str) -> str:
    """Face-pipeline stage name -> {pre, ai, post, transfer, queue}."""
    return categorize(stage)


def _pad_pow2(n: int) -> int:
    """Batch-size bucket: next power of two."""
    return 1 << (n - 1).bit_length()


def _pad_rows_pow2(arr: np.ndarray) -> np.ndarray:
    """Zero-pad the leading dim to its power-of-two bucket (every batch
    entry point pads through here and slices back to the true B)."""
    pad = _pad_pow2(len(arr)) - len(arr)
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)], axis=0)
    return arr


def detect_heatmap_batch(frames: torch.Tensor,
                         pool: int = DETECT_POOL) -> torch.Tensor:
    """Brightness heatmaps at 1/pool resolution. frames: (B, H, W, 3) uint8."""
    x = frames.float().mean(-1)
    B, H, W = x.shape
    x = x[:, :H - H % pool, :W - W % pool]
    return x.reshape(B, H // pool, pool, W // pool, pool).mean((2, 4))


def crop_stacks(frames: list[np.ndarray],
                centers_per_frame: list[list[tuple[int, int]]],
                size: int = CROP_SIZE) -> tuple[np.ndarray | None, list[int]]:
    """Host-side crop extraction shared by the fused and unfused paths:
    every detection becomes a (size, size, C) window clipped to the
    frame, zero-padded when the frame is smaller. Returns the stacked
    crops (or None) and the per-frame face counts."""
    half = size // 2
    crops, counts = [], []
    for frame, centers in zip(frames, centers_per_frame):
        H, W, C = frame.shape
        counts.append(len(centers))
        for y, x in centers:
            y0 = int(np.clip(y - half, 0, max(0, H - size)))
            x0 = int(np.clip(x - half, 0, max(0, W - size)))
            crop = frame[y0:y0 + size, x0:x0 + size]
            if crop.shape[:2] != (size, size):
                padded = np.zeros((size, size, C), crop.dtype)
                padded[:crop.shape[0], :crop.shape[1]] = crop
                crop = padded
            crops.append(crop)
    if not crops:
        return None, counts
    return np.stack(crops), counts


def _regroup(flat: list, counts: list[int]) -> list[list]:
    out, i = [], 0
    for n in counts:
        out.append(list(flat[i:i + n]))
        i += n
    return out


def crop_thumbnails_batch(frames: list[np.ndarray],
                          centers_per_frame: list[list[tuple[int, int]]],
                          size: int = CROP_SIZE, *,
                          device="cuda") -> list[list[np.ndarray]]:
    """Crop every detection and resize the whole stack to THUMB in one
    resize kernel call on ``device``; thumbnails grouped per frame."""
    crops, counts = crop_stacks(frames, centers_per_frame, size)
    if crops is None:
        return [[] for _ in frames]
    stack = _pad_rows_pow2(crops.astype(np.float32))
    x = torch.from_numpy(stack).to(resolve_device(device))
    thumbs = ops.resize_bilinear(x, THUMB, THUMB).cpu().numpy()[:len(crops)]
    return _regroup(thumbs, counts)


def embedder_params_from_numpy(params: dict) -> dict[str, torch.Tensor]:
    """{"w1": (THUMB*THUMB*3, 256), "w2": (256, EMBED_DIM)} arrays (e.g.
    the reference ``Embedder``'s) -> float32 CPU tensors for ``params=``."""
    return {k: torch.from_numpy(np.array(params[k], np.float32))
            for k in ("w1", "w2")}


class Embedder(nn.Module):
    """Feature extraction: fixed random projection MLP (FaceNet stand-in).

    ``embed_batch`` is one call over a (B, THUMB, THUMB, 3) stack, two
    matmul kernel launches; tanh is applied outside the first product, as
    in the reference. ``norm`` is the crop normalization (default
    ``/255``), normally the preprocess stage's ``crop_norm``.
    """

    def __init__(self, seed: int = 7, norm: NormSpec | None = None, *,
                 params: dict | None = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        d_in = THUMB * THUMB * 3
        if params is None:
            g = torch.Generator().manual_seed(seed)
            params = {"w1": torch.randn((d_in, 256), generator=g) / d_in**0.5,
                      "w2": torch.randn((256, EMBED_DIM), generator=g) / 16.0}
        self.register_buffer("w1", params["w1"].float().to(dev).contiguous())
        self.register_buffer("w2", params["w2"].float().to(dev).contiguous())
        self.norm = norm or NormSpec(to_unit=True)

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def forward(self, thumbs: torch.Tensor) -> torch.Tensor:
        x = thumbs.float()
        if self.norm.to_unit:
            x = x / 255.0
        if any(m != 0.0 for m in self.norm.mean):
            x = x - torch.tensor(self.norm.mean, dtype=torch.float32,
                                 device=x.device)
        if any(s != 1.0 for s in self.norm.std):
            x = x / torch.tensor(self.norm.std, dtype=torch.float32,
                                 device=x.device)
        x = x.reshape(x.shape[0], -1).contiguous()
        h = torch.tanh(ops.matmul(x, self.w1))
        e = ops.matmul(h, self.w2)
        # clamp: zero-padded rows would otherwise normalize 0/0 -> NaN
        return e / torch.clamp_min(
            torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-12)

    def embed_batch(self, thumbs: np.ndarray) -> np.ndarray:
        """thumbs: (B, THUMB, THUMB, 3) -> (B, EMBED_DIM), unit rows; B is
        padded to its power-of-two bucket."""
        B = thumbs.shape[0]
        x = torch.from_numpy(np.ascontiguousarray(_pad_rows_pow2(thumbs)))
        return self(x.to(self.device)).cpu().numpy()[:B]


class Classifier:
    """Nearest-centroid over a gallery of known identities (host NumPy)."""

    def __init__(self, gallery: dict[str, np.ndarray]):
        self.names = list(gallery)
        self.mat = np.stack([gallery[n] for n in self.names])

    def identify_batch(self, embs: np.ndarray) -> list[tuple[str, float]]:
        """One (B, G) similarity matmul instead of B gallery sweeps."""
        sims = embs @ self.mat.T
        idx = np.argmax(sims, axis=1)
        return [(self.names[i], float(sims[b, i]))
                for b, i in enumerate(idx)]


class FusedIdentifier:
    """Crop -> resize -> embed -> classify as one device program.

    Bilinear resize is linear, so ``thumb = Ry @ crop @ Rx^T`` per channel:
    the interpolation operator, the crop normalization's scale and the
    flatten are pre-composed with the embedder's first layer once at init
    (in float64 NumPy, as the reference does), and the normalization's
    offset becomes a bias on the first product's fused epilogue. Per call
    only the uint8 crop stack goes up and a (name-index, score) pair per
    face comes down; the two products are matmul kernel launches, the
    first with the fused tanh epilogue.
    """

    def __init__(self, embedder: Embedder, classifier: Classifier,
                 crop_size: int = CROP_SIZE,
                 preprocess: PreprocessStage | None = None):
        self.size = crop_size
        self.names = classifier.names
        self.device = embedder.device
        norm = preprocess.crop_norm if preprocess is not None \
            else embedder.norm
        ry = _interp_matrix(THUMB, crop_size).astype(np.float64)
        rx = _interp_matrix(THUMB, crop_size).astype(np.float64)
        w1r = embedder.w1.cpu().numpy().astype(np.float64) \
            .reshape(THUMB, THUMB, 3, -1)
        # optimize=True: contract pairwise (Ry first, then Rx) instead of
        # a naive 6-index loop — ~100x faster, identical result
        scale64 = 1.0 / ((255.0 if norm.to_unit else 1.0)
                         * np.asarray(norm.std, np.float64))
        w1f = np.einsum("ts,uv,tucj->svcj", ry, rx, w1r, optimize=True) \
            * scale64[None, None, :, None]
        self.w1f = torch.from_numpy(
            w1f.reshape(crop_size * crop_size * 3, -1).astype(np.float32)) \
            .to(self.device)
        offset = -np.asarray(norm.mean, np.float64) \
            / np.asarray(norm.std, np.float64)
        if np.any(offset):
            # bias_j = sum_{ty,tx,c} v_c * w1[(ty,tx,c), j]: the affine
            # offset is spatially constant, so it bypasses the resize
            self.b1 = torch.from_numpy(
                np.einsum("c,tucj->j", offset, w1r).astype(np.float32)) \
                .to(self.device)
        else:
            self.b1 = None
        self.w2 = embedder.w2
        self.gal_t = torch.from_numpy(
            np.ascontiguousarray(classifier.mat.T)).to(self.device)

    def identify_crops(self, crops: np.ndarray) -> list[tuple[str, float]]:
        """crops: (B, size, size, 3) any real dtype -> [(name, score)]; B is
        padded to its power-of-two bucket. The host stacking, the upload,
        :meth:`score` on the device, the fetch and :meth:`named`."""
        B = crops.shape[0]
        x = torch.from_numpy(np.ascontiguousarray(_pad_rows_pow2(crops))) \
            .to(self.device)
        idx, score = self.score(x)
        return self.named(idx.cpu().numpy()[:B], score.cpu().numpy()[:B])

    def score(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The device program: a crop stack (B, size, size, 3) on the
        identifier's device -> (gallery index, score) per row, both (B,)
        there; two matmul launches."""
        x = x.reshape(x.shape[0], -1).float()
        h = ops.matmul(x, self.w1f, bias=self.b1, epilogue="tanh")
        e = ops.matmul(h, self.w2)
        e = e / torch.clamp_min(
            torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-12)
        sims = e @ self.gal_t
        score, idx = torch.max(sims, dim=1)
        return idx, score

    def named(self, idx: np.ndarray, score: np.ndarray
              ) -> list[tuple[str, float]]:
        """Fetched (gallery index, score) rows -> [(name, score)]."""
        return [(self.names[i], float(s)) for i, s in zip(idx, score)]

    def identify_batch(self, frames: list[np.ndarray],
                       centers_per_frame: list[list[tuple[int, int]]],
                       ) -> list[list[tuple[str, float]]]:
        """Fused analogue of crop_thumbnails_batch + Embedder.embed_batch
        + Classifier.identify_batch, grouped per frame like the centers."""
        crops, counts = crop_stacks(frames, centers_per_frame, self.size)
        if crops is None:
            return [[] for _ in frames]
        return _regroup(self.identify_crops(crops), counts)


@dataclass
class IdentifyStack:
    """Everything one deployment of the identify stage needs."""
    embedder: Embedder
    classifier: Classifier
    fused: FusedIdentifier | None
    preprocess: PreprocessStage


def build_identify_stack(seed: int = 0, gallery_size: int = 8,
                         fast_path: bool = True, placement: str = "host",
                         log=None, *, params: dict | None = None,
                         device="cuda") -> IdentifyStack:
    """The identification stage's model stack, built once.

    The gallery is ``gallery_size`` synthetic identities embedded at init
    from ``np.random.default_rng(seed)``, as in the reference.
    ``params`` carries embedder weights across
    (:func:`embedder_params_from_numpy`); ``device`` is where the models
    and the device placement run.
    """
    preprocess = PreprocessStage(placement, log=log, device=device)
    embedder = Embedder(norm=preprocess.crop_norm, params=params,
                        device=device)
    rng = np.random.default_rng(seed)
    thumbs = rng.uniform(0, 255, (gallery_size, THUMB, THUMB, 3))
    gallery_embs = embedder.embed_batch(thumbs.astype(np.float32))
    classifier = Classifier(
        {f"person_{i}": gallery_embs[i] for i in range(gallery_size)})
    fused = (FusedIdentifier(embedder, classifier, preprocess=preprocess)
             if fast_path else None)
    return IdentifyStack(embedder, classifier, fused, preprocess)
