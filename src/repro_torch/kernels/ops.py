"""Public kernel entry points of the port (counterpart of
``repro.kernels.ops`` for the face path).

Dispatch is by the tensor's device and nothing else: a CPU tensor runs
the plain PyTorch version, a CUDA tensor runs the hand-written CUDA
kernel or the call raises. There is no switch that sends a CUDA tensor
to the plain version, and no block-size arguments: the kernels fix
their own tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import resize as _rs


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           bias: torch.Tensor | None = None,
           epilogue: str = "none") -> torch.Tensor:
    """(M, K) @ (K, N) with float32 accumulation; ``bias`` ((N,)) and
    ``epilogue`` (``"none"``/``"tanh"``) fused onto the fp32 sum."""
    return _mm.matmul(a, b, bias=bias, epilogue=epilogue)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize, align_corners=False: (..., H, W, C) ->
    (..., out_h, out_w, C)."""
    return _rs.resize_bilinear(img, out_h, out_w)
