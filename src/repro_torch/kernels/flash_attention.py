"""Flash attention (prefill): CUDA kernel and plain version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
The kernels are in ``csrc/flash_attention.cu``; its source note says what
bounds them on an H100 and how their tiles are laid out. Two routes, chosen
by shape (:func:`_route`): bf16 at D = Dv in :data:`TC_WIDTHS` runs on the
tensor cores (wgmma, K/V staged by TMA), fp32 and bf16 at other widths on
the CUDA cores. Unlike the Pallas kernel, which asserts that Sq and Skv
divide its tiles, both mask ragged tiles themselves, so a prompt of any
length goes straight in. :func:`flash_attention` launches a kernel for a
CUDA tensor and takes :func:`flash_attention_plain` only for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_D, MAX_DV = 256, 256          # head widths the CUDA-core kernel takes
# D = Dv the tensor-core kernel is built for: granite's 64, 128 (llama3-8b
# and the other GQA archs), gemma3's 256
TC_WIDTHS = frozenset({64, 128, 256})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _P],
               "flash_attention_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _F, _I, _I, _I, _P]}


def _check_shapes(q, k, v) -> tuple[int, ...]:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("want q (B, Sq, H, D), k (B, Skv, KV, D), "
                         "v (B, Skv, KV, Dv)")
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    if (k.shape[0], k.shape[1], k.shape[2], k.shape[3]) != (B, Skv, KV, D) \
            or v.shape[0] != B or KV == 0 or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    return B, Sq, H, D, Skv, KV, Dv


def _route(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The kernel that takes a CUDA call: ``"wgmma"`` (tensor cores) for
    bfloat16 at D = Dv in :data:`TC_WIDTHS`, ``"simt"`` (CUDA cores) for
    float32 and for bfloat16 at other widths up to MAX_D, MAX_DV. A choice
    by shape, not a fallback: what neither takes raises ValueError."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes bfloat16 or float32, got {dtype}")
    if dtype == torch.bfloat16 and D == Dv and D in TC_WIDTHS:
        return "wgmma"
    if 0 < D <= MAX_D and 0 < Dv <= MAX_DV:
        return "simt"
    raise ValueError(f"flash kernel takes D <= {MAX_D} and Dv <= {MAX_DV}, "
                     f"got D={D}, Dv={Dv}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The same function in plain PyTorch, as the reference's XLA path
    computes it: fp32 scores of ``q * scale`` against the kv heads of each
    group, the masks as NEG_INF, softmax, fp32 P @ V, cast to q's type."""
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    G = H // KV
    scale = (1.0 / D**0.5) if scale is None else scale
    qf = (q.float() * scale).reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Causal/windowed GQA attention: q (B, Sq, H, D), k (B, Skv, KV, D),
    v (B, Skv, KV, Dv) -> (B, Sq, H, Dv) in q's dtype. Query i sits at
    position ``i + q_offset``; kv head of query head h is ``h // (H // KV)``.

    A CPU tensor goes to :func:`flash_attention_plain`; a CUDA tensor to
    the kernel of its route (:func:`_route`), which takes contiguous
    operands of one dtype (16-byte aligned on the wgmma route) and raises on
    anything else. ``launches`` counts the kernel launches,
    ``launches_by_route`` each route's.
    """
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    route = _route(q.dtype, D, Dv)
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash kernel takes contiguous q, k, v of one "
                             "dtype on one device")
        if route == "wgmma" and t.data_ptr() % 16:
            raise ValueError("the wgmma route takes 16-byte aligned q, k, v")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = (1.0 / D**0.5) if scale is None else scale
    window = 0 if window is None else int(window)
    lib = build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        stream = build.stream_ptr(q.device)
        if route == "wgmma":
            rc = lib.flash_attention_wgmma(
                *ptrs, B, Sq, Skv, H, KV, D, float(scale), int(causal),
                window, int(q_offset), stream)
        else:
            rc = lib.flash_attention(
                *ptrs, _DTYPES[q.dtype], B, Sq, Skv, H, KV, D, Dv,
                float(scale), int(causal), window, int(q_offset), stream)
    build.check(lib, rc, f"flash_attention ({route})")
    build.count_launch(flash_attention, route)
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
