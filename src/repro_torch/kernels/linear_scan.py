"""RWKV6 scan (matrix-state linear attention with data-dependent decay):
CUDA kernel and plain versions.

Counterpart of ``repro.kernels.linear_scan.rwkv_scan`` (the Pallas TPU
kernel; its contract is ``repro.kernels.ref.rwkv_scan``). The kernel is
``csrc/linear_scan.cu``; its source note says what bounds it on an H100
and why one thread owns one column of the state. It reads the
projections in their (B, S, H, .) layout and takes any S >= 1: the
engine prefills at the raw prompt length and decodes at S = 1, where
:func:`rwkv_decode_step` writes the new state into the cache in place.
:func:`rwkv_scan` and :func:`rwkv_decode_step` launch the kernel for CUDA
tensors and take the plain versions only for CPU tensors. The Mamba scan
(``mamba_scan``, the same module in the reference) comes with the jamba
slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# head widths (K = V) the kernel is built for: rwkv6-3b 64, its smoke config 16
WIDTHS = (16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rwkv_scan": [_P] * 8 + [_I] * 6 + [_P]}


def _check_shapes(r, w, k, v, u, h0) -> tuple[int, int, int, int, int]:
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError("want r, w, k (B, S, H, K) and v (B, S, H, V)")
    B, S, H, K = r.shape
    V = v.shape[-1]
    if (tuple(w.shape) != (B, S, H, K) or tuple(k.shape) != (B, S, H, K)
            or tuple(v.shape[:3]) != (B, S, H) or tuple(u.shape) != (H, K)
            or (h0 is not None and tuple(h0.shape) != (B, H, K, V))):
        raise ValueError(
            f"shapes r {tuple(r.shape)}, w {tuple(w.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, u {tuple(u.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not fit")
    if S < 1:
        raise ValueError("the scan needs at least one step")
    return B, S, H, K, V


def rwkv_scan_plain(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, u: torch.Tensor,
                    h0: torch.Tensor | None = None):
    """The reference's sequential recurrence in float32: for each step,
    kv = k v^T, o = r (h + u kv), h = w h + kv. Returns (o (B, S, H, V) in
    v's dtype, final state (B, H, K, V) float32)."""
    B, S, H, K, V = _check_shapes(r, w, k, v, u, h0)
    h = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if h0 is None else h0.float())
    rf, wf, kf, vf = (t.float() for t in (r, w, k, v))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], h + uf * kv))
        h = wf[:, t, :, :, None] * h + kv
    return torch.stack(outs, dim=1).to(v.dtype), h


def rwkv_decode_step_plain(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, u: torch.Tensor, h: torch.Tensor):
    """One step as the reference's ``ops.rwkv_decode_step`` writes it:
    r, w, k (B, H, K), v (B, H, V), state h (B, H, K, V) float32. The new
    state is written into ``h`` in place; returns (o (B, H, V) in v's
    dtype, h)."""
    rf, wf, kf, vf = (t.float() for t in (r, w, k, v))
    kv = kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", rf,
                     h + u[None, :, :, None].float() * kv)
    h.copy_(wf[..., :, None] * h + kv)
    return o.to(v.dtype), h


def rwkv_scan(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, u: torch.Tensor,
              h0: torch.Tensor | None = None, *,
              state_out: torch.Tensor | None = None):
    """RWKV6 scan: r, w, k (B, S, H, K), v (B, S, H, V), u (H, K), optional
    initial state h0 (B, H, K, V) -> (o (B, S, H, V) in v's dtype, final
    state (B, H, K, V) float32). ``state_out``, when given, is the float32
    tensor the final state is written into, and may be ``h0`` itself.

    A CPU tensor goes to :func:`rwkv_scan_plain`; a CUDA tensor to the
    kernel, which takes contiguous r, k, v of one dtype (bfloat16 or
    float32), float32 w and h0, K = V in :data:`WIDTHS`, and raises on
    anything else. u is widened to float32 here.
    """
    B, S, H, K, V = _check_shapes(r, w, k, v, u, h0)
    if state_out is not None and (tuple(state_out.shape) != (B, H, K, V)
                                  or state_out.dtype != torch.float32):
        raise ValueError("state_out must be a (B, H, K, V) float32 tensor")
    if r.device.type == "cpu":
        o, h = rwkv_scan_plain(r, w, k, v, u, h0)
        if state_out is None:
            return o, h
        return o, state_out.copy_(h)
    if r.dtype not in _DTYPES:
        raise ValueError("rwkv scan kernel takes bfloat16 or float32, got "
                         f"{r.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype or w.dtype != torch.float32:
        raise ValueError("rwkv scan kernel takes r, k, v of one dtype and "
                         "float32 w")
    if K != V or K not in WIDTHS:
        raise ValueError(f"rwkv scan kernel takes K = V in {WIDTHS}; got "
                         f"K={K}, V={V}")
    uf = u.to(torch.float32).contiguous()
    state = (torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
             if state_out is None else state_out)
    tensors = [r, w, k, v, uf, state] + ([] if h0 is None else [h0])
    for t in tensors:
        if t.device != r.device or not t.is_contiguous():
            raise ValueError("rwkv scan kernel takes contiguous tensors on "
                             "one device")
    if h0 is not None and h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32, got {h0.dtype}")
    o = torch.empty((B, S, H, V), dtype=v.dtype, device=r.device)
    lib = build.library("linear_scan", _SIGNATURES)
    with torch.cuda.device(r.device):
        rc = lib.rwkv_scan(
            r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
            uf.data_ptr(), None if h0 is None else h0.data_ptr(),
            o.data_ptr(), state.data_ptr(), _DTYPES[r.dtype], B, S, H, K, V,
            build.stream_ptr(r.device))
    build.check(lib, rc, "rwkv_scan")
    build.count_launch(rwkv_scan)
    return o, state


rwkv_scan.launches = 0


def rwkv_decode_step(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, u: torch.Tensor, h: torch.Tensor):
    """One RWKV6 step per row: r, w, k (B, H, K), v (B, H, V), state h
    (B, H, K, V) float32, updated in place -> (o (B, H, V), h).

    A CPU tensor goes to :func:`rwkv_decode_step_plain`; a CUDA tensor to
    the scan kernel at S = 1 with the state read from and written to
    ``h`` (one launch, counted on :func:`rwkv_scan`).
    """
    if r.device.type == "cpu":
        return rwkv_decode_step_plain(r, w, k, v, u, h)
    o, _ = rwkv_scan(r[:, None], w[:, None], k[:, None], v[:, None], u, h,
                     state_out=h)
    return o[:, 0], h
