"""Public kernel entry points of the port (counterpart of
``repro.kernels.ops`` for the face path and the LM serving path: dense
attention models, RWKV6 and the Mamba layers of the hybrid family).

Dispatch is by the tensor's device and nothing else: a CPU tensor runs
the plain PyTorch version, a CUDA tensor runs the hand-written CUDA
kernel or the call raises. There is no switch that sends a CUDA tensor
to the plain version, and no block-size arguments: the kernels fix
their own tiles.

Under autograd (grad enabled, an input requiring it) :func:`attention`
runs flash attention's forward and backward kernels
(:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`), and
:func:`rwkv_scan` and :func:`mamba_scan` theirs
(:class:`~repro_torch.kernels.linear_scan.RwkvScanFn`,
:class:`~repro_torch.kernels.linear_scan.MambaScanFn`); the other ops
raise ``RuntimeError`` on a CUDA tensor there, since their kernels have
no backward. On the CPU all of them are plain PyTorch, which autograd
differentiates.

On a mesh of more than one device the models hand these ops DTensors,
which only the plain versions take (on CPU meshes: the tests and the dry
run); a DTensor on the card raises here rather than reach a kernel, whose
wrapper reads raw pointers (the card runs a mesh of one, whose tensors
stay plain).

Attention, decode attention and the two scans (with their decode steps)
run inside :func:`repro_torch.roofline.op_cost.region`: under the cost
model's counter the bytes of their plain versions are the ones a kernel
replaces (``flash_bytes``); without one the region does nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import resize as _rs
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.roofline.op_cost import region


def _no_dtensor_on_card(*ts) -> None:
    """Raise for a DTensor on a CUDA device (see the module docstring)."""
    for t in ts:
        if is_dtensor(t) and t.device.type == "cuda":
            raise NotImplementedError(
                "the CUDA kernels take plain tensors; on the card the port "
                "runs a mesh of one device")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """Prefill attention: q (B, Sq, H, D), k (B, Skv, KV, D),
    v (B, Skv, KV, Dv) -> (B, Sq, H, Dv), GQA by ``h // (H // KV)``,
    causal and/or sliding-window masks, query i at ``i + q_offset``."""
    _no_dtensor_on_card(q, k, v)
    with region():
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """One new token per row against a KV cache: q (B, 1, H, D), k/v
    (B, L, KV, ·), ``kv_len`` (B,) valid entries -> (B, 1, H, Dv)."""
    _no_dtensor_on_card(q, k, v)
    with region():
        return _da.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                    scale=scale)


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


def rwkv_scan(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, u: torch.Tensor,
              h0: torch.Tensor | None = None):
    """RWKV6 scan: r, w, k (B, S, H, K), v (B, S, H, V), bonus u (H, K),
    optional state h0 (B, H, K, V) -> (o (B, S, H, V) in v's dtype, final
    state (B, H, K, V) float32)."""
    _no_dtensor_on_card(r, w, k, v)
    with region():
        return _ls.rwkv_scan(r, w, k, v, u, h0)


def rwkv_decode_step(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, u: torch.Tensor, h: torch.Tensor):
    """One RWKV6 token per row: r, w, k (B, H, K), v (B, H, V), state h
    (B, H, K, V) float32, updated in place -> (o (B, H, V), h)."""
    _no_dtensor_on_card(r, w, k, v, h)
    with region():
        return _ls.rwkv_decode_step(r, w, k, v, u, h)


def mamba_scan(delta: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
               Ct: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor | None = None):
    """Mamba selective scan: delta, x (B, S, Di), A (Di, N), Bt, Ct
    (B, S, N), optional state h0 (B, Di, N) -> (y (B, S, Di) in x's dtype,
    final state (B, Di, N) float32)."""
    _no_dtensor_on_card(delta, x)
    with region():
        return _ls.mamba_scan(delta, A, Bt, Ct, x, h0)


def mamba_decode_step(delta: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
                      Ct: torch.Tensor, x: torch.Tensor, h: torch.Tensor):
    """One Mamba token per row: delta, x (B, Di), Bt, Ct (B, N), state h
    (B, Di, N) float32, updated in place -> (y (B, Di), h)."""
    _no_dtensor_on_card(delta, x, h)
    with region():
        return _ls.mamba_decode_step(delta, A, Bt, Ct, x, h)
