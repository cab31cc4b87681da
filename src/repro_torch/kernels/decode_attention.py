"""Decode attention (one token against a KV cache): CUDA kernel and plain
version.

Counterpart of ``repro.kernels.decode_attention`` (the Pallas TPU kernel).
The kernels are in ``csrc/decode_attention.cu``; its source note says what
bounds them on an H100 and how they split the cache across blocks. Two
routes, chosen by shape (:func:`_route`): bf16 with head widths that are
multiples of 16 runs on the tensor cores (mma.sync, the cache staged by
16-byte cp.async), fp32 and bf16 at other widths on the CUDA cores. The
cache length L need not be a multiple of any tile. A row with
``kv_len = 0`` gives exact zeros, the Pallas kernel's contract (the
reference's XLA path gives the mean of V there). The blocks along L
(``n_split``) are the launch plan: a CUDA call takes it from
:mod:`repro_torch.kernels.autotune`'s cache (:func:`split_l` is its
candidates' anchor), or from the caller, and :func:`check_plan` refuses one
the kernel would not take. :func:`decode_attention` launches a kernel for a
CUDA tensor and takes :func:`decode_attention_plain` only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed.sharding import shard, sharded_context
from repro_torch.kernels import autotune, build

NEG_INF = -1e30
# query heads per kv head -> widest D, Dv the kernels are built for (the
# ported configs: whisper-large-v3 G = 1 (MHA), D = 64; llama3-8b and
# jamba G = 4, D = 128; qwen2.5-14b G = 5,
# D = 128; chameleon-34b and qwen1.5-110b G = 8, D = 128; granite-moe-3b
# G = 3, D = 64; gemma3-12b G = 2, D = 256; the smoke configs G = 2, D = 16,
# which keep their own D <= 32 instances)
WIDTHS = {1: 64, 2: 256, 3: 64, 4: 128, 5: 128, 8: 128}
TC_MULTIPLE = 16                 # the mma route's D, Dv: multiples of its k step
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _F, _I, _I, _P],
               "decode_attention_mma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _F, _I, _I, _P]}


def _check_shapes(q, k, v, kv_len) -> tuple[int, ...]:
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("want q (B, 1, H, D), k (B, L, KV, D), v (B, L, KV, Dv)")
    B, _, H, D = q.shape
    _, L, KV, Dv = v.shape
    if tuple(k.shape) != (B, L, KV, D) or v.shape[0] != B or KV == 0 or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if tuple(kv_len.shape) != (B,):
        raise ValueError(f"kv_len must be ({B},), got {tuple(kv_len.shape)}")
    return B, H, D, L, KV, Dv


def _route(dtype: torch.dtype, G: int, D: int, Dv: int) -> str:
    """The kernel that takes a CUDA call with G query heads per kv head:
    ``"mma"`` (tensor cores) for bfloat16 with D, Dv multiples of 16,
    ``"simt"`` (CUDA cores) for float32 and other bfloat16 widths; both only
    for D, Dv up to ``WIDTHS[G]``. A choice by shape, not a fallback: what
    neither takes raises ValueError."""
    if dtype not in _DTYPES:
        raise ValueError(f"decode kernel takes bfloat16 or float32, got {dtype}")
    if not (0 < D <= WIDTHS.get(G, 0) and 0 < Dv <= WIDTHS.get(G, 0)):
        raise ValueError(f"decode kernel takes H/KV -> widest D, Dv in "
                         f"{WIDTHS}; got G={G}, D={D}, Dv={Dv}")
    if dtype == torch.bfloat16 and D % TC_MULTIPLE == 0 \
            and Dv % TC_MULTIPLE == 0:
        return "mma"
    return "simt"


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_len: torch.Tensor, window: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 scores of ``q * scale``
    against each kv head's cache, entries outside
    ``[kv_len - window, kv_len)`` masked, then the softmax written as the
    kernel's ``exp(s - m) / max(l, 1e-30)`` with masked entries exactly 0,
    so that a row with ``kv_len = 0`` gives zeros."""
    B, H, D, L, KV, Dv = _check_shapes(q, k, v, kv_len)
    G = H // KV
    scale = (1.0 / D**0.5) if scale is None else scale
    if sharded_context():
        # on a mesh the query's heads may be split where its (KV, G)
        # grouping does not divide (8 kv heads on a 16-way axis), which
        # DTensor cannot reshape: the one query token takes every head
        q = shard(q, "batch", None, None, None)
    qf = (q[:, 0].float() * scale).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    pos = torch.arange(L, device=q.device)[None, :]
    n = kv_len.to(q.device, torch.int64)[:, None]
    valid = pos < n
    if window is not None:
        valid &= pos > n - 1 - window
    valid = valid[:, None, None]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / torch.clamp_min(l, 1e-30)
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def split_l(B: int, KV: int, L: int, n_sm: int) -> int:
    """Blocks along L for each (row, kv head): enough for about two blocks
    an SM, and at least 128 cache entries a block."""
    return max(1, min(-(-2 * n_sm // (B * KV)), -(-L // 128)))


def check_plan(L: int, plan: dict) -> int:
    """``plan``'s n_split, 1 to ceil(L / 128) (at least 128 cache entries a
    block but for one block), or ValueError."""
    if set(plan) != {"n_split"} or not \
            1 <= int(plan["n_split"]) <= max(1, -(-L // 128)):
        raise ValueError(f"decode plan {plan} is not one the kernel takes "
                         f"at L = {L}")
    return int(plan["n_split"])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor, window: int | None = None,
                     scale: float | None = None,
                     plan: dict | None = None) -> torch.Tensor:
    """One query token per row against a (B, L, KV, ·) cache: q (B, 1, H, D),
    ``kv_len`` (B,) valid entries per row, optional ``window`` over the last
    entries -> (B, 1, H, Dv) in q's dtype.

    A CPU tensor goes to :func:`decode_attention_plain`; a CUDA tensor to
    the kernel of its route (:func:`_route`), which takes contiguous q, k, v
    of one dtype and raises on anything else, launched with ``plan`` or,
    for None, the autotuned plan of the shape (``last_plan`` keeps the one
    launched). A plan the kernel does not take raises on either device.
    ``launches`` counts the launches, ``launches_by_route`` each route's.
    """
    B, H, D, L, KV, Dv = _check_shapes(q, k, v, kv_len)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if plan is not None:
        check_plan(L, plan)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len=kv_len, window=window,
                                      scale=scale)
    build.refuse_grad("decode_attention", q, k, v)
    route = _route(q.dtype, H // KV, D, Dv)
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("decode kernel takes contiguous q, k, v of one "
                             "dtype on one device")
        if route == "mma" and t.data_ptr() % 16:
            raise ValueError("the mma route takes 16-byte aligned q, k, v")
    if kv_len.device != q.device:
        raise ValueError("kv_len must be on q's device")
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lens = kv_len.to(torch.int32).contiguous()
    if plan is None:
        plan = autotune.decode_plan(B, KV, H // KV, D, Dv, L, str(q.dtype),
                                    _sm_count(q.device))
    n_split = check_plan(L, plan)
    part = (torch.empty(B * KV * n_split * (H // KV) * (2 + Dv),
                        dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    scale = (1.0 / D**0.5) if scale is None else scale
    window = 0 if window is None else int(window)
    lib = build.library("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                out.data_ptr(), part.data_ptr() if part is not None else None)
        stream = build.stream_ptr(q.device)
        if route == "mma":
            rc = lib.decode_attention_mma(*ptrs, B, L, H, KV, D, Dv,
                                          float(scale), window, n_split,
                                          stream)
        else:
            rc = lib.decode_attention(*ptrs, _DTYPES[q.dtype], B, L, H, KV, D,
                                      Dv, float(scale), window, n_split,
                                      stream)
    build.check(lib, rc, f"decode_attention ({route})")
    build.count_launch(decode_attention, route)
    decode_attention.last_plan = plan
    return out


decode_attention.last_plan = None
decode_attention.launches = 0
decode_attention.launches_by_route = {"mma": 0, "simt": 0}
