"""Flash attention (prefill): CUDA kernel and plain version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
The kernels are in ``csrc/flash_attention.cu``; its source note says what
bounds them on an H100 and how their tiles are laid out. Two routes, chosen
by shape (:func:`_route`): bf16 at (D, Dv) in :data:`TC_WIDTHS` (MLA's
192 | 128 among them) runs on the tensor cores (wgmma, K/V staged by TMA),
fp32 and bf16 at other widths on the CUDA cores. Unlike the Pallas kernel, which asserts that Sq and Skv
divide its tiles, both mask ragged tiles themselves, so a prompt of any
length goes straight in. :func:`flash_attention` launches a kernel for a
CUDA tensor and takes :func:`flash_attention_plain` only for a CPU tensor.

Training: where grad is enabled and q, k or v requires it, a CUDA call goes
through :class:`FlashAttentionFn`, whose forward is the same kernel asked
also for each row's log-sum-exp, and whose backward is the hand-written
kernel of ``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`:
dQ, dK, dV for D, Dv <= :data:`BWD_MAX_D`, on wgmma in bf16 at D = Dv in
:data:`BWD_TC_WIDTHS`, on ``mma.sync`` at other bf16 multiples of 16, on
the CUDA cores otherwise; in bf16 at MLA's (192, 128)
(:data:`BWD_KV128_WIDTHS`) on wgmma with 128 keys a block, each
warpgroup keeping dK and dV of its 64; and in bf16 at gemma3's 256 of
:data:`BWD_SPLIT_WIDTHS` on wgmma with the two warpgroups of a block
splitting dK and dV of the same keys; float32 and other widths above
:data:`BWD_MAX_D` raise).
:func:`flash_attention_bwd_plain` computes the same formulas in plain
PyTorch. The JAX package has no backward kernel: its gradient is XLA's
autodiff of its XLA attention, which autograd of
:func:`flash_attention_plain` is on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.distributed.sharding import sharded_context
from repro_torch.kernels import build

NEG_INF = -1e30
MAX_D, MAX_DV = 256, 256          # head widths the CUDA-core kernel takes
# (D, Dv) the tensor-core kernel is built for: granite's 64, 128 (llama3-8b
# and the other GQA archs), gemma3's 256, and deepseek-v2's MLA (192 | 128)
TC_WIDTHS = frozenset({(64, 64), (128, 128), (256, 256), (192, 128)})
BWD_MAX_D = 128       # widest D, Dv of the backward's wgmma, mma and simt routes
# D = Dv the backward's wgmma kernel is built for: whisper's 64, the llama
# family's 128
BWD_TC_WIDTHS = frozenset({64, 128})
# (D, Dv) above BWD_MAX_D the backward's split wgmma kernel is built for, in
# bf16 only: gemma3's 256 and deepseek-v2's MLA (192 | 128)
BWD_SPLIT_WIDTHS = frozenset({(256, 256), (192, 128)})
# the (D, Dv) of BWD_SPLIT_WIDTHS that the backward's kv128 wgmma kernel
# takes instead (128 keys a block, dK and dV of a warpgroup's 64 keys in
# its registers): deepseek-v2's MLA; the split kernel still takes it when
# forced (as chip_smoke.py times it)
BWD_KV128_WIDTHS = frozenset({(192, 128)})
BWD_TILE = 64                     # q rows a tile of the wgmma backward
Q_CHUNK = 1024                    # query rows a chunk of the plain version
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _I, _P],
               "flash_attention_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _I, _F, _I, _I, _I, _P]}
_BWD_SIGNATURES = {"flash_attention_bwd": [_P] * 11 + [_I] * 8
                   + [_F, _I, _I, _I, _P],
                   "flash_attention_bwd_mma": [_P] * 11 + [_I] * 7
                   + [_F, _I, _I, _I, _P],
                   "flash_attention_bwd_wgmma": [_P] * 11 + [_I] * 6
                   + [_F, _I, _I, _I, _P],
                   "flash_attention_bwd_split": [_P] * 11 + [_I] * 7
                   + [_F, _I, _I, _I, _P],
                   "flash_attention_bwd_kv128": [_P] * 11 + [_I] * 7
                   + [_F, _I, _I, _I, _P]}


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
    bfloat16 at (D, Dv) in :data:`TC_WIDTHS`, ``"simt"`` (CUDA cores) for
    float32 and for bfloat16 at other widths up to MAX_D, MAX_DV. A choice
    by shape, not a fallback: what neither takes raises ValueError."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes bfloat16 or float32, got {dtype}")
    if dtype == torch.bfloat16 and (D, Dv) in TC_WIDTHS:
        return "wgmma"
    if 0 < D <= MAX_D and 0 < Dv <= MAX_DV:
        return "simt"
    raise ValueError(f"flash kernel takes D <= {MAX_D} and Dv <= {MAX_DV}, "
                     f"got D={D}, Dv={Dv}")


def _mask(Sq: int, Skv: int, causal: bool, window, q_offset: int, device):
    """(Sq, Skv) bool: which keys each query row sees."""
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _plain_scores(q, k, v, causal, window, q_offset, scale):
    """fp32 scores (B, KV, G, Sq, Skv) of ``q * scale`` against the kv heads
    of each group, masked entries NEG_INF, and the mask."""
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    scale = (1.0 / D**0.5) if scale is None else scale
    qf = (q.float() * scale).reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    # in place: the product's buffer takes the mask (its backward needs
    # only q and k), not a second float32 copy of the scores
    return s.masked_fill_(~mask, NEG_INF), mask


def _bwd_route(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The backward kernel that takes a CUDA call: ``"wgmma_kv128"``
    (tensor cores, 128 keys a block, each warpgroup keeping dK and dV of
    its 64) for bfloat16 at (D, Dv) in :data:`BWD_KV128_WIDTHS`;
    ``"wgmma_split"`` (tensor cores, the two warpgroups of a block
    splitting dK and dV of the same keys) for bfloat16 at the other (D, Dv)
    of :data:`BWD_SPLIT_WIDTHS`;
    ``"wgmma"`` (tensor cores, warpgroup products fed by TMA) for bfloat16
    at D = Dv in :data:`BWD_TC_WIDTHS`, ``"mma"`` (tensor cores,
    ``mma.sync``) for other bfloat16 widths that are multiples of 16,
    ``"simt"`` (CUDA cores) for float32 and the remaining bfloat16 widths;
    these three for D, Dv up to :data:`BWD_MAX_D`. What none takes raises
    ValueError."""
    if dtype == torch.bfloat16 and (D, Dv) in BWD_KV128_WIDTHS:
        return "wgmma_kv128"
    if dtype == torch.bfloat16 and (D, Dv) in BWD_SPLIT_WIDTHS:
        return "wgmma_split"
    if dtype not in _DTYPES or not (0 < D <= BWD_MAX_D and 0 < Dv <= BWD_MAX_D):
        raise ValueError(f"flash backward kernel takes bfloat16 or float32 "
                         f"with D, Dv <= {BWD_MAX_D}, or bfloat16 at (D, Dv) "
                         f"in {sorted(BWD_SPLIT_WIDTHS)}; got {dtype}, D={D}, "
                         f"Dv={Dv}")
    if dtype == torch.bfloat16 and D == Dv and D in BWD_TC_WIDTHS:
        return "wgmma"
    if dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0:
        return "mma"
    return "simt"


def _chunks(Sq: int, Skv: int, window, q_offset: int):
    """The query chunks of the plain version, as the reference's XLA
    attention scans them (``repro.kernels.ops._xla_attention``): rows in
    chunks of :data:`Q_CHUNK`, and with a window, where Skv exceeds
    ``Q_CHUNK + window``, each chunk's key band of ``Q_CHUNK + window``
    keys (padded to a multiple of 128) that holds every key its rows see.
    One (row start, row stop, key start, key stop, q_offset of the chunk
    against its band) a chunk; one chunk of everything for Sq <=
    :data:`Q_CHUNK`."""
    if Sq <= Q_CHUNK:
        return [(0, Sq, 0, Skv, q_offset)]
    band = Skv
    banded = window is not None and Skv > Q_CHUNK + window
    if banded:
        band = Q_CHUNK + window
        band = min(band + (-band) % 128, Skv)
    out = []
    for r0 in range(0, Sq, Q_CHUNK):
        off = q_offset + r0
        k0 = min(max(off - window + 1, 0), Skv - band) if banded else 0
        out.append((r0, min(r0 + Q_CHUNK, Sq), k0, k0 + band, off - k0))
    return out


def _plain_chunked(q, k, v, causal, window, q_offset, scale, lse: bool):
    """The plain version on plain tensors, query chunk by query chunk
    (:func:`_chunks`): the float32 scores of one chunk against its keys
    live at a time, (B, KV, G, Q_CHUNK, band), as in the reference, never
    the whole (Sq, Skv) square. Returns o (B, Sq, H, Dv) in q's dtype, or
    with ``lse`` each row's log-sum-exp (B, H, Sq) float32. Autograd goes
    through the chunks."""
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    parts = []
    for r0, r1, k0, k1, off in _chunks(Sq, Skv, window, q_offset):
        qc, kc, vc = q[:, r0:r1], k[:, k0:k1], v[:, k0:k1]
        s, _ = _plain_scores(qc, kc, vc, causal, window, off, scale)
        if lse:
            parts.append(torch.logsumexp(s, dim=-1).reshape(B, H, r1 - r0))
        else:
            o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1),
                             vc.float())
            parts.append(o.reshape(B, r1 - r0, H, Dv).to(q.dtype))
        # this chunk's scores go before the next chunk's are made
        del s
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=2 if lse else 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The same function in plain PyTorch, as the reference's XLA path
    computes it: fp32 scores of ``q * scale`` against the kv heads of each
    group, the masks as NEG_INF, softmax, fp32 P @ V, cast to q's type,
    over query chunks of :data:`Q_CHUNK` (:func:`_plain_chunked`)."""
    _check_shapes(q, k, v)
    if sharded_context():
        return _plain_by_heads(q, k, v, causal, window, q_offset, scale)
    return _plain_chunked(q, k, v, causal, window, q_offset, scale, False)


def _plain_by_heads(q, k, v, causal, window, q_offset, scale):
    """The plain version in the reference's sharded layout (its XLA
    attention block, ``repro.kernels.ops._attn_block``), taken under a
    sharding context on a mesh of more than one device: the kv heads
    expanded to H, so that the (B, H, Sq, Skv) float32 scores shard over
    the batch and the heads even where KV does not divide the model axis,
    or, where H does not either, over the query rows (``attn_q``).

    q, k and v are laid out so (the scores' spec, ``("batch", "heads",
    "attn_q", None)``), and each rank then runs the grouped plain version
    on its own shards, as a kernel would on its device: its rows of the
    batch, its heads and its query rows (offset by where they start), all
    of the keys, in query chunks (:func:`_plain_chunked`). No collective
    runs inside; autograd goes through the shards. The same numbers as the
    grouped layout on one device."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    G = H // KV
    if G > 1:
        k = k[:, :, :, None].expand(B, Skv, KV, G, D).reshape(B, Skv, H, D)
        v = v[:, :, :, None].expand(B, Skv, KV, G, Dv).reshape(B, Skv, H, Dv)
    mesh, rules = shd.active()
    sb, sh, sq = (shd.spec_for(("batch", "heads", "attn_q", None),
                               (B, H, Sq, Skv), mesh, rules)
                  + (None,) * 3)[:3]
    q = shd.lay_out(q, shd.NamedSharding(mesh, (sb, sq, sh)))
    k = shd.lay_out(k, shd.NamedSharding(mesh, (sb, None, sh)))
    v = shd.lay_out(v, shd.NamedSharding(mesh, (sb, None, sh)))
    _, offset = shd.local_box(q.shape, mesh, q.placements)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    o = _plain_chunked(ql, kl, vl, causal, window, q_offset + offset[1],
                       scale, False).contiguous()
    return DTensor.from_local(o, mesh, q.placements, run_check=False,
                              shape=torch.Size((B, Sq, H, Dv)),
                              stride=(Sq * H * Dv, H * Dv, Dv, 1))


def flash_attention_lse_plain(q, k, v, *, causal=True, window=None,
                              q_offset=0, scale=None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores, (B, H, Sq)
    float32: what the kernels write beside o for the backward, over the
    same query chunks as :func:`flash_attention_plain`."""
    return _plain_chunked(q, k, v, causal, window, q_offset, scale, True)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True,
                              window=None, q_offset=0, scale=None):
    """dQ, dK, dV of :func:`flash_attention` in plain PyTorch by the backward
    kernel's formulas, in float32: P = exp(s - lse) on the visible pairs
    (s the scaled scores), Delta = rowsum(dO o O), dV = P^T dO,
    dS = P o (dO V^T - Delta), dK = scale dS^T Q, dQ = scale dS K; GQA's dK
    and dV summed over the G query heads of a kv head. Returns each in its
    input's dtype."""
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    G = H // KV
    scale = (1.0 / D**0.5) if scale is None else scale
    s, mask = _plain_scores(q, k, v, causal, window, q_offset, scale)
    lse = lse.float().reshape(B, KV, G, Sq)
    p = torch.exp(s - lse[..., None]) * mask
    dof = do.float().reshape(B, Sq, KV, G, Dv)
    delta = (dof * o.float().reshape(B, Sq, KV, G, Dv)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KV, G, D)) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Causal/windowed GQA attention: q (B, Sq, H, D), k (B, Skv, KV, D),
    v (B, Skv, KV, Dv) -> (B, Sq, H, Dv) in q's dtype. Query i sits at
    position ``i + q_offset``; kv head of query head h is ``h // (H // KV)``.

    A CPU tensor goes to :func:`flash_attention_plain` (autograd
    differentiates it); a CUDA tensor to the kernel of its route
    (:func:`_route`), which takes contiguous operands of one dtype (16-byte
    aligned on the wgmma route) and raises on anything else, through
    :class:`FlashAttentionFn` where grad is enabled and an input requires
    it. ``launches`` counts the forward kernel's launches,
    ``launches_by_route`` each route's.
    """
    _check_shapes(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      scale)
    return _forward(q, k, v, causal, window, q_offset, scale, False)[0]


def _forward(q, k, v, causal, window, q_offset, scale, want_lse: bool):
    """(o, lse or None): the forward kernel on CUDA tensors, the plain
    versions on CPU ones."""
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return (flash_attention_plain(q, k, v, **kw),
                flash_attention_lse_plain(q, k, v, **kw) if want_lse
                else None)
    route = _route(q.dtype, D, Dv)
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash kernel takes contiguous q, k, v of one "
                             "dtype on one device")
        if route == "wgmma" and t.data_ptr() % 16:
            raise ValueError("the wgmma route takes 16-byte aligned q, k, v")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return out, lse
    scale = (1.0 / D**0.5) if scale is None else scale
    window = 0 if window is None else int(window)
    lib = build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if want_lse else None)
        stream = build.stream_ptr(q.device)
        if route == "wgmma":
            rc = lib.flash_attention_wgmma(
                *ptrs, B, Sq, Skv, H, KV, D, Dv, float(scale), int(causal),
                window, int(q_offset), stream)
        else:
            rc = lib.flash_attention(
                *ptrs, _DTYPES[q.dtype], B, Sq, Skv, H, KV, D, Dv,
                float(scale), int(causal), window, int(q_offset), stream)
    build.check(lib, rc, f"flash_attention ({route})")
    build.count_launch(flash_attention, route)
    return out, lse


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd: the forward kernel, asked also for
    the rows' log-sum-exp, and :func:`flash_attention_bwd` as its backward
    (on CPU tensors the plain versions of both)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        o, lse = _forward(q, k, v, causal, window, q_offset, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0, scale: float | None = None):
    """dQ, dK, dV of :func:`flash_attention` at its output ``o`` and row
    log-sum-exp ``lse`` (B, H, Sq) float32, for the incoming gradient ``do``
    (B, Sq, H, Dv), each in its input's dtype.

    A CPU tensor goes to :func:`flash_attention_bwd_plain`; a CUDA tensor to
    the kernel of its route (:func:`_bwd_route`) in
    ``csrc/flash_attention_bwd.cu``, which takes contiguous q, k, v, o, do
    of one dtype (16-byte aligned on the tensor-core routes) and raises
    ValueError on anything else (float32 above D, Dv = 128 among it).
    ``launches`` counts its calls, ``launches_by_route`` each route's (each
    call launches the row-statistics pass, the kernel and, in bf16, dQ's
    cast).
    """
    B, Sq, H, D, Skv, KV, Dv = _check_shapes(q, k, v)
    if tuple(o.shape) != (B, Sq, H, Dv) or tuple(do.shape) != (B, Sq, H, Dv) \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    route = _bwd_route(q.dtype, D, Dv)
    for t in (q, k, v, o, do):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash backward kernel takes contiguous q, k, v, "
                             "o, do of one dtype on one device")
        if route != "simt" and t.data_ptr() % 16:
            raise ValueError(f"the backward's {route} route takes 16-byte "
                             f"aligned q, k, v, o, do")
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError("lse must be a contiguous float32 tensor on q's device")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # the wgmma routes' dQ buffer is tiled ((B, H, Sp / 64, D / 64, 64, 64);
    # kv128's (B, H, Sp / 64, 2, 64, D / 2)) and their row statistics (lse
    # log2 e, Delta) padded to Sp, Sq rounded up to its 64-row tile
    tiled = route in ("wgmma", "wgmma_split", "wgmma_kv128")
    Sp = -(-Sq // BWD_TILE) * BWD_TILE if tiled else Sq
    dq_acc = torch.empty((B, Sp, H, D), dtype=torch.float32, device=q.device)
    dq = dq_acc if q.dtype == torch.float32 else torch.empty_like(q)
    delta = torch.empty((2 if tiled else 1, B, H, Sp),
                        dtype=torch.float32, device=q.device)
    if B * Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scale = (1.0 / D**0.5) if scale is None else scale
    window = 0 if window is None else int(window)
    lib = build.library("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq_acc.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        opts = (float(scale), int(causal), window, int(q_offset),
                build.stream_ptr(q.device))
        if route == "wgmma_kv128":
            rc = lib.flash_attention_bwd_kv128(*ptrs, B, Sq, Skv, H, KV, D,
                                               Dv, *opts)
        elif route == "wgmma_split":
            rc = lib.flash_attention_bwd_split(*ptrs, B, Sq, Skv, H, KV, D,
                                               Dv, *opts)
        elif route == "wgmma":
            rc = lib.flash_attention_bwd_wgmma(*ptrs, B, Sq, Skv, H, KV, D,
                                               *opts)
        elif route == "mma":
            rc = lib.flash_attention_bwd_mma(*ptrs, B, Sq, Skv, H, KV, D, Dv,
                                             *opts)
        else:
            rc = lib.flash_attention_bwd(*ptrs, _DTYPES[q.dtype], B, Sq, Skv,
                                         H, KV, D, Dv, *opts)
    build.check(lib, rc, f"flash_attention_bwd ({route})")
    build.count_launch(flash_attention_bwd, route)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"wgmma_kv128": 0, "wgmma_split": 0,
                                         "wgmma": 0, "mma": 0, "simt": 0}
