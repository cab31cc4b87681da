"""First-order recurrence scans: the Mamba selective scan and the RWKV6
scan (matrix-state linear attention with data-dependent decay), each a
CUDA kernel beside its plain versions.

Counterparts of ``repro.kernels.linear_scan.mamba_scan`` and
``rwkv_scan`` (the Pallas TPU kernels; their contracts are
``repro.kernels.ref.mamba_scan`` and ``rwkv_scan``). The kernels are in
``csrc/linear_scan.cu``, whose source notes say what bounds each on an
H100 and how it is laid out. Each scan picks its kernel by shape: the
Mamba scan (:func:`_mamba_route`) takes jamba-v0.1-52b's prefills on the
time-segmented scan and its decode steps on the lane-split step, the rest
(short prompts, the smoke config's state size) on the serial kernel; the
RWKV6 scan (:func:`_route`) takes rwkv6-3b's bf16 prefills on the chunked
scan on the tensor cores, everything else (the decode step, float32, the
smoke config's width) on the serial one. The kernels read the
projections in their (B, S, ...) layout and take any S >= 1: the engine
prefills at the raw prompt length and decodes at S = 1, where
:func:`mamba_decode_step` and :func:`rwkv_decode_step` write the new
state into the cache in place. The wrappers launch the kernels for CUDA
tensors and take the plain versions only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# head widths (K = V) the RWKV6 kernel is built for: rwkv6-3b 64, its smoke
# config 16; the chunked route's width, steps a chunk, and the fewest steps
# it takes: its three launches cost ~0.022 ms up to S = 128 at rwkv6-3b's
# 40 heads, the serial kernel ~0.0027 + 0.00059 S ms, so they meet at S = 32
# on an H100 (chip_smoke.py's rwkv_scan yardstick)
WIDTHS = (16, 64)
CHUNK_WIDTH = 64
CHUNK = 64
CHUNK_MIN_S = 33
# state sizes N the Mamba kernels are built for: jamba-v0.1-52b 16, its smoke
# config 4; the segmented and step routes' size, the segments (warps) a block
# of the segmented route cuts S into, and the fewest steps it takes: at
# jamba's Di = 8192 the segmented kernel costs ~0.005 ms at S = 2 against
# the serial one's ~0.0037, they tie at S = 10 and the segmented one is
# ~7% faster at 11 on an H100 (chip_smoke.py's mamba_scan yardstick)
MAMBA_WIDTHS = (4, 16)
MAMBA_SEG_WIDTH = 16
MAMBA_SEGMENTS = 16
MAMBA_SEG_MIN_S = 11
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_MAMBA_ENTRIES = {"serial": "mamba_scan", "segmented": "mamba_scan_segmented",
                  "step": "mamba_scan_step"}
_SIGNATURES = {"rwkv_scan": [_P] * 8 + [_I] * 6 + [_P],
               "rwkv_scan_chunk": [_P] * 10 + [_I] * 3 + [_P],
               **{entry: [_P] * 8 + [_I] * 5 + [_P]
                  for entry in _MAMBA_ENTRIES.values()}}


# --------------------------------------------------------------------------
# Mamba selective scan
# --------------------------------------------------------------------------

def _check_mamba_shapes(delta, A, Bt, Ct, x, h0) -> tuple[int, int, int, int]:
    if delta.ndim != 3 or A.ndim != 2:
        raise ValueError("want delta, x (B, S, Di), A (Di, N), Bt, Ct "
                         "(B, S, N)")
    B, S, Di = delta.shape
    N = A.shape[1]
    if (tuple(x.shape) != (B, S, Di) or tuple(A.shape) != (Di, N)
            or tuple(Bt.shape) != (B, S, N) or tuple(Ct.shape) != (B, S, N)
            or (h0 is not None and tuple(h0.shape) != (B, Di, N))):
        raise ValueError(
            f"shapes delta {tuple(delta.shape)}, A {tuple(A.shape)}, Bt "
            f"{tuple(Bt.shape)}, Ct {tuple(Ct.shape)}, x {tuple(x.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)} do not fit")
    if S < 1:
        raise ValueError("the scan needs at least one step")
    return B, S, Di, N


def mamba_scan_plain(delta: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
                     Ct: torch.Tensor, x: torch.Tensor,
                     h0: torch.Tensor | None = None):
    """The reference's sequential recurrence in float32: for each step,
    h = exp(delta A) h + (delta x) B_t and y_t = sum_N h C_t, with
    delta x rounded to x's dtype before it is widened, as the reference
    rounds it. Returns (y (B, S, Di) in x's dtype, final state (B, Di, N)
    float32)."""
    B, S, Di, N = _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=delta.device)
         if h0 is None else h0.float())
    df, dx = delta.float(), (delta * x).float()
    Af, Bf, Cf = A.float()[None], Bt.float(), Ct.float()
    ys = []
    for t in range(S):
        h = (torch.exp(df[:, t, :, None] * Af) * h
             + dx[:, t, :, None] * Bf[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba_decode_step_plain(delta: torch.Tensor, A: torch.Tensor,
                            Bt: torch.Tensor, Ct: torch.Tensor,
                            x: torch.Tensor, h: torch.Tensor):
    """One step as the reference's ``ops.mamba_decode_step`` writes it:
    delta, x (B, Di), Bt, Ct (B, N), state h (B, Di, N) float32. The new
    state is written into ``h`` in place; returns (y (B, Di) in x's dtype,
    h)."""
    dA = torch.exp(delta.float()[..., None] * A.float()[None])
    dBx = (delta * x).float()[..., None] * Bt.float()[:, None]
    h.copy_(dA * h + dBx)
    y = torch.einsum("bdn,bn->bd", h, Ct.float())
    return y.to(x.dtype), h


def _mamba_route(dtype: torch.dtype, N: int, S: int) -> str:
    """The kernel that takes a CUDA Mamba call: at N =
    :data:`MAMBA_SEG_WIDTH`, ``"step"`` (the lane-split step) for S = 1 and
    ``"segmented"`` (the time-segmented scan) for S >=
    :data:`MAMBA_SEG_MIN_S`; ``"serial"`` for the S between them and for the
    other built state size. A choice by shape, not a fallback: what no
    route takes raises ValueError."""
    if dtype not in _DTYPES:
        raise ValueError("mamba scan kernel takes bfloat16 or float32, got "
                         f"{dtype}")
    if N not in MAMBA_WIDTHS:
        raise ValueError(f"mamba scan kernel takes N in {MAMBA_WIDTHS}; got "
                         f"N={N}")
    if N == MAMBA_SEG_WIDTH:
        if S == 1:
            return "step"
        if S >= MAMBA_SEG_MIN_S:
            return "segmented"
    return "serial"


def mamba_scan(delta: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
               Ct: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor | None = None, *,
               state_out: torch.Tensor | None = None):
    """Mamba selective scan: delta, x (B, S, Di), A (Di, N), Bt, Ct
    (B, S, N), optional initial state h0 (B, Di, N) -> (y (B, S, Di) in
    x's dtype, final state (B, Di, N) float32). ``state_out``, when given,
    is the float32 tensor the final state is written into, and may be
    ``h0`` itself.

    A CPU tensor goes to :func:`mamba_scan_plain`; a CUDA tensor to the
    kernel of its route (:func:`_mamba_route`), which takes contiguous
    delta, x, Bt, Ct of one dtype (bfloat16 or float32), float32 h0, N in
    :data:`MAMBA_WIDTHS` (the segmented and step routes also 16-byte
    aligned tensors, the segmented one Di a multiple of 8), and raises on
    anything else. A is widened to float32 here, as the Pallas kernel
    widens it. ``launches`` counts the wrapper's calls,
    ``launches_by_route`` each route's.
    """
    B, S, Di, N = _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    if state_out is not None and (tuple(state_out.shape) != (B, Di, N)
                                  or state_out.dtype != torch.float32):
        raise ValueError("state_out must be a (B, Di, N) float32 tensor")
    if delta.device.type == "cpu":
        y, h = mamba_scan_plain(delta, A, Bt, Ct, x, h0)
        if state_out is None:
            return y, h
        return y, state_out.copy_(h)
    build.refuse_grad("mamba_scan", delta, A, Bt, Ct, x, h0)
    route = _mamba_route(x.dtype, N, S)
    if any(t.dtype != x.dtype for t in (delta, Bt, Ct)):
        raise ValueError("mamba scan kernel takes delta, x, Bt, Ct of one "
                         "dtype")
    Af = A.to(torch.float32).contiguous()
    state = (torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
             if state_out is None else state_out)
    tensors = [delta, x, Af, Bt, Ct, state] + ([] if h0 is None else [h0])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("mamba scan kernel takes contiguous tensors on "
                             "one device")
    if h0 is not None and h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32, got {h0.dtype}")
    if route != "serial" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {route} mamba route takes 16-byte aligned "
                         "tensors")
    if route == "segmented" and Di % 8:
        raise ValueError(f"the segmented mamba route takes Di a multiple of "
                         f"8; got Di={Di}")
    return _launch_mamba(route, delta, x, Af, Bt, Ct, h0, state), state


def _launch_mamba(route: str, delta: torch.Tensor, x: torch.Tensor,
                  Af: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor,
                  h0: torch.Tensor | None,
                  state: torch.Tensor) -> torch.Tensor:
    """Launches ``route``'s kernel on tensors :func:`mamba_scan` has checked
    (A already float32), writes the final state into ``state``, counts the
    launch and returns y."""
    B, S, Di = delta.shape
    y = torch.empty((B, S, Di), dtype=x.dtype, device=x.device)
    lib = build.library("linear_scan", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = getattr(lib, _MAMBA_ENTRIES[route])(
            delta.data_ptr(), x.data_ptr(), Af.data_ptr(), Bt.data_ptr(),
            Ct.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype], B, S, Di,
            Af.shape[1], build.stream_ptr(x.device))
    build.check(lib, rc, f"mamba_scan ({route})")
    build.count_launch(mamba_scan, route)
    return y


mamba_scan.launches = 0
mamba_scan.launches_by_route = {"segmented": 0, "step": 0, "serial": 0}


def mamba_decode_step(delta: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
                      Ct: torch.Tensor, x: torch.Tensor, h: torch.Tensor):
    """One Mamba step per row: delta, x (B, Di), Bt, Ct (B, N), state h
    (B, Di, N) float32, updated in place -> (y (B, Di), h).

    A CPU tensor goes to :func:`mamba_decode_step_plain`; a CUDA tensor to
    the scan at S = 1 (at N = 16 the step route) with the state read from
    and written to ``h`` (one launch, counted on :func:`mamba_scan`).
    """
    if delta.device.type == "cpu":
        return mamba_decode_step_plain(delta, A, Bt, Ct, x, h)
    build.refuse_grad("mamba_decode_step", delta, A, Bt, Ct, x, h)
    y, _ = mamba_scan(delta[:, None], A, Bt[:, None], Ct[:, None],
                      x[:, None], h, state_out=h)
    return y[:, 0], h


# --------------------------------------------------------------------------
# RWKV6 scan
# --------------------------------------------------------------------------


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


def _route(dtype: torch.dtype, K: int, V: int, S: int) -> str:
    """The kernel that takes a CUDA RWKV6 call: ``"chunk"`` (the chunked
    scan on the tensor cores) for bfloat16 at K = V = 64 with S >=
    :data:`CHUNK_MIN_S`, ``"serial"`` for shorter prompts, the S = 1 step,
    float32 and the other built width. A choice by shape, not a fallback:
    what neither takes raises ValueError."""
    if dtype not in _DTYPES:
        raise ValueError(f"rwkv scan kernel takes bfloat16 or float32, got "
                         f"{dtype}")
    if K != V or K not in WIDTHS:
        raise ValueError(f"rwkv scan kernel takes K = V in {WIDTHS}; got "
                         f"K={K}, V={V}")
    if dtype == torch.bfloat16 and K == CHUNK_WIDTH and S >= CHUNK_MIN_S:
        return "chunk"
    return "serial"


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
    kernel of its route (:func:`_route`), which takes contiguous r, k, v of
    one dtype (bfloat16 or float32), float32 w and h0, K = V in
    :data:`WIDTHS` (the chunked route also 16-byte aligned tensors), and
    raises on anything else. u is widened to float32 here. ``launches``
    counts the wrapper's calls, ``launches_by_route`` each route's.
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
    build.refuse_grad("rwkv_scan", r, w, k, v, u, h0)
    route = _route(r.dtype, K, V, S)
    if k.dtype != r.dtype or v.dtype != r.dtype or w.dtype != torch.float32:
        raise ValueError("rwkv scan kernel takes r, k, v of one dtype and "
                         "float32 w")
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
    if route == "chunk" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the chunked rwkv route takes 16-byte aligned "
                         "tensors")
    return _launch(route, r, w, k, v, uf, h0, state), state


def _launch(route: str, r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, uf: torch.Tensor, h0: torch.Tensor | None,
            state: torch.Tensor) -> torch.Tensor:
    """Launches ``route``'s kernel on tensors :func:`rwkv_scan` has checked
    (u already float32), writes the final state into ``state``, counts the
    launch and returns o."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    o = torch.empty((B, S, H, V), dtype=v.dtype, device=r.device)
    lib = build.library("linear_scan", _SIGNATURES)
    h0_ptr = None if h0 is None else h0.data_ptr()
    with torch.cuda.device(r.device):
        stream = build.stream_ptr(r.device)
        if route == "chunk":
            n_chunks = -(-S // CHUNK)
            U = torch.empty((B, H, n_chunks, K, V), dtype=torch.float32,
                            device=r.device)
            P = torch.empty((B, H, n_chunks, K), dtype=torch.float32,
                            device=r.device)
            rc = lib.rwkv_scan_chunk(
                r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
                uf.data_ptr(), h0_ptr, o.data_ptr(), state.data_ptr(),
                U.data_ptr(), P.data_ptr(), B, S, H, stream)
        else:
            rc = lib.rwkv_scan(
                r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
                uf.data_ptr(), h0_ptr, o.data_ptr(), state.data_ptr(),
                _DTYPES[r.dtype], B, S, H, K, V, stream)
    build.check(lib, rc, f"rwkv_scan ({route})")
    build.count_launch(rwkv_scan, route)
    return o


rwkv_scan.launches = 0
rwkv_scan.launches_by_route = {"chunk": 0, "serial": 0}


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
    build.refuse_grad("rwkv_decode_step", r, w, k, v, u, h)
    o, _ = rwkv_scan(r[:, None], w[:, None], k[:, None], v[:, None], u, h,
                     state_out=h)
    return o[:, 0], h
