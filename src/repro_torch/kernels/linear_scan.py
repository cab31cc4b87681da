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

Training: where grad is enabled and an input requires it, a CUDA call goes
through :class:`MambaScanFn` or :class:`RwkvScanFn`, whose forward is the
same route asked also for checkpoints of the state every :data:`CHUNK`
steps, and whose backward is the hand-written kernel of
``csrc/linear_scan_bwd.cu`` (:func:`mamba_scan_bwd`, :func:`rwkv_scan_bwd`)
of its route: bfloat16 RWKV6 at K = 64 and Mamba at N = 16 on the
chunk-parallel backward (:func:`_rwkv_bwd_route`, :func:`_mamba_bwd_route`),
float32 RWKV6 and the smoke configs' widths on the serial one.
:func:`mamba_scan_bwd_plain` and :func:`rwkv_scan_bwd_plain` compute the
same formulas in plain PyTorch; on the CPU autograd differentiates the
plain forwards, as XLA's autodiff differentiates the reference's scans. The
decode steps keep no backward (no training step calls them). Under a
sharding context on a mesh of more than one device the plain Mamba scan
runs on each rank's own shards (:func:`_mamba_plain_by_shards`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.distributed.sharding import sharded_context
from repro_torch.kernels import build
from repro_torch.roofline.op_cost import scan

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
_SIGNATURES = {"rwkv_scan": [_P] * 8 + [_I] * 6 + [_P, _P],
               "rwkv_scan_chunk": [_P] * 10 + [_I] * 3 + [_P],
               **{entry: [_P] * 8 + [_I] * 5 + [_P, _P]
                  for entry in _MAMBA_ENTRIES.values()}}
_BWD_SIGNATURES = {"mamba_scan_bwd": [_P] * 17 + [_I] * 5 + [_P],
                   "rwkv_scan_bwd": [_P] * 16 + [_I] * 5 + [_P],
                   "mamba_scan_bwd_chunk": [_P] * 18 + [_I] * 5 + [_P],
                   "rwkv_scan_bwd_chunk": [_P] * 17 + [_I] * 3 + [_P]}
# channels a block of the chunked Mamba backward sums dB and dC over before
# it writes a partial (csrc/linear_scan_bwd.cu MCH)
MAMBA_BWD_CHANNELS = 64


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
    float32). Under a sharding context on a mesh of more than one device
    it runs on each rank's shards (:func:`_mamba_plain_by_shards`)."""
    _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    if sharded_context():
        return _mamba_plain_by_shards(delta, A, Bt, Ct, x, h0)
    return _mamba_plain_local(delta, A, Bt, Ct, x, h0)


def _mamba_plain_local(delta, A, Bt, Ct, x, h0):
    B, S, Di, N = _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=delta.device)
         if h0 is None else h0.float())
    df, dx = delta.float(), (delta * x).float()
    Af, Bf, Cf = A.float()[None], Bt.float(), Ct.float()

    def step(t, h):
        h = (torch.exp(df[:, t, :, None] * Af) * h
             + dx[:, t, :, None] * Bf[:, t, None, :])
        return h, torch.einsum("bdn,bn->bd", h, Cf[:, t])
    h, ys = scan(step, h, S)
    return ys.to(x.dtype), h


def _mamba_plain_by_shards(delta, A, Bt, Ct, x, h0):
    """The plain scan on each rank's own shards, as a kernel would run on
    its device: delta and x laid out over the batch and the inner (Di)
    dims, Bt and Ct over the batch (replicated over Di), A and h0 to match;
    y and the final state wrapped back as DTensors of those layouts. No
    collective runs inside; autograd goes through the shards, the
    gradients of the inputs replicated over a sharded dim (A over the
    batch, Bt and Ct over Di) leaving as partial sums. Each channel is its
    own recurrence, so the numbers are those of the whole scan."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed import sharding as shd
    B, S, Di, N = _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    mesh, rules = shd.active()
    sb, _, sd = (shd.spec_for(("batch", None, "inner"), (B, S, Di), mesh,
                              rules) + (None,) * 3)[:3]
    delta = shd.lay_out(delta, shd.NamedSharding(mesh, (sb, None, sd)))
    x = shd.lay_out(x, shd.NamedSharding(mesh, (sb, None, sd)))
    Bt = shd.lay_out(Bt, shd.NamedSharding(mesh, (sb,)))
    Ct = shd.lay_out(Ct, shd.NamedSharding(mesh, (sb,)))
    A = shd.lay_out(A, shd.NamedSharding(mesh, (sd,)))
    state = shd.NamedSharding(mesh, (sb, sd))
    if h0 is not None:
        h0 = shd.lay_out(h0, state)

    def partial_grad(t):
        # a replicated input of sharded work: its gradient is each rank's
        # share of a sum over the shards (Partial), not one replicated value
        return t.to_local(grad_placements=[
            Partial() if isinstance(p, Replicate) and isinstance(q, Shard)
            else p for p, q in zip(t.placements, delta.placements)])
    y, h = _mamba_plain_local(delta.to_local(), partial_grad(A),
                              partial_grad(Bt), partial_grad(Ct),
                              x.to_local(),
                              None if h0 is None else h0.to_local())
    y = DTensor.from_local(y.contiguous(), mesh, delta.placements,
                           run_check=False, shape=torch.Size((B, S, Di)),
                           stride=(S * Di, Di, 1))
    h = DTensor.from_local(h.contiguous(), mesh, state.placements(3),
                           run_check=False, shape=torch.Size((B, Di, N)),
                           stride=(Di * N, N, 1))
    return y, h


def mamba_scan_bwd_plain(delta: torch.Tensor, A: torch.Tensor,
                         Bt: torch.Tensor, Ct: torch.Tensor, x: torch.Tensor,
                         h0: torch.Tensor | None, dy: torch.Tensor,
                         dh: torch.Tensor | None = None):
    """The gradients of :func:`mamba_scan_plain` by the backward kernel's
    formulas, in float32. With a_t = exp(delta_t A), (dx)_t = delta_t x_t
    rounded as the forward rounds it, h_t the states (h_{-1} = h0) and the
    adjoint g_t = dy_t C_t + a_{t+1} g_{t+1}, seeded with the final state's
    gradient ``dh`` (zero when None):
    dC_t = sum_Di dy_t h_t, dB_t = sum_Di g_t (dx)_t, d(dx)_t = sum_N g_t
    B_t (straight through the rounding: d delta_t += d(dx)_t x_t, dx_t =
    d(dx)_t delta_t), d delta_t += sum_N g_t h_{t-1} a_t A, dA = sum_{b,t}
    g_t h_{t-1} a_t delta_t, dh0 = a_0 g_0. Returns (d delta, dA, dBt, dCt,
    dx, dh0) in the inputs' dtypes (dh0 float32, None where h0 is)."""
    B, S, Di, N = _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    df, xf, dxr = delta.float(), x.float(), (delta * x).float()
    Af, Bf, Cf, dyf = A.float(), Bt.float(), Ct.float(), dy.float()
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=delta.device)
         if h0 is None else h0.float())
    a = torch.exp(df[..., None] * Af)                        # (B, S, Di, N)
    states = []                                              # h_{t-1}
    for t in range(S):
        states.append(h)
        h = a[:, t] * h + dxr[:, t, :, None] * Bf[:, t, None, :]
    hp = torch.stack(states, dim=1)
    g = (torch.zeros((B, Di, N), dtype=torch.float32, device=delta.device)
         if dh is None else dh.float())
    adj = []                                                 # g_t
    for t in range(S - 1, -1, -1):
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]
        adj.append(g)
        g = g * a[:, t]
    gs = torch.stack(adj[::-1], dim=1)
    ht = a * hp + dxr[..., None] * Bf[:, :, None, :]
    dC = torch.einsum("bsdn,bsd->bsn", ht, dyf)
    dB = torch.einsum("bsdn,bsd->bsn", gs, dxr)
    ddx = torch.einsum("bsdn,bsn->bsd", gs, Bf)
    geh = gs * a * hp
    d_delta = (geh * Af).sum(-1) + ddx * xf
    dA = (geh * df[..., None]).sum((0, 1))
    return (d_delta.to(delta.dtype), dA.to(A.dtype), dB.to(Bt.dtype),
            dC.to(Ct.dtype), (ddx * df).to(x.dtype),
            None if h0 is None else g)


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


def _mamba_bwd_route(dtype: torch.dtype, N: int) -> str:
    """The backward kernel that takes a CUDA Mamba call: ``"chunk"`` (the
    chunk-parallel backward: each chunk's adjoint from zero, a reverse
    carry across chunks, then every chunk's gradients from its checkpoint
    and its true adjoint) at N = :data:`MAMBA_SEG_WIDTH`, bfloat16 and
    float32, at any S: it reads only the checkpoints, which every forward
    route writes; ``"serial"`` (a block walks every chunk in turn) at the
    other built state size. What neither takes raises ValueError."""
    _mamba_route(dtype, N, 1)            # raises where no kernel takes it
    return "chunk" if N == MAMBA_SEG_WIDTH else "serial"


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
    widens it. Where grad is enabled and an input requires it, the call
    goes through :class:`MambaScanFn` (the same route with checkpoints,
    :func:`mamba_scan_bwd` as its backward; ``state_out`` raises there).
    ``launches`` counts the forward kernel's launches,
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
    grad = _wants_grad(delta, A, Bt, Ct, x, h0)
    if grad and state_out is not None:
        raise ValueError("mamba_scan under grad takes no state_out")
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
    if grad:
        return MambaScanFn.apply(delta, Af, Bt, Ct, x, h0)
    return _launch_mamba(route, delta, x, Af, Bt, Ct, h0, state), state


def _launch_mamba(route: str, delta: torch.Tensor, x: torch.Tensor,
                  Af: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor,
                  h0: torch.Tensor | None, state: torch.Tensor,
                  ckpt: torch.Tensor | None = None) -> torch.Tensor:
    """Launches ``route``'s kernel on tensors :func:`mamba_scan` has checked
    (A already float32), writes the final state into ``state`` and, given
    ``ckpt`` (B, ceil(S / CHUNK), Di, N) float32, the checkpoints; counts
    the launch and returns y."""
    B, S, Di = delta.shape
    y = torch.empty((B, S, Di), dtype=x.dtype, device=x.device)
    lib = build.library("linear_scan", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = getattr(lib, _MAMBA_ENTRIES[route])(
            delta.data_ptr(), x.data_ptr(), Af.data_ptr(), Bt.data_ptr(),
            Ct.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype], B, S, Di,
            Af.shape[1], None if ckpt is None else ckpt.data_ptr(),
            build.stream_ptr(x.device))
    build.check(lib, rc, f"mamba_scan ({route})")
    build.count_launch(mamba_scan, route)
    return y


mamba_scan.launches = 0
mamba_scan.launches_by_route = {"segmented": 0, "step": 0, "serial": 0}


class MambaScanFn(torch.autograd.Function):
    """The Mamba scan under autograd: the forward kernel of the call's
    route, asked also for the state every :data:`CHUNK` steps, and
    :func:`mamba_scan_bwd` as its backward (on CPU tensors the plain
    versions of both). Takes A already float32; its gradient goes back
    through the caller's widening."""

    @staticmethod
    def forward(ctx, delta, Af, Bt, Ct, x, h0):
        ctx.set_materialize_grads(False)
        B, S, Di, N = delta.shape + Af.shape[1:]
        if delta.device.type == "cpu":
            (y, h), ckpt = _mamba_plain_local(delta, Af, Bt, Ct, x, h0), None
        else:
            h = torch.empty((B, Di, N), dtype=torch.float32,
                            device=x.device)
            ckpt = torch.empty((B, -(-S // CHUNK), Di, N),
                               dtype=torch.float32, device=x.device)
            y = _launch_mamba(_mamba_route(x.dtype, N, S), delta, x, Af, Bt,
                              Ct, h0, h, ckpt)
        ctx.save_for_backward(delta, Af, Bt, Ct, x, h0, ckpt)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        delta, Af, Bt, Ct, x, h0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return mamba_scan_bwd(delta, Af, Bt, Ct, x, h0, dy.contiguous(),
                              None if dh is None else dh.contiguous(),
                              ckpt=ckpt)


def mamba_scan_bwd(delta: torch.Tensor, A: torch.Tensor, Bt: torch.Tensor,
                   Ct: torch.Tensor, x: torch.Tensor, h0: torch.Tensor | None,
                   dy: torch.Tensor, dh: torch.Tensor | None = None, *,
                   ckpt: torch.Tensor | None = None):
    """The gradients of :func:`mamba_scan` at ``dy`` (B, S, Di) and the
    final state's ``dh`` (B, Di, N) or None: (d delta, dA, dBt, dCt, dx,
    dh0), each in its input's dtype (dh0 float32, None where h0 is).

    A CPU tensor goes to :func:`mamba_scan_bwd_plain`; a CUDA tensor to the
    kernel of its route (:func:`_mamba_bwd_route`) in
    ``csrc/linear_scan_bwd.cu``, which recomputes the states from ``ckpt``
    (B, ceil(S / CHUNK), Di, N) float32, the forward kernel's checkpoints,
    and takes what the forward takes, float32 A, dh and ckpt, contiguous dy in x's dtype (the chunked
    route Di a multiple of 8 and 16-byte aligned tensors), and raises
    ValueError on anything else. ``launches`` counts its calls,
    ``launches_by_route`` each route's (the serial route launches its
    kernel and three passes that add the partial sums of dBt, dCt and dA
    in a fixed order; the chunked route its three steps and the same
    three passes).
    """
    B, S, Di, N = _check_mamba_shapes(delta, A, Bt, Ct, x, h0)
    if tuple(dy.shape) != (B, S, Di) or (
            dh is not None and tuple(dh.shape) != (B, Di, N)):
        raise ValueError(f"dy {tuple(dy.shape)}, dh "
                         f"{None if dh is None else tuple(dh.shape)} do not "
                         f"fit delta {tuple(delta.shape)}")
    if delta.device.type == "cpu":
        return mamba_scan_bwd_plain(delta, A, Bt, Ct, x, h0, dy, dh)
    route = _mamba_bwd_route(x.dtype, N)
    NC = -(-S // CHUNK)
    if ckpt is None or tuple(ckpt.shape) != (B, NC, Di, N):
        raise ValueError(f"the backward kernel needs the forward's "
                         f"checkpoints, (B, {NC}, Di, N) float32")
    if any(t.dtype != x.dtype for t in (delta, Bt, Ct, dy)):
        raise ValueError("mamba backward kernel takes delta, x, Bt, Ct, dy "
                         "of one dtype")
    f32 = [A, ckpt] + ([] if dh is None else [dh])
    tensors = [delta, x, Bt, Ct, dy] + f32
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("mamba backward kernel takes contiguous tensors "
                             "on one device")
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("mamba backward kernel takes float32 A, ckpt, dh")
    if route == "chunk" and (Di % 8 or any(t.data_ptr() % 16
                                           for t in tensors)):
        raise ValueError("the chunked mamba backward route takes Di a "
                         "multiple of 8 and 16-byte aligned tensors")
    f = dict(dtype=torch.float32, device=x.device)
    d_delta, d_x = torch.empty_like(delta), torch.empty_like(x)
    dB, dC = torch.empty_like(Bt), torch.empty_like(Ct)
    dA = torch.empty((Di, N), **f)
    dh0 = torch.empty((B, Di, N), **f)
    ptrs = (delta.data_ptr(), x.data_ptr(), A.data_ptr(), Bt.data_ptr(),
            Ct.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
            None if dh is None else dh.data_ptr(), d_delta.data_ptr(),
            d_x.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dh0.data_ptr())
    lib = build.library("linear_scan_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(x.device):
        if route == "chunk":
            parts = -(-Di // MAMBA_BWD_CHANNELS)
            L = torch.empty((B, NC, Di, N), **f)
            sumd = torch.empty((B, NC, Di), **f)
            dbc_part = torch.empty((parts, 2, B, S, N), **f)
            dA_part = torch.empty((B, NC, Di, N), **f)
            rc = lib.mamba_scan_bwd_chunk(
                *ptrs, L.data_ptr(), sumd.data_ptr(), dbc_part.data_ptr(),
                dA_part.data_ptr(), _DTYPES[x.dtype], B, S, Di, N,
                build.stream_ptr(x.device))
        else:
            nw = -(-Di // 32)
            hist = torch.empty((B, nw, CHUNK, N, 32), **f)
            dbc_part = torch.empty((nw, 2, B, S, N), **f)
            dA_part = torch.empty((B, Di, N), **f)
            rc = lib.mamba_scan_bwd(
                *ptrs, hist.data_ptr(), dbc_part.data_ptr(),
                dA_part.data_ptr(), _DTYPES[x.dtype], B, S, Di, N,
                build.stream_ptr(x.device))
    build.check(lib, rc, f"mamba_scan_bwd ({route})")
    build.count_launch(mamba_scan_bwd, route)
    return d_delta, dA, dB, dC, d_x, None if h0 is None else dh0


mamba_scan_bwd.launches = 0
mamba_scan_bwd.launches_by_route = {"chunk": 0, "serial": 0}


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


def _rwkv_bwd_route(dtype: torch.dtype, K: int, V: int) -> str:
    """The backward kernel that takes a CUDA RWKV6 call: ``"chunk"`` (the
    chunk-parallel backward: each chunk's adjoint contribution on the
    tensor cores, a reverse carry across chunks, then every chunk's
    gradients from its checkpoint and its true adjoint) for bfloat16 at K =
    V = :data:`CHUNK_WIDTH`, at any S: it reads only the checkpoints, which
    every forward route writes; ``"serial"`` (a block walks every chunk in
    turn) for float32 and the other built width. What neither takes raises
    ValueError."""
    _route(dtype, K, V, 1)               # raises where no kernel takes it
    return ("chunk" if dtype == torch.bfloat16 and K == CHUNK_WIDTH
            else "serial")


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

    def step(t, h):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        o = torch.einsum("bhk,bhkv->bhv", rf[:, t], h + uf * kv)
        return wf[:, t, :, :, None] * h + kv, o
    h, outs = scan(step, h, S)
    return outs.to(v.dtype), h


def rwkv_scan_bwd_plain(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, u: torch.Tensor,
                        h0: torch.Tensor | None, do: torch.Tensor,
                        dh: torch.Tensor | None = None):
    """The gradients of :func:`rwkv_scan_plain` by the backward kernel's
    formulas, in float32. With S_t the states (S_{-1} = h0) and the
    adjoint G_{t-1} = diag(w_t) G_t + r_t do_t^T, seeded with the final
    state's gradient ``dh`` (zero when None):
    dr_t = S_{t-1} do_t + u k_t (v_t . do_t), dk_t = G_t v_t + u r_t
    (v_t . do_t), dv_t = G_t^T k_t + (r_t . (u k_t)) do_t, dw_t =
    rowsum(G_t o S_{t-1}), du = sum_{b,t} r_t k_t (v_t . do_t), dh0 =
    G_{-1}. Returns (dr, dw, dk, dv, du, dh0) in the inputs' dtypes (dh0
    float32, None where h0 is)."""
    B, S, H, K, V = _check_shapes(r, w, k, v, u, h0)
    rf, wf, kf, vf, dof = (t.float() for t in (r, w, k, v, do))
    uf = u.float()
    h = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if h0 is None else h0.float())
    states = []                                              # S_{t-1}
    for t in range(S):
        states.append(h)
        h = (wf[:, t, :, :, None] * h
             + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    hp = torch.stack(states, dim=1)                          # (B, S, H, K, V)
    G = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if dh is None else dh.float())
    adj = []                                                 # G_t
    for t in range(S - 1, -1, -1):
        adj.append(G)
        G = (wf[:, t, :, :, None] * G
             + rf[:, t, :, :, None] * dof[:, t, :, None, :])
    gs = torch.stack(adj[::-1], dim=1)
    vdo = (vf * dof).sum(-1, keepdim=True)                   # (B, S, H, 1)
    ruk = (rf * uf * kf).sum(-1, keepdim=True)
    dr = torch.einsum("bshkv,bshv->bshk", hp, dof) + uf * kf * vdo
    dk = torch.einsum("bshkv,bshv->bshk", gs, vf) + uf * rf * vdo
    dv = torch.einsum("bshkv,bshk->bshv", gs, kf) + ruk * dof
    dw = (gs * hp).sum(-1)
    du = (rf * kf * vdo).sum((0, 1))
    return (dr.to(r.dtype), dw.to(w.dtype), dk.to(k.dtype), dv.to(v.dtype),
            du.to(u.dtype), None if h0 is None else G)


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
    raises on anything else. u is widened to float32 here. Where grad is
    enabled and an input requires it, the call goes through
    :class:`RwkvScanFn` (the same route with checkpoints,
    :func:`rwkv_scan_bwd` as its backward; ``state_out`` raises there).
    ``launches`` counts the forward kernel's launches,
    ``launches_by_route`` each route's.
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
    grad = _wants_grad(r, w, k, v, u, h0)
    if grad and state_out is not None:
        raise ValueError("rwkv_scan under grad takes no state_out")
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
    if grad:
        return RwkvScanFn.apply(r, w, k, v, uf, h0)
    return _launch(route, r, w, k, v, uf, h0, state)[0], state


def _launch(route: str, r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, uf: torch.Tensor, h0: torch.Tensor | None,
            state: torch.Tensor, want_ckpt: bool = False):
    """Launches ``route``'s kernel on tensors :func:`rwkv_scan` has checked
    (u already float32), writes the final state into ``state``, counts the
    launch and returns (o, the checkpoints (B, H, ceil(S / CHUNK), K, V)
    float32 with ``want_ckpt``, else None): the chunked route's carry
    leaves them in its workspace U, the serial kernel writes them when
    given the tensor."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    o = torch.empty((B, S, H, V), dtype=v.dtype, device=r.device)
    lib = build.library("linear_scan", _SIGNATURES)
    h0_ptr = None if h0 is None else h0.data_ptr()
    n_chunks = -(-S // CHUNK)
    ckpt = None
    with torch.cuda.device(r.device):
        stream = build.stream_ptr(r.device)
        if route == "chunk":
            U = torch.empty((B, H, n_chunks, K, V), dtype=torch.float32,
                            device=r.device)
            P = torch.empty((B, H, n_chunks, K), dtype=torch.float32,
                            device=r.device)
            rc = lib.rwkv_scan_chunk(
                r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
                uf.data_ptr(), h0_ptr, o.data_ptr(), state.data_ptr(),
                U.data_ptr(), P.data_ptr(), B, S, H, stream)
            ckpt = U if want_ckpt else None
        else:
            if want_ckpt:
                ckpt = torch.empty((B, H, n_chunks, K, V),
                                   dtype=torch.float32, device=r.device)
            rc = lib.rwkv_scan(
                r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
                uf.data_ptr(), h0_ptr, o.data_ptr(), state.data_ptr(),
                _DTYPES[r.dtype], B, S, H, K, V,
                None if ckpt is None else ckpt.data_ptr(), stream)
    build.check(lib, rc, f"rwkv_scan ({route})")
    build.count_launch(rwkv_scan, route)
    return o, ckpt


rwkv_scan.launches = 0
rwkv_scan.launches_by_route = {"chunk": 0, "serial": 0}


class RwkvScanFn(torch.autograd.Function):
    """The RWKV6 scan under autograd: the forward kernel of the call's
    route, keeping the state each :data:`CHUNK` steps start from, and
    :func:`rwkv_scan_bwd` as its backward (on CPU tensors the plain versions
    of both). Takes u already float32; its gradient goes back through the
    caller's widening."""

    @staticmethod
    def forward(ctx, r, w, k, v, uf, h0):
        ctx.set_materialize_grads(False)
        B, S, H, K, V = _check_shapes(r, w, k, v, uf, h0)
        if r.device.type == "cpu":
            (o, h), ckpt = rwkv_scan_plain(r, w, k, v, uf, h0), None
        else:
            h = torch.empty((B, H, K, V), dtype=torch.float32,
                            device=r.device)
            o, ckpt = _launch(_route(r.dtype, K, V, S), r, w, k, v, uf, h0,
                              h, want_ckpt=True)
        ctx.save_for_backward(r, w, k, v, uf, h0, ckpt)
        return o, h

    @staticmethod
    def backward(ctx, do, dh):
        r, w, k, v, uf, h0, ckpt = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(v)
        return rwkv_scan_bwd(r, w, k, v, uf, h0, do.contiguous(),
                             None if dh is None else dh.contiguous(),
                             ckpt=ckpt)


def rwkv_scan_bwd(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, u: torch.Tensor, h0: torch.Tensor | None,
                  do: torch.Tensor, dh: torch.Tensor | None = None, *,
                  ckpt: torch.Tensor | None = None):
    """The gradients of :func:`rwkv_scan` at ``do`` (B, S, H, V) and the
    final state's ``dh`` (B, H, K, V) or None: (dr, dw, dk, dv, du, dh0),
    each in its input's dtype (dh0 float32, None where h0 is).

    A CPU tensor goes to :func:`rwkv_scan_bwd_plain`; a CUDA tensor to the
    kernel of its route (:func:`_rwkv_bwd_route`) in
    ``csrc/linear_scan_bwd.cu``, which recomputes the states from ``ckpt``
    (B, H, ceil(S / CHUNK), K, V) float32, the forward kernel's
    checkpoints, and takes what the serial forward takes (K = V in :data:`WIDTHS`), float32 u, dh and ckpt,
    contiguous do in v's dtype, 16-byte aligned ckpt (the chunked route
    every tensor 16-byte aligned), and raises ValueError on anything else.
    ``launches`` counts its calls, ``launches_by_route`` each route's (the
    serial route launches its kernel and one pass that adds du's per-row
    sums in a fixed order; the chunked route its three steps and that
    pass)."""
    B, S, H, K, V = _check_shapes(r, w, k, v, u, h0)
    if tuple(do.shape) != (B, S, H, V) or (
            dh is not None and tuple(dh.shape) != (B, H, K, V)):
        raise ValueError(f"do {tuple(do.shape)}, dh "
                         f"{None if dh is None else tuple(dh.shape)} do not "
                         f"fit r {tuple(r.shape)}")
    if r.device.type == "cpu":
        return rwkv_scan_bwd_plain(r, w, k, v, u, h0, do, dh)
    route = _rwkv_bwd_route(r.dtype, K, V)
    NC = -(-S // CHUNK)
    if ckpt is None or tuple(ckpt.shape) != (B, H, NC, K, V):
        raise ValueError(f"the backward kernel needs the forward's "
                         f"checkpoints, (B, H, {NC}, K, V) float32")
    if any(t.dtype != r.dtype for t in (k, v, do)):
        raise ValueError("rwkv backward kernel takes r, k, v, do of one "
                         "dtype")
    f32 = [w, u, ckpt] + ([] if dh is None else [dh])
    tensors = [r, k, v, do] + f32
    for t in tensors:
        if t.device != r.device or not t.is_contiguous():
            raise ValueError("rwkv backward kernel takes contiguous tensors "
                             "on one device")
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("rwkv backward kernel takes float32 w, u, ckpt, dh")
    aligned = tensors if route == "chunk" else [ckpt]
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"the {route} rwkv backward route takes 16-byte "
                         f"aligned {'tensors' if route == 'chunk' else 'ckpt'}")
    f = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du = torch.empty((H, K), **f)
    dh0 = torch.empty((B, H, K, V), **f)
    ptrs = (r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), do.data_ptr(),
            None if dh is None else dh.data_ptr(), dr.data_ptr(),
            dw.data_ptr(), dk.data_ptr(), dv.data_ptr(), du.data_ptr(),
            dh0.data_ptr())
    lib = build.library("linear_scan_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(r.device):
        if route == "chunk":
            R = torch.empty((B, H, NC, K, V), **f)
            P = torch.empty((B, H, NC, K), **f)
            du_part = torch.empty((B, NC, H, K), **f)
            rc = lib.rwkv_scan_bwd_chunk(
                *ptrs, R.data_ptr(), P.data_ptr(), du_part.data_ptr(), B, S,
                H, build.stream_ptr(r.device))
        else:
            hist = torch.empty((B, H, CHUNK, K, V), **f)
            du_part = torch.empty((B, H, K), **f)
            rc = lib.rwkv_scan_bwd(
                *ptrs, hist.data_ptr(), du_part.data_ptr(), _DTYPES[r.dtype],
                B, S, H, K, build.stream_ptr(r.device))
    build.check(lib, rc, f"rwkv_scan_bwd ({route})")
    build.count_launch(rwkv_scan_bwd, route)
    return dr, dw, dk, dv, du, None if h0 is None else dh0


rwkv_scan_bwd.launches = 0
rwkv_scan_bwd.launches_by_route = {"chunk": 0, "serial": 0}


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
