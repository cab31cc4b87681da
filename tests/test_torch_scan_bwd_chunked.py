"""The chunked routes of the two scan backwards (``csrc/linear_scan_bwd.cu``:
``rwkv_bwd_{adj,carry,grad}_kernel`` and ``mamba_bwd_{adj,carry,grad}_kernel``),
emulated in NumPy, float64 and float32, in the kernels' order, against the
plain formulas (``linear_scan.*_scan_bwd_plain``) and ``jax.grad`` of the
JAX package's XLA scans (``repro.kernels.ops`` with ``impl="xla"``).

The emulations walk the routes' three steps: (a) each chunk of
``linear_scan.CHUNK`` steps alone, its own part of the adjoint walked back
from zero (RWKV6: R_c = sum_j (r_j prod_{t0<=s<j} w_s) do_j^T, the decay
before j taken step by step within 16-step sub-chunks and times the earlier
sub-chunks' whole decays; Mamba: the adjoint from zero and the chunk's
summed step sizes); (b) the reverse carry across chunks, seeded by the final
state's gradient; (c) each chunk's gradients from the forward's checkpoint:
the state every ``WIN`` steps kept, each window's states recomputed from its
first and the adjoint stepped back through them. Rows past S are padded as
the kernels pad them (decay 1, the rest 0). No step divides by a decay, so
decays of exactly 0, denormals and 1 pass through: an order error (a window
walked from the wrong state, a carry off by a chunk, a decay taken over the
wrong range) moves the result far past the tolerances on S = 1, 5 (less
than a window), 37 (one ragged chunk), 64 (one whole chunk), 65 (a chunk
boundary) and 130: the chunked routes take every S. Tolerances, of
each largest gradient: the float64 emulation 1e-5 (the plain formulas' and
JAX's float32 roundings), the float32 one 1e-4 (the card's float32 gate; it
sums in another order). The kernels themselves are held to the plain
versions on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops

from repro_torch.kernels import linear_scan as ls

CK = ls.CHUNK                 # steps a chunk: the checkpoints' spacing
SUB = 16                      # steps a sub-chunk of the RWKV6 step (a)
WIN = 8                       # steps a window of step (c)
LOG2E = 1.4426950408889634
RTOL = {np.float64: 1e-5, np.float32: 1e-4}
RWKV_NAMES = ("r", "w", "k", "v", "u", "h0")
MAMBA_NAMES = ("delta", "A", "Bt", "Ct", "x", "h0")
# (S, with h0 and a final-state gradient, hard decays)
CASES = {"one_step": (1, True, False),
         "under_a_window": (5, True, True),
         "one_ragged_chunk": (37, False, False),
         "one_chunk": (64, True, False),
         "chunk_boundary": (65, True, False),
         "hard_decays": (130, True, True),
         "hard_decays_no_h0": (130, False, True)}


def _pad(a: np.ndarray, Sp: int, fill: float) -> np.ndarray:
    """a (B, S, ...) padded along S to Sp with ``fill``."""
    pad = np.full((a.shape[0], Sp - a.shape[1]) + a.shape[2:], fill, a.dtype)
    return np.concatenate([a, pad], axis=1)


# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------

def _rwkv_inputs(B, S, H, K, seed, hard):
    """float32 numpy r, w, k, v, u, h0, do, dh; decays exp(-exp(N(0, 1)))
    and, with ``hard``, exactly 0, a denormal (1e-40) or 1 in about 5% of
    them each (chip_smoke.hard_decays)."""
    rng = np.random.default_rng(seed)
    r, v = rng.normal(size=(B, S, H, K)), rng.normal(size=(B, S, H, K))
    k = 0.3 * rng.normal(size=(B, S, H, K))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, K))))
    if hard:
        sel = rng.random(w.shape)
        w[sel < 0.05] = 0.0
        w[(sel >= 0.05) & (sel < 0.10)] = 1e-40
        w[(sel >= 0.10) & (sel < 0.15)] = 1.0
    u = 0.5 * rng.normal(size=(H, K))
    h0 = 0.1 * rng.normal(size=(B, H, K, K))
    do, dh = rng.normal(size=(B, S, H, K)), rng.normal(size=(B, H, K, K))
    return [a.astype(np.float32) for a in (r, w, k, v, u, h0, do, dh)]


def rwkv_chunked_emulation(r, w, k, v, u, h0, do, dh, dt):
    """(dr, dw, dk, dv, du, dh0) by the chunked RWKV6 backward's order in
    ``dt``; h0 and dh may be None (zeros)."""
    r, w, k, v, u, do = (a.astype(dt) for a in (r, w, k, v, u, do))
    B, S, H, K = r.shape
    V = v.shape[-1]
    NC = -(-S // CK)
    Sp = NC * CK
    h = np.zeros((B, H, K, V), dt) if h0 is None else h0.astype(dt)
    ckpt = np.empty((B, H, NC, K, V), dt)      # the forward's checkpoints
    for t in range(S):
        if t % CK == 0:
            ckpt[:, :, t // CK] = h
        h = w[:, t, :, :, None] * h + k[:, t, :, :, None] * v[:, t, :, None, :]
    rp, kp, vp, dop = (_pad(a, Sp, 0.0) for a in (r, k, v, do))
    wp = _pad(w, Sp, 1.0)
    # (a) R_c and P_c, each chunk alone
    R = np.empty((B, H, NC, K, V), dt)
    P = np.empty((B, H, NC, K), dt)
    for c in range(NC):
        rows = slice(c * CK, (c + 1) * CK)
        wc, rc = wp[:, rows].transpose(0, 2, 1, 3), rp[:, rows].transpose(0, 2, 1, 3)
        dc = dop[:, rows].transpose(0, 2, 1, 3)
        wr = np.empty_like(rc)
        wsub = []
        for p in range(CK // SUB):
            q = np.ones((B, H, K), dt)
            for j in range(SUB * p, SUB * (p + 1)):
                wr[:, :, j] = rc[:, :, j] * q
                q = q * wc[:, :, j]
            wsub.append(q)
        for p in range(CK // SUB):
            before = np.ones((B, H, K), dt)
            for pp in range(p):
                before = before * wsub[pp]
            wr[:, :, SUB * p:SUB * (p + 1)] *= before[:, :, None]
            if p == CK // SUB - 1:
                P[:, :, c] = before * wsub[p]
        R[:, :, c] = np.einsum("bhjk,bhjv->bhkv", wr, dc)
    # (b) the reverse carry: G_end(c - 1) = P_c G_end(c) + R_c
    G = np.zeros((B, H, K, V), dt) if dh is None else dh.astype(dt)
    Gend = np.empty_like(R)
    for c in reversed(range(NC)):
        Gend[:, :, c] = G
        G = P[:, :, c, :, None] * G + R[:, :, c]
    dh0 = G
    # (c) each chunk's gradients from its checkpoint and G_end(c)
    vdo = (vp * dop).sum(-1)[..., None]                      # (B, Sp, H, 1)
    ruk = (rp * u * kp).sum(-1)[..., None]
    dr, dk, dw = (np.zeros((B, Sp, H, K), dt) for _ in range(3))
    dv = np.zeros((B, Sp, H, V), dt)
    du = np.zeros((H, K), dt)

    def step(t, st):
        return wp[:, t, :, :, None] * st + kp[:, t, :, :, None] * vp[:, t, :, None, :]
    for c in range(NC):
        t0 = c * CK
        nwin = -(-min(CK, S - t0) // WIN)
        st, first = ckpt[:, :, c], []
        for j in range((nwin - 1) * WIN + 1):
            if j % WIN == 0:
                first.append(st)
            if j < (nwin - 1) * WIN:
                st = step(t0 + j, st)
        G = Gend[:, :, c]
        for win in reversed(range(nwin)):
            tw = t0 + win * WIN
            hs = [first[win]]
            for s in range(WIN - 1):
                hs.append(step(tw + s, hs[-1]))
            for s in reversed(range(WIN)):
                t = tw + s
                rt, wt, kt = rp[:, t], wp[:, t], kp[:, t]
                vv, dd = vp[:, t], dop[:, t]
                dr[:, t] = (hs[s] * dd[:, :, None]).sum(-1) + u * kt * vdo[:, t]
                dk[:, t] = (G * vv[:, :, None]).sum(-1) + u * rt * vdo[:, t]
                dw[:, t] = (G * hs[s]).sum(-1)
                dv[:, t] = (G * kt[..., None]).sum(2) + ruk[:, t] * dd
                du += (rt * kt * vdo[:, t]).sum(0)
                G = wt[..., None] * G + rt[..., None] * dd[:, :, None]
    return dr[:, :S], dw[:, :S], dk[:, :S], dv[:, :S], du, dh0


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

def _mamba_inputs(B, S, Di, N, seed, hard):
    """float32 numpy delta, A, Bt, Ct, x, h0, dy, dh; with ``hard``, delta =
    100 in about 5% of its elements, so that exp(delta A) is 0 or a
    denormal (chip_smoke.hard_steps)."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(size=(B, S, Di))))
    if hard:
        delta[rng.random(delta.shape) < 0.05] = 100.0
    A = -np.exp(0.5 * rng.normal(size=(Di, N)))
    Bt, Ct = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    x = rng.normal(size=(B, S, Di))
    h0 = 0.5 * rng.normal(size=(B, Di, N))
    dy, dh = rng.normal(size=(B, S, Di)), rng.normal(size=(B, Di, N))
    return [a.astype(np.float32) for a in (delta, A, Bt, Ct, x, h0, dy, dh)]


def mamba_chunked_emulation(delta, A, Bt, Ct, x, h0, dy, dh, dt):
    """(d delta, dA, dBt, dCt, dx, dh0) by the chunked Mamba backward's
    order in ``dt``, every decay 2^(delta A log2 e) as the kernels form it;
    h0 and dh may be None (zeros)."""
    delta, A, Bt, Ct, x, dy = (a.astype(dt) for a in (delta, A, Bt, Ct, x, dy))
    B, S, Di = delta.shape
    N = A.shape[1]
    NC = -(-S // CK)
    Sp = NC * CK
    a = A * dt(LOG2E)                                        # (Di, N)
    dp, xp, yp = (_pad(t, Sp, 0.0) for t in (delta, x, dy))
    bp, cp = _pad(Bt, Sp, 0.0), _pad(Ct, Sp, 0.0)
    dxp = dp * xp

    def decay(t):
        return np.exp2(dp[:, t, :, None] * a)                # (B, Di, N)

    def step(t, h):
        return decay(t) * h + dxp[:, t, :, None] * bp[:, t, None, :]
    h = np.zeros((B, Di, N), dt) if h0 is None else h0.astype(dt)
    ckpt = np.empty((B, NC, Di, N), dt)                       # the forward's
    for t in range(S):
        if t % CK == 0:
            ckpt[:, t // CK] = h
        h = step(t, h)
    # (a) each chunk's adjoint from zero and its summed step sizes
    L = np.empty((B, NC, Di, N), dt)
    sumd = np.empty((B, NC, Di), dt)
    for c in range(NC):
        X, sd = np.zeros((B, Di, N), dt), np.zeros((B, Di), dt)
        for t in reversed(range(c * CK, min((c + 1) * CK, S))):
            sd = sd + dp[:, t]
            X = (X + yp[:, t, :, None] * cp[:, t, None, :]) * decay(t)
        L[:, c], sumd[:, c] = X, sd
    # (b) the reverse carry: X_{c-1} = exp(A sum_c delta) X_c + L_c
    X = np.zeros((B, Di, N), dt) if dh is None else dh.astype(dt)
    Xend = np.empty_like(L)
    for c in reversed(range(NC)):
        Xend[:, c] = X
        X = np.exp2(a * sumd[:, c, :, None]) * X + L[:, c]
    dh0 = X
    # (c) each chunk's gradients from its checkpoint and X_c
    dd_out, dx_out = np.zeros((B, Sp, Di), dt), np.zeros((B, Sp, Di), dt)
    dB, dC = np.zeros((B, Sp, N), dt), np.zeros((B, Sp, N), dt)
    dA = np.zeros((Di, N), dt)
    for c in range(NC):
        t0 = c * CK
        nwin = -(-min(CK, S - t0) // WIN)
        h, first = ckpt[:, c], []
        for j in range((nwin - 1) * WIN + 1):
            if j % WIN == 0:
                first.append(h)
            if j < (nwin - 1) * WIN:
                h = step(t0 + j, h)
        g = Xend[:, c]
        for win in reversed(range(nwin)):
            tw = t0 + win * WIN
            hs, es = [first[win]], []
            for s in range(WIN):
                es.append(decay(tw + s))
                hs.append(es[-1] * hs[-1] + dxp[:, tw + s, :, None] * bp[:, tw + s, None, :])
            for s in reversed(range(WIN)):
                t = tw + s
                bt, ct = bp[:, t, None, :], cp[:, t, None, :]
                g = g + yp[:, t, :, None] * ct                  # g_t
                geh = g * es[s] * hs[s]
                ddx = (g * bt).sum(-1)
                dC[:, t] = (yp[:, t, :, None] * hs[s + 1]).sum(1)
                dB[:, t] = (g * dxp[:, t, :, None]).sum(1)
                dd_out[:, t] = ddx * xp[:, t] + (geh * A).sum(-1)
                dx_out[:, t] = ddx * dp[:, t]
                dA += (geh * dp[:, t, :, None]).sum(0)
                g = g * es[s]
    return (dd_out[:, :S], dA, dB[:, :S], dC[:, :S], dx_out[:, :S], dh0)


# --------------------------------------------------------------------------
# The emulations against the plain formulas and JAX
# --------------------------------------------------------------------------

def _close(got, want, name, rtol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"d{name}: {err} against {scale}"


def _case(kind, case):
    S, with_h0, hard = CASES[case]
    if kind == "rwkv":
        *ins, dout, dh = _rwkv_inputs(2, S, 2, 8, seed=S, hard=hard)
    else:
        *ins, dout, dh = _mamba_inputs(2, S, 6, 4, seed=S, hard=hard)
    if not with_h0:
        ins[5], dh = None, None
    return ins, dout, dh


def _jax_grads(fn, arrays, dout, dh):
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def loss(*live):
        args = list(arrays)
        for i, a in zip(idx, live):
            args[i] = a
        y, h = fn(*args)
        out = jnp.sum(y * dout)
        return out if dh is None else out + jnp.sum(h * dh)
    live = [jnp.asarray(arrays[i]) for i in idx]
    return jax.grad(loss, argnums=tuple(range(len(live))))(*live)


EMULATIONS = {"rwkv": (rwkv_chunked_emulation, ls.rwkv_scan_bwd_plain,
                       RWKV_NAMES),
              "mamba": (mamba_chunked_emulation, ls.mamba_scan_bwd_plain,
                        MAMBA_NAMES)}


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_chunked_emulation_vs_plain_formulas(kind, case, dt):
    emulate, plain, names = EMULATIONS[kind]
    ins, dout, dh = _case(kind, case)
    got = [g for g in emulate(*ins, dout, dh, dt)]
    if ins[5] is None:
        got[5] = None
    t = [None if a is None else torch.tensor(a) for a in ins]
    want = plain(*t, torch.tensor(dout), None if dh is None
                 else torch.tensor(dh))
    for name, g, w in zip(names, got, want):
        if w is not None:
            _close(g, w.numpy(), name, RTOL[dt])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_chunked_emulation_vs_jax_grad_of_the_xla_scan(kind, case):
    emulate, _, names = EMULATIONS[kind]
    ins, dout, dh = _case(kind, case)
    got = [g for g in emulate(*ins, dout, dh, np.float64)]
    scan = jax_ops.rwkv_scan if kind == "rwkv" else jax_ops.mamba_scan
    want = _jax_grads(lambda *a: scan(*a, impl="xla", chunk=16), ins, dout,
                      dh)
    live = [g for g, a in zip(got, ins) if a is not None]
    for name, g, w in zip([n for n, a in zip(names, ins) if a is not None],
                          live, want):
        _close(g, w, name, RTOL[np.float64])


def test_the_emulations_divide_by_no_decay():
    """With every decay of the hard cases 0 (RWKV6 w = 0; Mamba delta =
    100 at A <= -16, exp(delta A) = 0 in float32), the emulations stay
    finite and equal the plain formulas, which only multiply."""
    ins, dout, dh = _case("rwkv", "hard_decays")
    ins[1] = np.zeros_like(ins[1])
    got = rwkv_chunked_emulation(*ins, dout, dh, np.float32)
    want = ls.rwkv_scan_bwd_plain(*(torch.tensor(a) for a in ins),
                                  torch.tensor(dout), torch.tensor(dh))
    for name, g, w in zip(RWKV_NAMES, got, want):
        _close(g, w.numpy(), name, RTOL[np.float32])
    ins, dout, dh = _case("mamba", "hard_decays")
    ins[0] = np.full_like(ins[0], 100.0)
    ins[1] = np.minimum(ins[1], -16.0)
    got = mamba_chunked_emulation(*ins, dout, dh, np.float32)
    want = ls.mamba_scan_bwd_plain(*(torch.tensor(a) for a in ins),
                                   torch.tensor(dout), torch.tensor(dh))
    for name, g, w in zip(MAMBA_NAMES, got, want):
        _close(g, w.numpy(), name, RTOL[np.float32])


# --------------------------------------------------------------------------
# The route functions
# --------------------------------------------------------------------------

bf16, f32 = torch.bfloat16, torch.float32


# (dtype, width, S, the forward route, the backward route): the chunked
# backward reads only the checkpoints, which every forward route writes,
# so it takes its widths at any S, behind any forward route
@pytest.mark.parametrize("dtype,K,S,fwd,want", [
    (bf16, 64, 1024, "chunk", "chunk"),         # rwkv6-3b's training shape
    (bf16, 64, ls.CHUNK_MIN_S, "chunk", "chunk"),
    (bf16, 64, ls.CHUNK_MIN_S - 1, "serial", "chunk"),
    (bf16, 64, 1, "serial", "chunk"),
    (f32, 64, 1024, "serial", "serial"),        # float32 stays serial
    (bf16, 16, 1024, "serial", "serial"),       # the smoke config's width
    (f32, 16, 45, "serial", "serial")])
def test_rwkv_backward_routes(dtype, K, S, fwd, want):
    assert ls._route(dtype, K, K, S) == fwd
    assert ls._rwkv_bwd_route(dtype, K, K) == want


@pytest.mark.parametrize("dtype,N,S,fwd,want", [
    (bf16, 16, 1024, "segmented", "chunk"),     # jamba's training shape
    (f32, 16, 1024, "segmented", "chunk"),      # the chunked route takes fp32
    (bf16, 16, ls.MAMBA_SEG_MIN_S, "segmented", "chunk"),
    (bf16, 16, ls.MAMBA_SEG_MIN_S - 1, "serial", "chunk"),
    (bf16, 16, 1, "step", "chunk"),             # the step forward's S = 1
    (f32, 4, 1024, "serial", "serial"),         # the smoke config's N
    (bf16, 4, 45, "serial", "serial")])
def test_mamba_backward_routes(dtype, N, S, fwd, want):
    assert ls._mamba_route(dtype, N, S) == fwd
    assert ls._mamba_bwd_route(dtype, N) == want


@pytest.mark.parametrize("args", [(torch.float16, 64, 64),
                                  (bf16, 32, 32), (bf16, 64, 16)])
def test_rwkv_backward_route_raises_on_what_no_route_takes(args):
    with pytest.raises(ValueError):
        ls._rwkv_bwd_route(*args)


@pytest.mark.parametrize("args", [(torch.float16, 16), (bf16, 8), (f32, 32)])
def test_mamba_backward_route_raises_on_what_no_route_takes(args):
    with pytest.raises(ValueError):
        ls._mamba_bwd_route(*args)


def test_backward_wrappers_count_each_route():
    """Both wrappers keep a launch count by route, for the chunked route
    and the serial one; the CPU path launches nothing."""
    for wrapper in (ls.rwkv_scan_bwd, ls.mamba_scan_bwd):
        assert set(wrapper.launches_by_route) == {"chunk", "serial"}
    ins, dout, dh = _case("rwkv", "one_ragged_chunk")
    before = dict(ls.rwkv_scan_bwd.launches_by_route)
    ls.rwkv_scan_bwd(*(None if a is None else torch.tensor(a) for a in ins),
                     torch.tensor(dout))
    assert ls.rwkv_scan_bwd.launches_by_route == before
