"""The kv128 wgmma backward of flash attention (``csrc/flash_attention_bwd.cu``
``flash_bwd_kv128_kernel``: bf16 at (D, Dv) = (192, 128), deepseek-v2's
MLA), emulated in NumPy float32 block by block, against the plain formulas
(``flash_attention_bwd_plain``).

The emulation walks the kernel's schedule: one block per (128-key tile, kv
head, batch row), two warpgroups of 64 keys each; the q tiles of 64 rows
the block visits, from the kernel's predicate on causality, the window and
q_offset at the block's 128 keys; a warpgroup's products only where its
own ``live`` predicate says a row of the q tile sees one of its keys; the
mask applied only on the (q tile, warpgroup) pairs the kernel's ``edge``
test names; P and dS rounded to bf16 before their products; dK and dV
summed in the warpgroup over its (G head, q tile) iterations; dQ of a q
tile summed over the block's live warpgroups in two column halves (0-95 by
warpgroup 0, 96-191 by warpgroup 1), scaled, then over the key tiles in
fp32 and rounded once. A predicate that skipped a visible pair, an edge
test that missed a masked one, or a column half summed over the wrong keys
moves the result off the plain formulas by far more than the bf16
tolerance, on shapes whose windows cut tiles and whose Sq and Skv are no
multiple of 64 or 128. The kernel itself is held to the plain version on
the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

BQ = 64                                   # q rows a tile, keys a warpgroup
BK = 128                                  # keys a block
HALF = 96                                 # dQ columns a warpgroup
LOG2E = 1.4426950408889634
# the card's tolerance: 2e-2 of the largest gradient (bf16 P and dS)
RTOL = 2e-2


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _q_tiles(k0, Skv, Sq, causal, window, q_offset):
    """The kernel's q tiles for the block's keys from k0: (first, count)."""
    k_last = min(k0 + BK, Skv) - 1
    i_begin, i_end = 0, Sq
    if causal:
        i_begin = max(0, k0 - q_offset)
    if window:
        i_end = min(Sq, k_last + window - q_offset)
    qt_begin = i_begin // BQ
    n_qt = -(-i_end // BQ) - qt_begin if i_end > i_begin else 0
    return qt_begin, n_qt


def _live(t, k0, q0, Sq, Skv, causal, window, q_offset):
    """The kernel's ``live``: does a row of the q tile at q0 see a key of
    warpgroup t's 64?"""
    first = k0 + BQ * t
    last = min(first + BQ - 1, Skv - 1)
    qp0, qp1 = q0 + q_offset, min(q0 + BQ, Sq) - 1 + q_offset
    ok = first < Skv
    if causal:
        ok = ok and first <= qp1
    if window:
        ok = ok and last > qp0 - window
    return ok


def _edge(q0, kw0, Sq, Skv, causal, window, q_offset):
    """The kernel's test (``probs_from_s``) of whether a (q tile,
    warpgroup) pair needs the mask: it crosses Sq, Skv, the diagonal or the
    window's edge."""
    qp0 = q0 + q_offset
    return (q0 + BQ > Sq or kw0 + BQ > Skv or (causal and kw0 + 63 > qp0)
            or (window > 0 and kw0 <= qp0 + BQ - 1 - window))


def kv128_kernel_emulation(q, k, v, o, lse, do, *, causal=True, window=None,
                           q_offset=0, scale=None):
    """dQ, dK, dV (float32 arrays rounded to bf16, as the kernel stores
    them) by the kv128 kernel's schedule and roundings, and the number of
    (q tile, warpgroup) products; inputs bf16 values as float32 arrays, q
    (B, Sq, H, 192), k (B, Skv, KV, 192), v, o, do with 128, lse (B, H,
    Sq)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    assert (D, Dv) == (2 * HALF, 128)
    G = H // KV
    scale = D ** -0.5 if scale is None else scale
    window = window or 0
    Sp = -(-Sq // BQ) * BQ
    lse2 = np.zeros((B, H, Sp), np.float32)
    lse2[:, :, :Sq] = lse * LOG2E
    delta = np.zeros((B, H, Sp), np.float32)
    delta[:, :, :Sq] = np.einsum("bihe,bihe->bhi", do, o)
    # TMA's zero fill past Sq and Skv
    Kp = -(-Skv // BK) * BK
    qz = np.zeros((B, Sp, H, D), np.float32)
    qz[:, :Sq] = q
    doz = np.zeros((B, Sp, H, Dv), np.float32)
    doz[:, :Sq] = do
    kz = np.zeros((B, Kp, KV, D), np.float32)
    kz[:, :Skv] = k
    vz = np.zeros((B, Kp, KV, Dv), np.float32)
    vz[:, :Skv] = v
    dq = np.zeros((B, Sp, H, D), np.float32)
    dk = np.zeros((B, Skv, KV, D), np.float32)
    dv = np.zeros((B, Skv, KV, Dv), np.float32)
    products = 0
    rows = np.arange(BQ)
    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, Skv, BK):
                qt_begin, n_qt = _q_tiles(k0, Skv, Sq, causal, window,
                                          q_offset)
                dka = np.zeros((2, BQ, D), np.float32)
                dva = np.zeros((2, BQ, Dv), np.float32)
                for j in range(G * n_qt):
                    h = kvh * G + j // n_qt
                    q0 = (qt_begin + j % n_qt) * BQ
                    qt = qz[b, q0:q0 + BQ, h]
                    dot = doz[b, q0:q0 + BQ, h]
                    ds_tiles = {}
                    for w in range(2):
                        if not _live(w, k0, q0, Sq, Skv, causal, window,
                                     q_offset):
                            continue
                        kw0 = k0 + BQ * w
                        kt = kz[b, kw0:kw0 + BQ, kvh]
                        vt = vz[b, kw0:kw0 + BQ, kvh]
                        p = np.exp2(kt @ qt.T * (scale * LOG2E)
                                    - lse2[b, h, q0:q0 + BQ][None])
                        if _edge(q0, kw0, Sq, Skv, causal, window, q_offset):
                            kpos = kw0 + rows[:, None]
                            qpos = q0 + q_offset + rows[None, :]
                            ok = (q0 + rows[None, :] < Sq) & (kpos < Skv)
                            if causal:
                                ok &= kpos <= qpos
                            if window:
                                ok &= kpos > qpos - window
                            p = np.where(ok, p, 0.0)
                        pb = _bf16(p)
                        dva[w] += pb @ dot
                        ds = _bf16(pb * (vt @ dot.T
                                         - delta[b, h, q0:q0 + BQ][None]))
                        dka[w] += ds @ qt
                        ds_tiles[w] = ds
                        products += 1
                    # dQ of the q tile over the block's live keys, one
                    # column half a warpgroup
                    for half in range(2):
                        cols = slice(HALF * half, HALF * (half + 1))
                        acc = np.zeros((BQ, HALF), np.float32)
                        for w, ds in ds_tiles.items():
                            kw0 = k0 + BQ * w
                            acc += ds.T @ kz[b, kw0:kw0 + BQ, kvh, cols]
                        dq[b, q0:q0 + BQ, h, cols] += acc * scale
                for w in range(2):
                    kw0 = k0 + BQ * w
                    n = max(0, min(BQ, Skv - kw0))
                    dk[b, kw0:kw0 + n, kvh] = _bf16(dka[w, :n] * scale)
                    dv[b, kw0:kw0 + n, kvh] = _bf16(dva[w, :n])
    return _bf16(dq[:, :Sq]), dk, dv, products


# (B, Sq, Skv, H, KV, kwargs) at MLA's (192 | 128): the training layout
# (MHA) at a ragged S = 37 (one block, its second warpgroup's keys all past
# Skv) and S = 200, a window cutting tiles with an offset chunk, Skv > Sq
# with an offset no tile divides, non-causal, an offset of 1 (a
# warpgroup's first key seen by the last row of a q tile alone), and G = 2
# at S = 333
KV128_CASES = [
    (2, 37, 37, 2, 2, {"causal": True}),
    (1, 200, 200, 3, 3, {"causal": True}),
    (1, 130, 190, 2, 2, {"causal": True, "window": 90, "q_offset": 60}),
    (1, 300, 300, 2, 2, {"causal": True, "window": 100}),
    (1, 150, 270, 2, 2, {"causal": True, "q_offset": 120}),
    (1, 100, 140, 2, 2, {"causal": False}),
    (1, 200, 260, 2, 2, {"causal": True, "q_offset": 1}),
    (1, 333, 333, 4, 2, {"causal": True, "scale": 192 ** -0.5}),
]


def _inputs(B, Sq, Skv, H, KV, seed):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.normal(size=(B, Sq, H, 192)))
    k = _bf16(rng.normal(size=(B, Skv, KV, 192)))
    v = _bf16(rng.normal(size=(B, Skv, KV, 128)))
    do = _bf16(rng.normal(size=(B, Sq, H, 128)))
    return q, k, v, do


@pytest.mark.parametrize("B,Sq,Skv,H,KV,kw", KV128_CASES)
def test_kv128_kernel_emulation_vs_plain_formulas(B, Sq, Skv, H, KV, kw):
    """The emulated kv128 kernel within the card's 2e-2 of the largest
    gradient of the plain formulas (float32 on the same bf16 inputs, o and
    lse), and the route the wrapper gives MLA's widths."""
    assert fa._bwd_route(torch.bfloat16, 192, 128) == "wgmma_kv128"
    q, k, v, do = _inputs(B, Sq, Skv, H, KV, seed=Sq + 7 * Skv)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa.flash_attention_plain(tq, tk, tv, **kw).to(torch.bfloat16).float()
    lse = fa.flash_attention_lse_plain(tq, tk, tv, **kw)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    *got, products = kv128_kernel_emulation(q, k, v, o.numpy(), lse.numpy(),
                                            do, **kw)
    assert products > 0
    for name, a, w in zip("QKV", got, want):
        w = w.numpy()
        top = float(np.abs(w).max())
        err = float(np.abs(a - w).max())
        assert err <= RTOL * top, (name, err, top)


SCHEDULES = ((300, 300, True, 100, 0), (1024, 1024, True, None, 0),
             (2048, 2048, True, 1024, 0), (150, 270, True, None, 120),
             (130, 190, True, 90, 60), (100, 140, False, None, 0),
             (37, 37, True, None, 0), (200, 260, True, None, 1),
             (250, 250, True, 65, 0))


@pytest.mark.parametrize("Sq,Skv,causal,window,off", SCHEDULES)
def test_kv128_schedule_visits_exactly_the_visible_tiles(Sq, Skv, causal,
                                                         window, off):
    """Every (q tile, warpgroup) pair whose products the kernel runs (a q
    tile of the block's range and a live warpgroup) holds a visible pair,
    every skipped one none; and a run pair without the kernel's ``edge``
    mark has every pair visible (the kernel applies no mask there)."""
    mask = fa._mask(Sq, Skv, causal, window, off, "cpu").numpy()
    for k0 in range(0, Skv, BK):
        qt_begin, n_qt = _q_tiles(k0, Skv, Sq, causal, window or 0, off)
        for qt in range(-(-Sq // BQ)):
            q0 = qt * BQ
            for w in range(2):
                kw0 = k0 + BQ * w
                seen = bool(mask[q0:q0 + BQ, kw0:kw0 + BQ].any())
                run = (qt_begin <= qt < qt_begin + n_qt
                       and _live(w, k0, q0, Sq, Skv, causal, window or 0,
                                 off))
                assert seen == run, (Sq, Skv, window, off, k0, qt, w)
                if run and not _edge(q0, kw0, Sq, Skv, causal, window or 0,
                                     off):
                    assert mask[q0:q0 + BQ, kw0:kw0 + BQ].all()
