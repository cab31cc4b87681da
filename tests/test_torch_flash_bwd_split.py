"""The split wgmma backward of flash attention (``csrc/flash_attention_bwd.cu``
``flash_bwd_split_kernel``: bf16 at (D, Dv) = (256, 256), gemma3's heads,
and (192, 128), deepseek-v2's MLA), emulated in NumPy float32 block by
block, against the plain formulas (``flash_attention_bwd_plain``).

The emulation walks the kernel's schedule: one block per (64-key tile, kv
head, batch row); the q tiles of 64 rows the block visits, from the
kernel's predicate on causality, the window and q_offset; the mask
applied only on the tiles the kernel's ``edge`` test names; P and dS
rounded to bf16 before their products; dK and dV summed in the block over
its (G head, q tile) iterations, dQ summed over the key tiles in fp32 and
rounded once. A predicate that skipped a visible pair, or an edge test
that missed a masked one, moves the result off the plain formulas by far
more than the bf16 tolerance, on shapes whose windows cut tiles and whose
Sq and Skv are no multiple of 64. The kernel itself is held to the plain
version on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TILE = 64                                 # keys a block, q rows a tile
LOG2E = 1.4426950408889634
# the card's tolerance: 2e-2 of the largest gradient (bf16 P and dS)
RTOL = 2e-2


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _q_tiles(k0, Skv, Sq, causal, window, q_offset):
    """The kernel's q tiles for the keys from k0: (first, count)."""
    k_last = min(k0 + TILE, Skv) - 1
    i_begin, i_end = 0, Sq
    if causal:
        i_begin = max(0, k0 - q_offset)
    if window:
        i_end = min(Sq, k_last + window - q_offset)
    qt_begin = i_begin // TILE
    n_qt = -(-i_end // TILE) - qt_begin if i_end > i_begin else 0
    return qt_begin, n_qt


def _edge(q0, k0, Sq, Skv, causal, window, q_offset):
    """The kernel's test of whether a (q tile, key tile) pair needs the
    mask: it crosses Sq, Skv, the diagonal or the window's edge."""
    qp0 = q0 + q_offset
    return (q0 + TILE > Sq or k0 + TILE > Skv or (causal and k0 + 63 > qp0)
            or (window > 0 and k0 <= qp0 + TILE - 1 - window))


def split_kernel_emulation(q, k, v, o, lse, do, *, causal=True, window=None,
                           q_offset=0, scale=None):
    """dQ, dK, dV (float32 arrays rounded to bf16, as the kernel stores
    them) by the split kernel's schedule and roundings; inputs bf16 values
    as float32 arrays, q (B, Sq, H, D), k (B, Skv, KV, D), v, o, do with Dv,
    lse (B, H, Sq)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    G = H // KV
    scale = D ** -0.5 if scale is None else scale
    window = window or 0
    Sp = -(-Sq // TILE) * TILE
    # the row pass: lse log2 e and Delta, zeros past Sq
    lse2 = np.zeros((B, H, Sp), np.float32)
    lse2[:, :, :Sq] = lse * LOG2E
    delta = np.zeros((B, H, Sp), np.float32)
    delta[:, :, :Sq] = np.einsum("bihe,bihe->bhi", do, o)
    # TMA's zero fill past Sq and Skv
    Kp = -(-Skv // TILE) * TILE
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
    visits = 0
    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, Skv, TILE):
                kt = kz[b, k0:k0 + TILE, kvh]              # (64, D)
                vt = vz[b, k0:k0 + TILE, kvh]              # (64, Dv)
                kpos = k0 + np.arange(TILE)[:, None]
                qt_begin, n_qt = _q_tiles(k0, Skv, Sq, causal, window,
                                          q_offset)
                dka = np.zeros((TILE, D), np.float32)
                dva = np.zeros((TILE, Dv), np.float32)
                for j in range(G * n_qt):
                    h = kvh * G + j // n_qt
                    q0 = (qt_begin + j % n_qt) * TILE
                    qt = qz[b, q0:q0 + TILE, h]
                    dot = doz[b, q0:q0 + TILE, h]
                    st = kt @ qt.T                          # S^T (64 keys, 64 q)
                    p = np.exp2(st * (scale * LOG2E)
                                - lse2[b, h, q0:q0 + TILE][None])
                    if _edge(q0, k0, Sq, Skv, causal, window, q_offset):
                        qpos = q0 + q_offset + np.arange(TILE)[None, :]
                        ok = (q0 + np.arange(TILE)[None, :] < Sq) & (kpos < Skv)
                        if causal:
                            ok &= kpos <= qpos
                        if window:
                            ok &= kpos > qpos - window
                        p = np.where(ok, p, 0.0)
                    pb = _bf16(p)
                    dva += pb @ dot                         # warpgroup 0
                    dpt = vt @ dot.T                        # warpgroup 1
                    ds = _bf16(pb * (dpt - delta[b, h, q0:q0 + TILE][None]))
                    dka += ds @ qt
                    dq[b, q0:q0 + TILE, h] += (ds.T @ kt) * scale
                    visits += 1
                n = min(TILE, Skv - k0)
                dk[b, k0:k0 + n, kvh] = _bf16(dka[:n] * scale)
                dv[b, k0:k0 + n, kvh] = _bf16(dva[:n])
    return _bf16(dq[:, :Sq]), dk, dv, visits


# (B, Sq, Skv, H, KV, D, Dv, kwargs): gemma3's heads (G = 2) with windows
# that cut tiles (a small one, one past a q tile), an offset chunk with
# Skv > Sq, ragged Sq and Skv; MLA's (192 | 128) MHA, causal and windowed
SPLIT_CASES = [
    (1, 200, 200, 4, 2, 256, 256, {"causal": True}),
    (1, 300, 300, 4, 2, 256, 256, {"causal": True, "window": 100}),
    (1, 190, 190, 2, 1, 256, 256, {"causal": True, "window": 37}),
    (2, 130, 230, 4, 2, 256, 256, {"causal": True, "q_offset": 100}),
    (1, 100, 100, 4, 2, 256, 256, {"causal": False}),
    (1, 150, 210, 2, 1, 256, 256, {"causal": True, "window": 70,
                                   "q_offset": 60}),
    (2, 37, 37, 2, 2, 192, 128, {"causal": True}),
    (1, 200, 200, 3, 3, 192, 128, {"causal": True}),
    (1, 130, 190, 2, 2, 192, 128, {"causal": True, "window": 90,
                                   "q_offset": 60}),
]


def _inputs(B, Sq, Skv, H, KV, D, Dv, seed):
    rng = np.random.default_rng(seed)
    q, k = (_bf16(rng.normal(size=s)) for s in
            ((B, Sq, H, D), (B, Skv, KV, D)))
    v = _bf16(rng.normal(size=(B, Skv, KV, Dv)))
    do = _bf16(rng.normal(size=(B, Sq, H, Dv)))
    return q, k, v, do


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv,kw", SPLIT_CASES)
def test_split_kernel_emulation_vs_plain_formulas(B, Sq, Skv, H, KV, D, Dv,
                                                  kw):
    """The emulated split kernel within the card's 2e-2 of the largest
    gradient of the plain formulas (float32 on the same bf16 inputs, o and
    lse), and the route the wrapper gives these widths (MLA's to the kv128
    kernel; the split kernel, still built for them, is forced there)."""
    assert fa._bwd_route(torch.bfloat16, D, Dv) == ("wgmma_split" if D == 256
                                                     else "wgmma_kv128")
    q, k, v, do = _inputs(B, Sq, Skv, H, KV, D, Dv, seed=Sq + Skv)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa.flash_attention_plain(tq, tk, tv, **kw).to(torch.bfloat16).float()
    lse = fa.flash_attention_lse_plain(tq, tk, tv, **kw)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    *got, visits = split_kernel_emulation(q, k, v, o.numpy(), lse.numpy(),
                                          do, **kw)
    assert visits > 0
    for name, a, w in zip("QKV", got, want):
        w = w.numpy()
        top = float(np.abs(w).max())
        err = float(np.abs(a - w).max())
        assert err <= RTOL * top, (name, err, top)


def test_split_kernel_schedule_skips_only_invisible_tiles():
    """Every (q tile, key tile) pair the kernel's predicate skips holds no
    visible pair, and every visited one at least one: the same visits as
    counting the mask tile by tile, at gemma3's window past a tile and an
    offset chunk."""
    for Sq, Skv, causal, window, off in ((300, 300, True, 100, 0),
                                         (1024, 1024, True, 1024, 0),
                                         (2048, 2048, True, 1024, 0),
                                         (130, 230, True, None, 100),
                                         (150, 210, True, 70, 60),
                                         (100, 100, False, None, 0)):
        mask = fa._mask(Sq, Skv, causal, window, off, "cpu").numpy()
        for k0 in range(0, Skv, TILE):
            qt_begin, n_qt = _q_tiles(k0, Skv, Sq, causal, window or 0, off)
            visited = set(range(qt_begin, qt_begin + n_qt))
            for qt in range(-(-Sq // TILE)):
                seen = bool(mask[qt * TILE:(qt + 1) * TILE,
                                 k0:k0 + TILE].any())
                assert seen == (qt in visited), (Sq, Skv, window, off, k0, qt)


def test_split_kernel_edge_test_covers_every_masked_tile():
    """A visited tile without the kernel's ``edge`` mark has every pair
    visible (the kernel applies no mask there)."""
    for Sq, Skv, causal, window, off in ((300, 300, True, 100, 0),
                                         (2048, 2048, True, 1024, 0),
                                         (2048, 2048, True, 100, 0),
                                         (130, 230, True, None, 100),
                                         (150, 210, True, 70, 60),
                                         (1000, 1000, True, None, 0)):
        mask = fa._mask(Sq, Skv, causal, window, off, "cpu").numpy()
        for k0 in range(0, Skv, TILE):
            qt_begin, n_qt = _q_tiles(k0, Skv, Sq, causal, window or 0, off)
            for qt in range(qt_begin, qt_begin + n_qt):
                q0 = qt * TILE
                if not _edge(q0, k0, Sq, Skv, causal, window or 0, off):
                    assert mask[q0:q0 + TILE, k0:k0 + TILE].all()
