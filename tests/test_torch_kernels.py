"""The port's kernels (repro_torch.kernels) against the JAX package.

On the CPU every wrapper takes its plain PyTorch version; those are held
to the JAX reference here, on inputs made from a numpy seed. The CUDA
kernels themselves are held to their plain versions by the ``gpu``-marked
tests of ``test_torch_gpu.py``, which skip without a card, and by
chip_smoke.py on the card.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import matmul as jax_matmul
from repro.kernels import ops as jax_ops
from repro.kernels import preproc as jax_preproc
from repro.kernels import ref as jax_ref
from repro.kernels import resize as jax_resize
from repro.preprocess import device as jax_device
from repro.preprocess import host as jax_host

from repro_torch.kernels import build, ops
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import preproc, resize
from repro_torch.preprocess import device as port_device
from repro_torch.preprocess import host as port_host


def _mm_inputs(M, K, N, bias, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    c = rng.normal(size=(N,)).astype(np.float32) if bias else None
    return a, b, c


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ---- matmul -----------------------------------------------------------------

MM_CASES = [(8, 6912, 256, False, "tanh"), (3, 256, 128, False, "none"),
            (1, 3072, 256, False, "none"), (13, 200, 37, True, "tanh"),
            (16, 256, 128, True, "none"), (16, 256, 128, False, "tanh")]


@pytest.mark.parametrize("M,K,N,bias,epi", MM_CASES)
def test_matmul_plain_vs_jax_xla(M, K, N, bias, epi):
    a, b, c = _mm_inputs(M, K, N, bias)
    want = np.asarray(jax_ops.matmul(
        jnp.asarray(a), jnp.asarray(b), bias=None if c is None
        else jnp.asarray(c), epilogue=epi, impl="xla"))
    got = ops.matmul(_t(a), _t(b), bias=_t(c), epilogue=epi).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("M,K,N,bias,epi", MM_CASES)
def test_matmul_plain_vs_jax_ref_epilogue(M, K, N, bias, epi):
    """The oracle of the Pallas kernel: ref.matmul, then its epilogue."""
    a, b, c = _mm_inputs(M, K, N, bias, seed=1)
    want = np.asarray(jax_matmul._apply_epilogue(
        jax_ref.matmul(jnp.asarray(a), jnp.asarray(b)),
        None if c is None else jnp.asarray(c), epi))
    got = mm.matmul(_t(a), _t(b), bias=_t(c), epilogue=epi).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_matmul_rejects_bad_arguments():
    a, b, _ = _mm_inputs(4, 8, 16, False)
    with pytest.raises(ValueError):
        mm.matmul(_t(a), _t(b), epilogue="relu")
    with pytest.raises(ValueError):
        mm.matmul(_t(a), _t(b).T)
    with pytest.raises(ValueError):
        mm.matmul(_t(a), _t(b), bias=torch.zeros(3))


@pytest.mark.parametrize("M,K,N", [(8, 6912, 256), (1, 256, 128),
                                   (13, 200, 37), (2048, 256, 256),
                                   (5, 0, 7)])
def test_split_k_covers_k_without_empty_splits(M, K, N):
    splits, chunk = mm.split_k(M, N, K, n_sm=132)
    assert splits >= 1 and chunk % 32 == 0
    assert splits * chunk >= K                       # every K row covered
    assert (splits - 1) * chunk < max(K, 1)          # no split left empty


def test_split_k_fills_the_card_on_face_shapes():
    # the face batches take the skinny route: ceil(N / 16) column slabs
    # times a cluster of up to 8 along K
    for K, N in ((6912, 256), (3072, 256)):
        cluster, _ = mm.skinny_plan(N, K, n_sm=132)
        assert cluster == mm.MAX_CLUSTER and cluster * -(-N // 16) >= 128
    assert mm.split_k(8, 256, 6912, n_sm=132)[0] > 1
    assert mm.split_k(2048, 256, 256, n_sm=132)[0] == 1


def test_matmul_route_sends_face_batches_to_the_skinny_kernel():
    """The face batches (M <= 8) to the skinny kernel, the serving
    cluster's replica batches (9 to 64 rows) to the rows kernel, larger M
    (the autotune battery's 512) to the tile kernel."""
    assert [mm._route(M) for M in (1, 2, 3, 4, 5, 8)] == ["skinny"] * 6
    assert [mm._route(M) for M in (9, 13, 16, 32, 33, 64)] == ["rows"] * 6
    assert [mm._route(M) for M in (65, 512, 2048)] == ["tile"] * 3


@pytest.mark.parametrize("N,K", [(256, 6912), (128, 256), (256, 3072),
                                 (37, 200), (9, 0), (16, 1), (16, 33),
                                 (130, 517), (5000, 100000)])
def test_rows_plan_covers_k_without_empty_splits(N, K):
    """The rows route's formula: a cluster of 1 to ROWS_MAX_CLUSTER ranks
    whose K chunk is a multiple of 4, no rank empty, and a plan check_plan
    takes."""
    cluster, chunk = mm.rows_plan(N, K, n_sm=132)
    assert 1 <= cluster <= mm.ROWS_MAX_CLUSTER
    mm.check_plan(16, K, {"cluster": cluster, "k_chunk": chunk})
    if K == 0:
        assert (cluster, chunk) == (1, 0)
        return
    assert chunk % 4 == 0
    assert cluster * chunk >= K                        # every K row covered
    assert (cluster - 1) * chunk < K                   # no rank left empty


@pytest.mark.parametrize("M,K,plan", [
    (16, 6912, {"splits": 8, "k_chunk": 864}),         # a tile plan's keys
    (16, 6912, {"cluster": 9, "k_chunk": 768}),        # past the cluster
    (16, 6912, {"cluster": 7, "k_chunk": 988}),        # past the rows' 6
    (64, 6912, {"cluster": 6, "k_chunk": 1154}),       # chunk not 4-aligned
    (33, 6912, {"cluster": 6, "k_chunk": 1148}),       # K not covered
    (33, 6912, {"cluster": 6, "k_chunk": 1400}),       # a rank left empty
    (9, 64, {"cluster": 3, "k_chunk": 32}),            # more than K / 32
    (65, 256, {"cluster": 8, "k_chunk": 32}),          # the tile route's M
    (8, 256, {"splits": 1, "k_chunk": 256})])          # the skinny route's M
def test_check_plan_refuses_what_the_route_does_not_take(M, K, plan):
    with pytest.raises(ValueError):
        mm.check_plan(M, K, plan)


@pytest.mark.parametrize("N,K", [(256, 6912), (128, 256), (256, 3072),
                                 (37, 200), (9, 0), (16, 1), (16, 33),
                                 (2000, 3000), (5000, 100000)])
def test_skinny_plan_covers_k_without_empty_splits(N, K):
    cluster, chunk = mm.skinny_plan(N, K, n_sm=132)
    assert 1 <= cluster <= mm.MAX_CLUSTER
    if K == 0:
        assert (cluster, chunk) == (1, 0)
        return
    assert cluster * chunk >= K                        # every K row covered
    assert (cluster - 1) * chunk < K                   # no rank left empty


def _skinny_sum(a, b, bias, epi, n_sm=132):
    """csrc/matmul.cu's skinny kernel in NumPy float32, in its order: each
    K lane's fma chain over every 64th row of its rank's range, a shuffle
    tree over the 8 lanes of a warp, the 8 warps in order, the cluster's
    ranks in order from 0, then bias and tanh once."""
    M, K = a.shape
    N = b.shape[1]
    cluster, chunk = mm.skinny_plan(N, K, n_sm)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    total = np.zeros((M, N), np.float32)
    for rank in range(cluster):
        k0, k1 = rank * chunk, min(K, (rank + 1) * chunk)
        lanes = np.zeros((64, M, N), np.float32)
        for kk in range(k0, k1):
            lane = (kk - k0) % 1024 % 64
            lanes[lane] = (a64[:, kk, None] * b64[None, kk]
                           + lanes[lane]).astype(np.float32)
        warps = []
        for w in range(8):
            x = lanes[8 * w:8 * w + 8]
            x = x[0::2] + x[1::2]                      # shuffle xor 4
            x = x[0::2] + x[1::2]                      # xor 8
            warps.append(x[0] + x[1])                  # xor 16
        part = warps[0]
        for w in warps[1:]:
            part = part + w
        total = total + part
    if bias is not None:
        total = total + bias
    return np.tanh(total) if epi == "tanh" else total


@pytest.mark.parametrize("M,K,N,bias,epi",
                         [(8, 6912, 256, True, "tanh"), (3, 256, 128, False, "none"),
                          (1, 3072, 256, False, "none"), (5, 200, 37, True, "tanh"),
                          (2, 3000, 2000, True, "none")])
def test_skinny_split_sum_emulation_vs_jax(M, K, N, bias, epi):
    a, b, c = _mm_inputs(M, K, N, bias, seed=3)
    got = _skinny_sum(a, b, c, epi)
    xla = np.asarray(jax_ops.matmul(
        jnp.asarray(a), jnp.asarray(b), bias=None if c is None
        else jnp.asarray(c), epilogue=epi, impl="xla"))
    ref = np.asarray(jax_matmul._apply_epilogue(
        jax_ref.matmul(jnp.asarray(a), jnp.asarray(b)),
        None if c is None else jnp.asarray(c), epi))
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _rows_sum(a, b, bias, epi, n_sm=132):
    """csrc/matmul.cu's rows kernel in NumPy float32, in its order: each K
    lane's fma chain over rows 4 lane .. 4 lane + 3 of every 64-row pass of
    its rank's range, a shuffle tree over the 8 lanes of a warp, the row
    group's two warps in order, the cluster's ranks in order from 0, then
    bias and tanh once."""
    M, K = a.shape
    N = b.shape[1]
    cluster, chunk = mm.rows_plan(N, K, n_sm)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    total = np.zeros((M, N), np.float32)
    for rank in range(cluster):
        k0, k1 = rank * chunk, min(K, (rank + 1) * chunk)
        lanes = np.zeros((16, M, N), np.float32)
        for kk in range(k0, k1):
            lane = (kk - k0) % 64 // 4
            lanes[lane] = (a64[:, kk, None] * b64[None, kk]
                           + lanes[lane]).astype(np.float32)
        warps = []
        for w in range(2):
            x = lanes[8 * w:8 * w + 8]
            x = x[0::2] + x[1::2]                      # shuffle xor 4
            x = x[0::2] + x[1::2]                      # xor 8
            warps.append(x[0] + x[1])                  # xor 16
        total = total + (warps[0] + warps[1])
    if bias is not None:
        total = total + bias
    return np.tanh(total) if epi == "tanh" else total


@pytest.mark.parametrize("M", [9, 16, 33, 64])
@pytest.mark.parametrize("K,N,bias,epi", [(6912, 256, False, "tanh"),
                                          (256, 128, False, "none"),
                                          (200, 37, True, "tanh")])
def test_rows_split_sum_emulation_vs_jax(M, K, N, bias, epi):
    """The rows kernel's summation order (the cluster's fixed-order sum)
    within 1e-5 of the reference's XLA matmul and its ref, at the cluster's
    row counts and both of its products."""
    assert mm._route(M) == "rows"
    a, b, c = _mm_inputs(M, K, N, bias, seed=4)
    got = _rows_sum(a, b, c, epi)
    xla = np.asarray(jax_ops.matmul(
        jnp.asarray(a), jnp.asarray(b), bias=None if c is None
        else jnp.asarray(c), epilogue=epi, impl="xla"))
    ref = np.asarray(jax_matmul._apply_epilogue(
        jax_ref.matmul(jnp.asarray(a), jnp.asarray(b)),
        None if c is None else jnp.asarray(c), epi))
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# ---- yuv_to_rgb -------------------------------------------------------------

def _all_yuv_triples(n_frames=16):
    """Every (y, u, v) triple once, as n_frames planar frames."""
    v = np.arange(256, dtype=np.uint8)
    y, u, w = (p.reshape(n_frames, -1) for p in
               np.meshgrid(v, v, v, indexing="ij"))
    side = int(np.sqrt(y.shape[1]))
    return np.stack([y, u, w], axis=1).reshape(n_frames, 3, side, side)


def test_yuv_plain_equals_host_on_all_256_cubed_triples():
    yuv = _all_yuv_triples()
    bad = 0
    for f in range(len(yuv)):          # one frame at a time keeps memory low
        want = jax_host.yuv_to_rgb(yuv[f:f + 1])
        got = preproc.yuv_to_rgb(torch.from_numpy(yuv[f:f + 1])).numpy()
        bad += int((got != want).sum())
    assert bad == 0


def test_yuv_rounding_contract_counts():
    """Why the decode is an FMA chain: over all 256^3 triples the
    separately rounded float32 expression differs from the host decode
    in 4,387 channel values, and the reference's XLA device path in 35;
    the chain (the plain version, above) in none."""
    from repro.preprocess import device as jax_device
    yuv = _all_yuv_triples()
    naive = xla = 0
    for f in range(len(yuv)):
        want = jax_host.yuv_to_rgb(yuv[f:f + 1])
        x = torch.from_numpy(yuv[f:f + 1]).float()
        y, u, v = x[:, 0], x[:, 1] - 128.0, x[:, 2] - 128.0
        rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v,
                           y + 1.772 * u], dim=-1)
        got = torch.round(rgb).clamp(0, 255).to(torch.uint8).numpy()
        naive += int((got != want).sum())
        xla += int((np.asarray(jax_device._yuv_to_rgb_xla(
            jnp.asarray(yuv[f:f + 1]))) != want).sum())
    assert (naive, xla) == (4387, 35)


def test_yuv_plain_vs_pallas_interpret():
    rng = np.random.default_rng(2)
    yuv = rng.integers(0, 256, (2, 3, 24, 40), dtype=np.uint8)
    want = np.asarray(jax_preproc.yuv_to_rgb(jnp.asarray(yuv),
                                             interpret=True))
    got = preproc.yuv_to_rgb(torch.from_numpy(yuv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_yuv_rejects_wrong_layout():
    with pytest.raises(ValueError):
        preproc.yuv_to_rgb(torch.zeros((1, 4, 8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        preproc.yuv_to_rgb(torch.zeros((1, 3, 8, 8), dtype=torch.float32))


# A NumPy model of the "vec16" route of csrc/preproc.cu: each thread's
# pixel-group index, its three uint4 loads (little-endian words), the
# decode of each byte (the lift to 2^23 + byte, the fma chain, the clamp
# and the rounding by adding 1.5 * 2^23), the __byte_perm packing with the
# selectors the source defines, and the warp's stores through shared memory.

def _selectors():
    """Every ``constexpr unsigned k...Sel`` of csrc/preproc.cu."""
    src = (build.CSRC / "preproc.cu").read_text()
    return {name: int(val, 16) for name, val in re.findall(
        r"constexpr unsigned (k\w+Sel\d?) = (0x[0-9a-fA-F]+)u;", src)}


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) with selector nibbles 0-7: byte k of
    the result is byte (sel >> 4k) & 7 of the 8 bytes x (0-3), y (4-7)."""
    both = (np.asarray(x).astype(np.uint64)
            | (np.asarray(y).astype(np.uint64) << np.uint64(32)))
    out = np.zeros(both.shape, np.uint32)
    for k in range(4):
        b = (sel >> (4 * k)) & 0x7
        out |= (((both >> np.uint64(8 * b)) & np.uint64(0xff))
                .astype(np.uint32) << np.uint32(8 * k))
    return out


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _fma(a, x, y):
    """float32 fma(a, x, y): exact in float64 for these operands, one
    rounding."""
    return (np.float64(a) * x.astype(np.float64) + y.astype(np.float64)) \
        .astype(np.float32)


def _yuv_pixel(Y, U, V, k, sel):
    """yuv_pixel of csrc/preproc.cu on word arrays: the pixel in byte k."""
    def lift(w):
        return _f32(_byte_perm(w, 0x4B000000, sel["kLiftSel"] | k))
    y = lift(Y) - np.float32(8388608.0)
    u = lift(U) - np.float32(8388736.0)
    v = lift(V) - np.float32(8388736.0)
    c = [_fma(np.float32(1.402), v, y),
         _fma(np.float32(-0.714136), v, _fma(np.float32(-0.344136), u, y)),
         _fma(np.float32(1.772), u, y)]
    r, g, b = (np.minimum(np.maximum(x, np.float32(0)), np.float32(255))
               + np.float32(12582912.0) for x in c)
    return _byte_perm(_byte_perm(r.view(np.uint32), g.view(np.uint32),
                                 sel["kRgSel"]),
                      b.view(np.uint32), sel["kRgbSel"])


def _words(byte_rows):
    """(T, 16) uint8 -> (T, 4) uint32, as a uint4 load reads them."""
    return np.ascontiguousarray(byte_rows).view("<u4")


def _yuv_vec16_emulation(yuv):
    B, _, H, W = yuv.shape
    hw = H * W
    n_groups = B * hw // 16
    flat = yuv.reshape(-1)
    t = np.arange(-(-n_groups // 32) * 32)      # whole warps
    g0 = np.minimum(t, n_groups - 1) * 16       # lanes past the end: the last
    f = g0 // hw
    base = f * 3 * hw + (g0 - f * hw)
    planes = [_words(flat[(base + k * hw)[:, None] + np.arange(16)])
              for k in range(3)]
    sel = _selectors()
    words = []
    for q in range(4):
        px = [_yuv_pixel(*(w[:, q] for w in planes), k, sel) for k in range(4)]
        words += [_byte_perm(px[m], px[m + 1], sel[f"kPackSel{m}"])
                  for m in range(3)]
    # lane l's words 4k .. 4k + 3 are stage[3l + k]; the warp stores
    # stage[32k + l] as uint4 number 3 * first + 32k + l, if below 3 * valid
    lane_words = np.stack(words, axis=1).reshape(-1, 32, 3, 4)
    out = np.zeros((3 * n_groups, 4), np.uint32)
    for wi, stage in enumerate(lane_words):
        stage = stage.reshape(96, 4)
        first = 32 * wi
        valid = 3 * min(n_groups - first, 32)
        for k in range(3):
            idx = 32 * k + np.arange(32)
            keep = idx < valid
            out[3 * first + idx[keep]] = stage[idx[keep]]
    return out.astype("<u4").view(np.uint8).reshape(B, H, W, 3)


def test_yuv_selectors_pack_rgb_bytes_and_never_read_byte_3():
    """Word m of a 4-pixel group is the bytes 4m .. 4m + 3 of r0 g0 b0 r1
    g1 b1 r2 g2 b2 r3 g3 b3; the packing never reads a pixel word's byte 3,
    which yuv_pixel leaves undefined."""
    sel = _selectors()
    px = np.array([0x00a0b0c0 + 0x00010101 * k for k in range(4)], np.uint32)
    dirty = px | np.uint32(0xee000000)
    got = np.array([_byte_perm(dirty[m], dirty[m + 1], sel[f"kPackSel{m}"])
                    for m in range(3)], "<u4").view(np.uint8)
    want = np.stack([px & 0xff, (px >> 8) & 0xff, (px >> 16) & 0xff],
                    axis=1).reshape(-1)
    np.testing.assert_array_equal(got, want)
    for m in range(3):
        nibbles = [(sel[f"kPackSel{m}"] >> (4 * k)) & 0xf for k in range(4)]
        assert not {3, 7} & set(nibbles)


def test_yuv_pixel_emulation_equals_plain_on_all_256_cubed_triples():
    """The lift, fma chain, clamp and magic-number rounding of yuv_pixel,
    emulated in float32, on every (y, u, v) triple."""
    sel = _selectors()
    yuv = _all_yuv_triples(n_frames=1).reshape(3, -1)
    words = [plane.astype(np.uint32) for plane in yuv]   # the byte in byte 0
    px = _yuv_pixel(*words, 0, sel)
    got = np.stack([px & 0xff, (px >> 8) & 0xff, (px >> 16) & 0xff], axis=1)
    want = preproc.yuv_to_rgb_plain(
        torch.from_numpy(yuv.reshape(1, 3, 4096, 4096))).numpy().reshape(-1, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,H,W", [(1, 4, 16), (2, 6, 8), (3, 16, 16),
                                   (1, 1080, 1920)])
def test_yuv_vec16_emulation_equals_plain(B, H, W):
    yuv = np.random.default_rng(H * W + B).integers(
        0, 256, (B, 3, H, W), dtype=np.uint8)
    assert preproc._yuv_route(H, W, 16) == "vec16"
    want = preproc.yuv_to_rgb_plain(torch.from_numpy(yuv)).numpy()
    np.testing.assert_array_equal(_yuv_vec16_emulation(yuv), want)


@pytest.mark.parametrize("H,W,align,route", [
    (1080, 1920, 16, "vec16"), (4096, 4096, 256, "vec16"),
    (1080, 1920, 4, "vec4"), (1080, 1920, 8, "vec4"), (1080, 1920, 2, "scalar"),
    (6, 10, 16, "vec4"), (7, 13, 16, "scalar"), (2, 2, 16, "vec4"),
    (1, 1, 16, "scalar")])
def test_yuv_route(H, W, align, route):
    assert preproc._yuv_route(H, W, align) == route


# ---- letterbox_normalize ----------------------------------------------------

LB_CASES = [(216, 384, 108, 192, 0.0), (40, 70, 32, 32, -1.0),
            (50, 30, 17, 40, 0.5)]
RESIZE_CASES = [((8, 48, 48, 3), 32, 32), ((3, 50, 70, 3), 21, 33),
                ((2, 5, 16, 16, 1), 24, 8)]


def _lb_taps(H, W, oh, ow):
    """The letterbox's tap tables on the CPU, as the device path uploads
    them."""
    (iy, wy), (ix, wx) = port_host.embedded_interp_taps(H, W, oh, ow)
    return (resize.upload_taps(iy, wy, H, "cpu"),
            resize.upload_taps(ix, wx, W, "cpu"))


@pytest.mark.parametrize("H,W,oh,ow,pad", LB_CASES)
def test_letterbox_plain_vs_pallas_interpret(H, W, oh, ow, pad):
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 256, (6, H, W), dtype=np.uint8)
    sb = np.stack([rng.uniform(0.5, 1.5, 6), rng.normal(size=6)],
                  axis=1).astype(np.float32)
    ly, lx = port_host.embedded_interp_matrices(H, W, oh, ow)
    geom = port_host.letterbox_geometry(H, W, oh, ow)
    want = np.asarray(jax_preproc.letterbox_normalize(
        jnp.asarray(planes), jnp.asarray(ly), jnp.asarray(lx),
        jnp.asarray(sb), geom, pad_value=pad, interpret=True))
    got = preproc.letterbox_normalize(
        _t(planes), *_lb_taps(H, W, oh, ow), _t(sb), geom,
        pad_value=pad).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_letterbox_operators_equal_reference():
    for geom in [(216, 384, 108, 192), (40, 70, 32, 32), (1080, 1920, 540, 960)]:
        assert port_host.letterbox_geometry(*geom) == \
            jax_host.letterbox_geometry(*geom)
        for p, j in zip(port_host.embedded_interp_matrices(*geom),
                        jax_host.embedded_interp_matrices(*geom)):
            np.testing.assert_array_equal(p, j)
        np.testing.assert_array_equal(port_host._content_mask(*geom),
                                      jax_host._content_mask(*geom))


def test_letterbox_rejects_mismatched_operators():
    taps_y, taps_x = _lb_taps(20, 30, 10, 15)
    with pytest.raises(ValueError):
        preproc.letterbox_normalize(torch.zeros((3, 21, 30), dtype=torch.uint8),
                                    taps_y, taps_x, torch.ones((3, 2)),
                                    (10, 15, 0, 0))


# ---- 2-tap tables -----------------------------------------------------------

# (out_n, in_n): downscales, upscales whose edge rows merge two taps into one
# (16 -> 24, 3 -> 7, and both axes of 20x30 -> 61x67), identity, and the
# axes of the 1080p letterboxes
INTERP_AXES = [(32, 48), (108, 216), (21, 50), (24, 16), (7, 3), (45, 20),
               (67, 30), (48, 48), (540, 1080), (960, 1920), (288, 1080),
               (512, 1920)]
# (H, W, out_h, out_w): with pad rows or columns, and an upscale
EMBEDDED = [(20, 30, 61, 67), (1080, 1920, 540, 960), (1080, 1920, 512, 512),
            (216, 384, 108, 192), (40, 70, 32, 32), (50, 30, 17, 40)]


@pytest.mark.parametrize("out_n,in_n", INTERP_AXES)
def test_interp_taps_expand_to_the_operator_bit_for_bit(out_n, in_n):
    m = resize._interp_matrix(out_n, in_n)
    idx, w = resize.interp_taps(m)
    assert (idx.dtype, w.dtype, idx.shape, w.shape) == \
        (np.int32, np.float32, (out_n, 2), (out_n, 2))
    assert (idx[:, 0] <= idx[:, 1]).all()
    dense = resize.expand_taps(resize.upload_taps(idx, w, in_n, "cpu"))
    np.testing.assert_array_equal(dense.numpy(), m)
    assert dense.numpy().tobytes() == m.tobytes()


@pytest.mark.parametrize("H,W,oh,ow", EMBEDDED)
def test_embedded_interp_taps_expand_to_the_operators_bit_for_bit(H, W, oh,
                                                                  ow):
    for taps, m in zip(_lb_taps(H, W, oh, ow),
                       port_host.embedded_interp_matrices(H, W, oh, ow)):
        assert resize.expand_taps(taps).numpy().tobytes() == m.tobytes()


def test_interp_taps_pad_short_rows_and_reject_three_nonzeros():
    m = np.zeros((3, 5), np.float32)
    m[1, 4] = 1.0                          # one non-zero: padded at its index
    m[2, [1, 3]] = (0.25, 0.75)
    idx, w = resize.interp_taps(m)
    np.testing.assert_array_equal(idx, [[0, 0], [4, 4], [1, 3]])
    np.testing.assert_array_equal(w, [[0, 0], [1, 0], [0.25, 0.75]])
    m[2, 0] = 0.5
    with pytest.raises(ValueError):
        resize.interp_taps(m)


def _fma(a, b, c):
    """fmaf in float64 (the product of a float32 weight and a uint8 value
    is exact there), rounded once to float32."""
    return (np.float64(a) * b + c).astype(np.float32)


def _emulate_taps(x, iy, wy, ix, wx):
    """The kernels' arithmetic in NumPy on planes (P, H, W): gather the two
    input rows, row pass at each output column's two input columns, then
    the column pass; every product of a pass rounded to float32."""
    r0, r1 = x[:, iy[:, 0]], x[:, iy[:, 1]]                   # (P, oh, W)
    wy0, wy1 = wy[None, :, 0, None], wy[None, :, 1, None]

    def row_pass(cols):
        return _fma(wy1, r1[:, :, cols], wy0 * r0[:, :, cols])
    t0, t1 = row_pass(ix[:, 0]), row_pass(ix[:, 1])
    return _fma(wx[:, 1], t1, wx[:, 0] * t0)


@pytest.mark.parametrize("H,W,oh,ow,pad", LB_CASES + [(20, 30, 61, 67, 0.5)])
def test_letterbox_tap_arithmetic_equals_plain(H, W, oh, ow, pad):
    rng = np.random.default_rng(7)
    planes = rng.integers(0, 256, (6, H, W), dtype=np.uint8)
    sb = np.stack([rng.uniform(0.5, 1.5, 6), rng.normal(size=6)],
                  axis=1).astype(np.float32)
    (iy, wy), (ix, wx) = port_host.embedded_interp_taps(H, W, oh, ow)
    ch, cw, top, left = geom = port_host.letterbox_geometry(H, W, oh, ow)
    v = _emulate_taps(planes.astype(np.float32), iy, wy, ix, wx)
    got = v * sb[:, 0, None, None] + sb[:, 1, None, None]
    inside = np.zeros((oh, ow), bool)
    inside[top:top + ch, left:left + cw] = True
    got = np.where(inside, got, np.float32(pad))
    want = preproc.letterbox_normalize_plain(
        _t(planes), *_lb_taps(H, W, oh, ow), _t(sb), geom,
        pad_value=pad).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,oh,ow", RESIZE_CASES)
def test_resize_tap_arithmetic_equals_plain(shape, oh, ow):
    img = np.random.default_rng(8).uniform(0, 255, shape).astype(np.float32)
    *lead, H, W, C = shape
    (iy, wy), (ix, wx) = (resize.interp_taps(resize._interp_matrix(o, n))
                          for o, n in ((oh, H), (ow, W)))
    planes = np.moveaxis(img.reshape(-1, H, W, C), -1, 1).reshape(-1, H, W)
    got = _emulate_taps(planes, iy, wy, ix, wx).reshape(-1, C, oh, ow)
    got = np.moveaxis(got, 1, -1).reshape(*lead, oh, ow, C)
    want = resize.resize_bilinear_plain(_t(img), oh, ow).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---- resize_bilinear --------------------------------------------------------

@pytest.mark.parametrize("shape,oh,ow", RESIZE_CASES)
def test_resize_plain_vs_pallas_interpret(shape, oh, ow):
    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(img), oh, ow,
                                                 interpret=True))
    got = ops.resize_bilinear(_t(img), oh, ow).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resize_interp_matrix_equals_reference():
    for out_n, in_n in [(32, 48), (108, 216), (7, 3), (48, 48)]:
        np.testing.assert_array_equal(resize._interp_matrix(out_n, in_n),
                                      jax_resize._interp_matrix(out_n, in_n))


# ---- iou_matrix and device NMS --------------------------------------------

def _box_battery(n, seed):
    """Boxes with ties (corners on a coarse grid, so boxes repeat exactly),
    zero-area boxes (every 5th), and scores on 8 levels."""
    rng = np.random.default_rng(seed)
    y0 = rng.integers(0, 12, n) * 2.0
    x0 = rng.integers(0, 12, n) * 2.0
    h = rng.choice([2.0, 4.0, 6.0], n)
    w = rng.choice([2.0, 4.0, 6.0], n)
    boxes = np.stack([y0, x0, y0 + h, x0 + w], axis=1).astype(np.float32)
    boxes[::5, 3] = boxes[::5, 1]
    scores = (rng.integers(0, 8, n) / 8.0).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("n", [1, 7, 64, 200])
def test_iou_plain_bit_exact_vs_host_and_pallas_interpret(n):
    boxes, _ = _box_battery(n, seed=n)
    got = preproc.iou_matrix(torch.from_numpy(boxes.T.copy())).numpy()
    host = jax_host.iou_matrix(boxes)
    pallas = np.asarray(jax_preproc.iou_matrix(jnp.asarray(boxes.T),
                                               interpret=True))
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(port_device.iou_matrix(
        torch.from_numpy(boxes)).numpy(), host)


NMS_CASES = [(0, 0.5, 0.0, None), (1, 0.5, 0.0, None), (33, 0.5, 0.0, None),
             (64, 0.3, 0.0, None), (100, 0.5, 0.4, None), (100, 0.5, 0.0, 5),
             (257, 0.1, 0.25, 12)]


@pytest.mark.parametrize("n,iou_t,score_t,max_out", NMS_CASES)
def test_device_nms_equals_host_and_reference(n, iou_t, score_t, max_out):
    boxes, scores = _box_battery(n, seed=100 + n)
    kw = dict(iou_thresh=iou_t, score_thresh=score_t, max_out=max_out)
    got = port_device.nms(boxes, scores, device="cpu", **kw)
    assert got == jax_host.nms(boxes, scores, **kw)
    assert got == port_host.nms(boxes, scores, **kw)
    assert got == jax_device.nms(boxes, scores, **kw)


def test_iou_rejects_wrong_layout():
    with pytest.raises(ValueError):
        preproc.iou_matrix(torch.zeros((5, 4)))


IOU_BATTERIES = [(1, 0), (7, 1), (64, 2), (200, 3), (1000, 4)]


def _signed_zero_boxes(n, seed):
    """The box battery (ties, zero-area boxes) moved to corners of both
    signs, with a fifth of the coordinates set to -0 or +0."""
    boxes, _ = _box_battery(n, seed)
    rng = np.random.default_rng(seed)
    boxes -= 8.0
    zero = rng.random(boxes.shape) < 0.2
    boxes[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    return boxes


@pytest.mark.parametrize("n,seed", IOU_BATTERIES)
def test_iou_plain_is_symmetric(n, seed):
    """What the symmetric kernel relies on: iou[i][j] == iou[j][i] as
    values, on ties, zero-area boxes and coordinates of -0 and +0."""
    boxes = _signed_zero_boxes(n, seed)
    got = preproc.iou_matrix_plain(torch.from_numpy(boxes.T.copy())).numpy()
    assert not np.isnan(got).any()
    assert np.array_equal(got, got.T)
    np.testing.assert_array_equal(got, jax_host.iou_matrix(boxes))


@pytest.mark.parametrize("n,seed", IOU_BATTERIES)
def test_iou_pair_zero_guard_equals_plain(n, seed):
    """csrc/iou.cu's iou_pair in float32, one IEEE operation a step: a pair
    with inter == 0 returns inter instead of dividing, and that is the
    plain version's quotient (as a value) on every pair of the battery."""
    y0, x0, y1, x1 = _signed_zero_boxes(n, seed).T.astype(np.float32)
    area = (y1 - y0) * (x1 - x0)
    zero = np.float32(0.0)
    ih = np.maximum(zero, np.minimum(y1[:, None], y1[None])
                    - np.maximum(y0[:, None], y0[None]))
    iw = np.maximum(zero, np.minimum(x1[:, None], x1[None])
                    - np.maximum(x0[:, None], x0[None]))
    inter = ih * iw
    uni = (area[:, None] + area[None]) - inter
    quotient = inter / np.maximum(uni, np.float32(1e-12))
    got = np.where(inter == 0, inter, quotient)
    assert got.dtype == np.float32 and (inter == 0).any()
    boxes_t = torch.from_numpy(np.stack([y0, x0, y1, x1]))
    assert np.array_equal(got, preproc.iou_matrix_plain(boxes_t).numpy())


# A NumPy model of csrc/iou.cu's indexing: the block -> (ti, tj) triangle
# map over 32 x 32 tiles, each thread's 4 outputs of one row (pairs off the
# edge not computed), its direct stores (float4 or scalar) and the mirror
# through the padded shared tile.

IOU_TILE = 32
IOU_NS = [1, 31, 32, 33, 64, 65, 1000, 1024, 4096]


def _iou_tile_of(b):
    """tile_of in csrc/iou.cu: block b -> (ti, tj), ti <= tj."""
    f32 = np.float32
    c = int((np.sqrt(f32(8) * f32(b) + f32(1)) - f32(1)) * f32(0.5))
    while c * (c + 1) // 2 > b:
        c -= 1
    while (c + 1) * (c + 2) // 2 <= b:
        c += 1
    return b - c * (c + 1) // 2, c


def _iou_lanes():
    """(cq, lr) of each of the 256 threads: columns 4 cq .. 4 cq + 3 of
    row lr."""
    t = np.arange(IOU_TILE * IOU_TILE // 4)
    return t % 8, t // 8


def _iou_stores(n, count, vec):
    """Every store of the kernel for n boxes, float4 (``vec``) or scalar:
    checks that each stored value is the IoU of the cell's own pair (either
    order), and counts each cell's stores in ``count``."""
    tile = IOU_TILE
    tiles = -(-n // tile)
    cq, rq = _iou_lanes()
    c = np.arange(4)[None, :]
    lr = rq[:, None] + 0 * c                              # (thread, c)
    lc = 4 * cq[:, None] + c
    for blk in range(tiles * (tiles + 1) // 2):
        ti, tj = _iou_tile_of(blk)
        assert 0 <= ti <= tj < tiles
        i0, j0 = ti * tile, tj * tile
        live = (j0 + 4 * cq[:, None] < n) & (i0 + lr < n)
        pair = (np.where(live, i0 + lr, -1), np.where(live, j0 + lc, -1))
        stores = [(i0 + lr, j0 + lc, pair)]
        if ti != tj:
            mirror = np.full((tile, tile + 1, 2), -2)
            mirror[lr, lc] = np.stack(pair, axis=-1)
            m = mirror[lc, lr]                  # m[k] = mirror[4cq+k][lr]
            stores.append((j0 + lr, i0 + lc, (m[..., 0], m[..., 1])))
        for row, col, (a, b) in stores:
            quad = col - (col % 4)
            if vec:                             # a quad is all in or all out
                inside = (row < n) & (quad < n)
                assert (col[inside] < n).all()
            else:
                inside = (row < n) & (col < n)
            a, b, row, col = a[inside], b[inside], row[inside], col[inside]
            assert ((a == row) & (b == col) | (a == col) & (b == row)).all()
            np.add.at(count, (row, col), 1)


# float4 stores need n % 4 == 0; scalar ones (an unaligned output) take any n
@pytest.mark.parametrize("n,vec", [(n, False) for n in IOU_NS]
                         + [(n, True) for n in IOU_NS if n % 4 == 0])
def test_iou_tiles_store_every_cell_once(n, vec):
    count = np.zeros((n, n), np.uint8)
    _iou_stores(n, count, vec)
    assert (count == 1).all()


@pytest.mark.parametrize("tiles", [1, 2, 3, 33, 128, 1025])
def test_iou_triangle_map_is_a_bijection(tiles):
    got = [_iou_tile_of(b) for b in range(tiles * (tiles + 1) // 2)]
    assert got == [(ti, tj) for tj in range(tiles) for ti in range(tj + 1)]


def test_iou_shared_tile_passes_are_free_of_bank_conflicts():
    """Each warp's 32 lanes hit 32 distinct banks in every shared-memory
    access of the mirror: the write of v[c] and the read of m[k]."""
    cq, row = _iou_lanes()
    stride = IOU_TILE + 1
    for warp in range(len(cq) // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        for k in range(4):
            write = row[lanes] * stride + 4 * cq[lanes] + k
            read = (4 * cq[lanes] + k) * stride + row[lanes]
            assert len(set(write % 32)) == 32
            assert len(set(read % 32)) == 32


# ---- dispatch and build -----------------------------------------------------

def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    wrappers = (mm.matmul, preproc.yuv_to_rgb, preproc.letterbox_normalize,
                resize.resize_bilinear)
    before = [w.launches for w in wrappers]
    ops.matmul(torch.ones((2, 3)), torch.ones((3, 4)))
    ops.resize_bilinear(torch.ones((1, 4, 4, 3)), 2, 2)
    preproc.letterbox_normalize(torch.zeros((3, 8, 12), dtype=torch.uint8),
                                *_lb_taps(8, 12, 4, 4), torch.ones((3, 2)),
                                port_host.letterbox_geometry(8, 12, 4, 4))
    preproc.yuv_to_rgb(torch.zeros((1, 3, 4, 4), dtype=torch.uint8))
    assert [w.launches for w in wrappers] == before


def test_nvcc_command_targets_sm90a():
    cmd = build.nvcc_command("nvcc", build.CSRC / "matmul.cu",
                             build.BUILD_DIR / "libmatmul.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == \
        ["decode_attention.cu", "flash_attention.cu",
         "flash_attention_bwd.cu", "iou.cu",
         "linear_scan.cu", "linear_scan_bwd.cu", "matmul.cu", "preproc.cu",
         "resize.cu"]
