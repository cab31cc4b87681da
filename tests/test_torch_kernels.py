"""The port's kernels (repro_torch.kernels) against the JAX package.

On the CPU every wrapper takes its plain PyTorch version; those are held
to the JAX reference here, on inputs made from a numpy seed. The CUDA
kernels themselves are held to their plain versions by the ``gpu``-marked
tests of ``test_torch_gpu.py``, which skip without a card, and by
chip_smoke.py on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import matmul as jax_matmul
from repro.kernels import ops as jax_ops
from repro.kernels import preproc as jax_preproc
from repro.kernels import ref as jax_ref
from repro.kernels import resize as jax_resize
from repro.preprocess import host as jax_host

from repro_torch.kernels import build, ops
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import preproc, resize
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
    assert mm.split_k(8, 256, 6912, n_sm=132)[0] > 1
    assert mm.split_k(2048, 256, 256, n_sm=132)[0] == 1


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


# ---- letterbox_normalize ----------------------------------------------------

LB_CASES = [(216, 384, 108, 192, 0.0), (40, 70, 32, 32, -1.0),
            (50, 30, 17, 40, 0.5)]


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
        _t(planes), _t(ly), _t(lx), _t(sb), geom, pad_value=pad).numpy()
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
    ly, lx = port_host.embedded_interp_matrices(20, 30, 10, 15)
    with pytest.raises(ValueError):
        preproc.letterbox_normalize(torch.zeros((3, 21, 30), dtype=torch.uint8),
                                    _t(ly), _t(lx), torch.ones((3, 2)),
                                    (10, 15, 0, 0))


# ---- resize_bilinear --------------------------------------------------------

@pytest.mark.parametrize("shape,oh,ow", [((8, 48, 48, 3), 32, 32),
                                         ((3, 50, 70, 3), 21, 33),
                                         ((2, 5, 16, 16, 1), 24, 8)])
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


# ---- dispatch and build -----------------------------------------------------

def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    wrappers = (mm.matmul, preproc.yuv_to_rgb, preproc.letterbox_normalize,
                resize.resize_bilinear)
    before = [w.launches for w in wrappers]
    ops.matmul(torch.ones((2, 3)), torch.ones((3, 4)))
    ops.resize_bilinear(torch.ones((1, 4, 4, 3)), 2, 2)
    preproc.yuv_to_rgb(torch.zeros((1, 3, 4, 4), dtype=torch.uint8))
    assert [w.launches for w in wrappers] == before


def test_nvcc_command_targets_sm90a():
    cmd = build.nvcc_command("nvcc", build.CSRC / "matmul.cu",
                             build.BUILD_DIR / "libmatmul.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == \
        ["matmul.cu", "preproc.cu", "resize.cu"]
