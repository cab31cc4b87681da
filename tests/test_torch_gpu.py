"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Marked ``gpu``: without a card every test skips, decided inside
the ``cuda`` fixture (never at import or collection, so that every
pytest-xdist worker collects the same tests).

The file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has no JAX (with ``--noconftest``: the shared
conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import matmul as mm
from repro_torch.kernels import preproc, resize
from repro_torch.preprocess import host

pytestmark = pytest.mark.gpu

MM_CASES = [(1, 6912, 256, False, "tanh"), (8, 6912, 256, False, "tanh"),
            (3, 256, 128, False, "none"), (8, 3072, 256, False, "none"),
            (13, 200, 37, True, "tanh"), (2048, 256, 256, True, "tanh")]
LB_CASES = [(1080, 1920, 540, 960, 0.0), (216, 384, 108, 192, 0.0),
            (40, 70, 32, 32, -1.0), (50, 30, 17, 40, 0.5)]


@pytest.fixture
def cuda():
    """The card, decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: kernel-vs-plain checks run "
                    "on the GPU machine (also python3 chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("M,K,N,bias,epi", MM_CASES)
def test_matmul_kernel_vs_plain(cuda, M, K, N, bias, epi):
    g = _gen(0)
    a = torch.randn((M, K), generator=g).to(cuda)
    b = (torch.randn((K, N), generator=g) / K**0.5).to(cuda)
    c = torch.randn((N,), generator=g).to(cuda) if bias else None
    n = mm.matmul.launches
    got = mm.matmul(a, b, bias=c, epilogue=epi)
    assert mm.matmul.launches == n + 1
    torch.testing.assert_close(got, mm.matmul_plain(a, b, bias=c,
                                                    epilogue=epi),
                               atol=1e-4, rtol=1e-5)


def test_matmul_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.ones((4, 8), device=cuda)
    with pytest.raises(ValueError):
        mm.matmul(a.double(), torch.ones((8, 2), device=cuda).double())
    with pytest.raises(ValueError):
        mm.matmul(a, torch.ones((2, 8), device=cuda).T)     # not contiguous


def test_yuv_kernel_exact_on_all_triples(cuda):
    idx = torch.arange(1 << 24, device=cuda, dtype=torch.int32)
    yuv = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255]) \
        .to(torch.uint8).reshape(1, 3, 4096, 4096)
    n = preproc.yuv_to_rgb.launches
    assert torch.equal(preproc.yuv_to_rgb(yuv), preproc.yuv_to_rgb_plain(yuv))
    assert preproc.yuv_to_rgb.launches == n + 1
    odd = yuv[:, :, :7, :13]                   # ragged frame, scalar path
    assert torch.equal(preproc.yuv_to_rgb(odd), preproc.yuv_to_rgb_plain(odd))


@pytest.mark.parametrize("H,W,oh,ow,pad", LB_CASES)
def test_letterbox_kernel_vs_plain(cuda, H, W, oh, ow, pad):
    g = _gen(5)
    planes = torch.randint(0, 256, (6, H, W), generator=g,
                           dtype=torch.uint8).to(cuda)
    ly, lx = (torch.from_numpy(np.array(m)).to(cuda)
              for m in host.embedded_interp_matrices(H, W, oh, ow))
    sb = torch.rand((6, 2), generator=g).to(cuda)
    geom = host.letterbox_geometry(H, W, oh, ow)
    got = preproc.letterbox_normalize(planes, ly, lx, sb, geom, pad_value=pad)
    want = preproc.letterbox_normalize_plain(planes, ly, lx, sb, geom,
                                             pad_value=pad)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape,oh,ow", [((8, 48, 48, 3), 32, 32),
                                         ((3, 50, 70, 3), 21, 33),
                                         ((2, 5, 16, 16, 1), 24, 8)])
def test_resize_kernel_vs_plain(cuda, shape, oh, ow):
    img = (torch.rand(shape, generator=_gen(6)) * 255).to(cuda)
    torch.testing.assert_close(resize.resize_bilinear(img, oh, ow),
                               resize.resize_bilinear_plain(img, oh, ow),
                               atol=1e-4, rtol=0)
