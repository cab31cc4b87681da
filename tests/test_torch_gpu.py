"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Marked ``gpu``: without a card every test skips, decided inside
the ``cuda`` fixture (never at import or collection, so that every
pytest-xdist worker collects the same tests).

The file imports neither JAX nor the JAX package, so it also runs on a
GPU machine that has no JAX (with ``--noconftest``: the shared
conftest imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import preproc, resize
from repro_torch.preprocess import device as pp_device
from repro_torch.preprocess import host

pytestmark = pytest.mark.gpu

MM_CASES = [(1, 6912, 256, False, "tanh"), (8, 6912, 256, False, "tanh"),
            (3, 256, 128, False, "none"), (8, 3072, 256, False, "none"),
            (13, 200, 37, True, "tanh"), (2048, 256, 256, True, "tanh")]
# the last an upscale to a ragged width (scalar stores, pad rows)
LB_CASES = [(1080, 1920, 540, 960, 0.0), (216, 384, 108, 192, 0.0),
            (40, 70, 32, 32, -1.0), (50, 30, 17, 40, 0.5),
            (20, 30, 61, 67, 0.5)]


@pytest.fixture
def cuda():
    """The card, decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: kernel-vs-plain checks run "
                    "on the GPU machine (also python3 chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def autotune_cache(tmp_path, monkeypatch):
    """Launch plans from the committed seed, shapes outside it tuned into
    this test's own overlay (never the user's cache)."""
    cache = autotune.AutotuneCache(path=tmp_path / "autotune.json")
    monkeypatch.setattr(autotune, "_CACHE", cache)
    return cache


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


# (M, K, N, bias, epilogue, route): the skinny route at every face batch
# size with ragged N and K, the tile route above 8 rows
MM_ROUTE_CASES = [(M, 6912, 256, False, "tanh", "skinny") for M in (1, 2, 4, 8)]
MM_ROUTE_CASES += [(3, 3072, 256, False, "none", "skinny"),
                   (5, 200, 37, True, "tanh", "skinny"),
                   (7, 33, 5, True, "none", "skinny"),
                   (2, 3000, 2000, True, "tanh", "skinny"),
                   (9, 200, 37, True, "tanh", "tile"),
                   (64, 517, 130, False, "none", "tile")]


@pytest.mark.parametrize("M,K,N,bias,epi,route", MM_ROUTE_CASES)
def test_matmul_routes_vs_plain_and_bit_equal_on_repeat(cuda, M, K, N, bias,
                                                        epi, route):
    g = _gen(1)
    a = torch.randn((M, K), generator=g).to(cuda)
    b = (torch.randn((K, N), generator=g) / K**0.5).to(cuda)
    c = torch.randn((N,), generator=g).to(cuda) if bias else None
    assert mm._route(M) == route
    n = mm.matmul.launches_by_route[route]
    got = mm.matmul(a, b, bias=c, epilogue=epi)
    again = mm.matmul(a, b, bias=c, epilogue=epi)
    assert mm.matmul.launches_by_route[route] == n + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, mm.matmul_plain(a, b, bias=c,
                                                    epilogue=epi),
                               atol=1e-4, rtol=1e-5)


def test_matmul_skinny_route_replays_in_a_cuda_graph_bit_exactly(cuda):
    g = _gen(2)
    a = torch.randn((8, 6912), generator=g).to(cuda)
    b = (torch.randn((6912, 256), generator=g) / 6912**0.5).to(cuda)
    c = torch.randn((256,), generator=g).to(cuda)
    eager = mm.matmul(a, b, bias=c, epilogue="tanh")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mm.matmul(a, b, bias=c, epilogue="tanh")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mm.matmul(a, b, bias=c, epilogue="tanh")
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_matmul_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.ones((4, 8), device=cuda)
    with pytest.raises(ValueError):
        mm.matmul(a.double(), torch.ones((8, 2), device=cuda).double())
    with pytest.raises(ValueError):
        mm.matmul(a, torch.ones((2, 8), device=cuda).T)     # not contiguous


def _yuv_launches():
    return preproc.yuv_to_rgb.launches, dict(preproc.yuv_to_rgb.launches_by_route)


def _check_yuv(yuv, route):
    """One YUV kernel call on ``route``, equal to the plain version."""
    n, by_route = _yuv_launches()
    assert torch.equal(preproc.yuv_to_rgb(yuv), preproc.yuv_to_rgb_plain(yuv))
    by_route[route] += 1
    assert _yuv_launches() == (n + 1, by_route)


def test_yuv_kernel_exact_on_all_triples(cuda):
    idx = torch.arange(1 << 24, device=cuda, dtype=torch.int32)
    yuv = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255]) \
        .to(torch.uint8).reshape(1, 3, 4096, 4096)
    _check_yuv(yuv, "vec16")
    odd = yuv[:, :, :7, :13]                   # ragged frame, scalar path
    _check_yuv(odd, "scalar")


# (shape, byte offset of the input in its buffer, route)
YUV_CASES = [((2, 3, 1080, 1920), 0, "vec16"), ((3, 3, 6, 10), 0, "vec4"),
             ((1, 3, 7, 13), 0, "scalar"), ((1, 3, 1080, 1920), 4, "vec4"),
             ((2, 3, 8, 16), 1, "scalar")]


@pytest.mark.parametrize("shape,offset,route", YUV_CASES)
def test_yuv_kernel_routes_exact(cuda, shape, offset, route):
    n = int(np.prod(shape))
    buf = torch.randint(0, 256, (n + offset,), generator=_gen(n),
                        dtype=torch.uint8).to(cuda)
    _check_yuv(buf[offset:].view(shape), route)


def test_yuv_kernel_takes_a_strided_1080p_frame(cuda):
    """Every other plane of a 6-plane buffer: the wrapper's copy reaches
    the vec16 route."""
    frames = torch.randint(0, 256, (1, 6, 1080, 1920), generator=_gen(6),
                           dtype=torch.uint8).to(cuda)
    yuv = frames[:, 1::2]
    assert not yuv.is_contiguous()
    _check_yuv(yuv, "vec16")


@pytest.mark.parametrize("H,W,oh,ow,pad", LB_CASES)
def test_letterbox_kernel_vs_plain(cuda, H, W, oh, ow, pad):
    g = _gen(5)
    planes = torch.randint(0, 256, (6, H, W), generator=g,
                           dtype=torch.uint8).to(cuda)
    taps = pp_device._letterbox_operators(H, W, oh, ow, str(cuda))
    sb = torch.rand((6, 2), generator=g).to(cuda)
    geom = host.letterbox_geometry(H, W, oh, ow)
    n = preproc.letterbox_normalize.launches
    got = preproc.letterbox_normalize(planes, *taps, sb, geom, pad_value=pad)
    assert preproc.letterbox_normalize.launches == n + 1
    want = preproc.letterbox_normalize_plain(planes, *taps, sb, geom,
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


def test_tap_kernels_replay_in_a_cuda_graph_bit_exactly(cuda):
    """Letterbox and resize captured in one CUDA graph (tap tables uploaded
    at the warm-up, outside the capture) give the eager calls' bits."""
    g = _gen(7)
    planes = torch.randint(0, 256, (3, 1080, 1920), generator=g,
                           dtype=torch.uint8).to(cuda)
    taps = pp_device._letterbox_operators(1080, 1920, 540, 960, str(cuda))
    sb = torch.rand((3, 2), generator=g).to(cuda)
    geom = host.letterbox_geometry(1080, 1920, 540, 960)
    img = (torch.rand((8, 48, 48, 3), generator=g) * 255).to(cuda)

    def both():
        return (preproc.letterbox_normalize(planes, *taps, sb, geom),
                resize.resize_bilinear(img, 32, 32))
    both()                                   # warm-up: build, upload taps
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    planes.random_(0, 256)
    img.mul_(0.5)
    eager = both()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


def _boxes(n, seed):
    """Boxes on a coarse grid (exact repeats, tied IoUs), every 7th of zero
    height, scores on 16 levels."""
    rng = np.random.default_rng(seed)
    y0, x0 = rng.integers(0, 24, n) * 4.0, rng.integers(0, 24, n) * 4.0
    h, w = rng.choice([4.0, 8.0], n), rng.choice([4.0, 12.0], n)
    boxes = np.stack([y0, x0, y0 + h, x0 + w], axis=1).astype(np.float32)
    boxes[::7, 2] = boxes[::7, 0]
    return boxes, (rng.integers(0, 16, n) / 16.0).astype(np.float32)


@pytest.mark.parametrize("n", [1, 31, 33, 65, 256, 1000, 1001, 1024, 1025,
                               2048, 4096])
def test_iou_kernel_bit_exact(cuda, n):
    boxes, _ = _boxes(n, seed=n)
    bt = torch.from_numpy(boxes.T.copy()).to(cuda)
    count = preproc.iou_matrix.launches
    got = preproc.iou_matrix(bt)
    assert preproc.iou_matrix.launches == count + 1
    assert torch.equal(got, preproc.iou_matrix_plain(bt))
    assert torch.equal(got, got.T)
    np.testing.assert_array_equal(got.cpu().numpy(), host.iou_matrix(boxes))


def test_yuv_and_iou_replay_in_a_cuda_graph_bit_exactly(cuda):
    """The 1080p YUV decode (vec16 route) and a 4096-box IoU captured in one
    CUDA graph: 3 replays on new inputs give the eager calls' bits."""
    g = _gen(8)
    yuv = torch.randint(0, 256, (1, 3, 1080, 1920), generator=g,
                        dtype=torch.uint8).to(cuda)
    boxes, _ = _boxes(4096, seed=8)
    bt = torch.from_numpy(boxes.T.copy()).to(cuda)

    def both():
        return preproc.yuv_to_rgb(yuv), preproc.iou_matrix(bt)
    both()                                   # warm-up: build and load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    for _ in range(3):
        yuv.random_(0, 256)
        bt.copy_(bt[:, torch.randperm(4096, device=cuda)])
        eager = both()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


@pytest.mark.parametrize("n,max_out", [(33, None), (1000, None), (1000, 7)])
def test_device_nms_on_the_card_equals_host(cuda, n, max_out):
    boxes, scores = _boxes(n, seed=n + 1)
    assert pp_device.nms(boxes, scores, max_out=max_out, device=cuda) == \
        host.nms(boxes, scores, max_out=max_out)


FLASH_CASES = [(16, 16, {}), (37, 37, {}), (200, 200, {"window": 64}),
               (64, 300, {"q_offset": 236}), (130, 130, {"causal": False}),
               (200, 200, {"causal": False, "window": 64}),
               (1000, 1000, {}), (1000, 1000, {"window": 100})]
# (dtype, head width, the route it takes, tolerance): both routes at the
# ported widths (fp32 differs only in summation order; bf16 outputs are
# rounded to bf16 by both sides, and the wgmma route rounds P to bf16)
FLASH_ROUTES = [(torch.float32, 128, "simt", 2e-5),
                (torch.bfloat16, 128, "wgmma", 2e-2),
                (torch.float32, 256, "simt", 2e-5),
                (torch.bfloat16, 256, "wgmma", 2e-2),
                (torch.float32, 64, "simt", 2e-5),
                (torch.bfloat16, 64, "wgmma", 2e-2),
                (torch.bfloat16, 16, "simt", 2e-2)]


def _launches(wrapper, route):
    return wrapper.launches, wrapper.launches_by_route[route]


@pytest.mark.parametrize("dtype,D,route,atol", FLASH_ROUTES)
@pytest.mark.parametrize("Sq,Skv,kw", FLASH_CASES)
def test_flash_kernel_vs_plain(cuda, dtype, D, route, atol, Sq, Skv, kw):
    g = _gen(7)
    q = torch.randn((2, Sq, 8, D), generator=g).to(cuda, dtype)
    k = torch.randn((2, Skv, 2, D), generator=g).to(cuda, dtype)
    v = torch.randn((2, Skv, 2, D), generator=g).to(cuda, dtype)
    kw = {"causal": True, **kw}
    assert fa._route(dtype, D, D) == route
    n, n_route = _launches(fa.flash_attention, route)
    got = fa.flash_attention(q, k, v, **kw)
    assert _launches(fa.flash_attention, route) == (n + 1, n_route + 1)
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v, **kw).float(),
                               atol=atol, rtol=0)


# the zoo's prefill heads at their full width: (heads, kv heads, D) of
# granite-moe-3b, qwen2.5-14b, chameleon-34b and qwen1.5-110b, and
# gemma3-12b, on the wgmma route
ZOO_HEADS = [(24, 8, 64), (40, 8, 128), (64, 8, 128), (16, 8, 256)]


@pytest.mark.parametrize("H,KV,D", ZOO_HEADS)
@pytest.mark.parametrize("S,kw", [(37, {}), (512, {}), (1000, {"window": 100})])
def test_flash_kernel_vs_plain_at_the_zoo_heads(cuda, H, KV, D, S, kw):
    g = _gen(10)
    q = torch.randn((1, S, H, D), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((1, S, KV, D), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((1, S, KV, D), generator=g).to(cuda, torch.bfloat16)
    assert fa._route(torch.bfloat16, D, D) == "wgmma"
    n, n_route = _launches(fa.flash_attention, "wgmma")
    got = fa.flash_attention(q, k, v, causal=True, **kw)
    assert _launches(fa.flash_attention, "wgmma") == (n + 1, n_route + 1)
    torch.testing.assert_close(
        got.float(),
        fa.flash_attention_plain(q, k, v, causal=True, **kw).float(),
        atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype,atol,route", [(torch.bfloat16, 2e-2, "wgmma"),
                                              (torch.float32, 2e-5, "simt")])
@pytest.mark.parametrize("S", [16, 37, 512, 1024, 130, 1000])
def test_flash_kernel_vs_plain_at_the_mla_widths(cuda, dtype, atol, route, S):
    """deepseek-v2's prefill: 128 heads, D = 192 (nope + rope), Dv = 128,
    its explicit scale, on the tensor-core route in bf16 (ragged S too)
    and the CUDA-core route in fp32."""
    g = _gen(12)
    q = torch.randn((1, S, 128, 192), generator=g).to(cuda, dtype)
    k = torch.randn((1, S, 128, 192), generator=g).to(cuda, dtype)
    v = torch.randn((1, S, 128, 128), generator=g).to(cuda, dtype)
    assert fa._route(dtype, 192, 128) == route
    n, n_route = _launches(fa.flash_attention, route)
    got = fa.flash_attention(q, k, v, causal=True, scale=192 ** -0.5)
    assert _launches(fa.flash_attention, route) == (n + 1, n_route + 1)
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, causal=True,
                                              scale=192 ** -0.5).float(),
        atol=atol, rtol=0)


# (dtype, G, D, route, tolerance)
DECODE_ROUTES = [(torch.float32, 4, 128, "simt", 2e-5),
                 (torch.bfloat16, 4, 128, "mma", 2e-2),
                 (torch.bfloat16, 4, 64, "mma", 2e-2),     # D below the built 128
                 (torch.float32, 2, 16, "simt", 2e-5),
                 (torch.bfloat16, 2, 16, "mma", 2e-2),
                 (torch.bfloat16, 4, 72, "simt", 2e-2),
                 # the zoo's pairs: granite-moe-3b, qwen2.5-14b, chameleon-34b
                 (torch.bfloat16, 3, 64, "mma", 2e-2),
                 (torch.bfloat16, 5, 128, "mma", 2e-2),
                 (torch.bfloat16, 8, 128, "mma", 2e-2),
                 # gemma3-12b's pair, and a width below its built 256
                 (torch.bfloat16, 2, 256, "mma", 2e-2),
                 (torch.bfloat16, 2, 64, "mma", 2e-2),
                 (torch.float32, 2, 256, "simt", 2e-5),
                 (torch.float32, 3, 64, "simt", 2e-5),
                 (torch.float32, 5, 128, "simt", 2e-5),
                 (torch.float32, 8, 128, "simt", 2e-5),
                 # whisper-large-v3's MHA: G = 1 at D = 64
                 (torch.bfloat16, 1, 64, "mma", 2e-2),
                 (torch.float32, 1, 64, "simt", 2e-5)]


@pytest.mark.parametrize("dtype,G,D,route,atol", DECODE_ROUTES)
@pytest.mark.parametrize("L,window", [(768, None), (2048, 300), (2047, None),
                                      (96, None), (50, 7)])
def test_decode_kernel_vs_plain(cuda, dtype, G, D, route, atol, L, window):
    g = _gen(8)
    B, KV = 6, 2
    q = torch.randn((B, 1, KV * G, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, L, KV, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, L, KV, D), generator=g).to(cuda, dtype)
    lens = torch.tensor([0, 1, L, L // 2, L - 1, 3], dtype=torch.int32,
                        device=cuda)
    assert da._route(dtype, G, D, D) == route
    n, n_route = _launches(da.decode_attention, route)
    got = da.decode_attention(q, k, v, kv_len=lens, window=window)
    assert _launches(da.decode_attention, route) == (n + 1, n_route + 1)
    torch.testing.assert_close(
        got.float(),
        da.decode_attention_plain(q, k, v, kv_len=lens, window=window).float(),
        atol=atol, rtol=0)
    assert (got[0] == 0).all()                       # kv_len = 0: zeros


def test_tensor_core_attention_kernels_replay_in_a_cuda_graph(cuda):
    """Both tensor-core kernels captured in one CUDA graph (tensor maps and
    scratch made at capture) give, replayed, the bits of an eager call."""
    g = _gen(9)
    q = torch.randn((1, 300, 32, 128), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((1, 300, 8, 128), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((1, 300, 8, 128), generator=g).to(cuda, torch.bfloat16)
    dq = torch.randn((8, 1, 32, 128), generator=g).to(cuda, torch.bfloat16)
    dk = torch.randn((8, 2048, 8, 128), generator=g).to(cuda, torch.bfloat16)
    dv = torch.randn((8, 2048, 8, 128), generator=g).to(cuda, torch.bfloat16)
    lens = torch.tensor([0, 1, 2048, 552, 630, 83, 154, 33],
                        dtype=torch.int32, device=cuda)

    def both():
        return (fa.flash_attention(q, k, v, causal=True),
                da.decode_attention(dq, dk, dv, kv_len=lens))

    eager = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    n = (fa.flash_attention.launches_by_route["wgmma"],
         da.decode_attention.launches_by_route["mma"])
    graph.replay()
    torch.cuda.synchronize()
    assert n[0] > 0 and n[1] > 0
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


def test_attention_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 4, 320), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])         # D > 256
    q = torch.zeros((1, 1, 12, 16), device=cuda)
    kv = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError):                     # G = 6: not built
        da.decode_attention(q, kv, kv, kv_len=torch.ones(1, device=cuda))
    q, kv3 = torch.zeros((1, 1, 6, 128), device=cuda), kv.new_zeros((1, 8, 2, 128))
    with pytest.raises(ValueError):                     # G = 3, D = 128
        da.decode_attention(q, kv3, kv3, kv_len=torch.ones(1, device=cuda))
    q, kv = torch.zeros((1, 1, 4, 272), device=cuda), kv.new_zeros((1, 8, 2, 272))
    with pytest.raises(ValueError):                     # G = 2, D = 272
        da.decode_attention(q, kv, kv, kv_len=torch.ones(1, device=cuda))
    # contiguous but 2 bytes off a 16-byte boundary: TMA and cp.async
    # take 16-byte aligned rows, so the tensor-core routes raise
    buf = torch.zeros(1 + 4 * 32 * 128, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 4, 32, 128)
    kv = torch.zeros((1, 4, 8, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError):
        da.decode_attention(q[:, :1].contiguous(), kv, buf[1:1 + kv.numel()]
                            .view(kv.shape), kv_len=torch.ones(1, device=cuda))


# the flash backward kernel: (B, Sq, Skv, H, KV, D, Dv, kwargs) at
# llama3-8b's training shape and heads, whisper's encoder (MHA, D = 64,
# non-causal, a ragged 1,500) and its cross attention (Sq != Skv, one row
# against 1,500 frames), windows (one ragged), an offset chunk, on the
# wgmma route in bf16; ragged widths on the mma and CUDA-core routes
FLASH_BWD_CASES = [
    (4, 1024, 1024, 32, 8, 128, 128, {"causal": True}),
    (8, 1500, 1500, 20, 20, 64, 64, {"causal": False}),
    (2, 256, 256, 32, 8, 128, 128, {"causal": True}),
    (2, 187, 1500, 20, 20, 64, 64, {"causal": False}),
    (2, 1, 1500, 20, 20, 64, 64, {"causal": False}),
    (1, 300, 300, 8, 2, 128, 128, {"causal": True, "window": 100}),
    (1, 1000, 1000, 8, 2, 128, 128, {"causal": True, "window": 300}),
    (1, 130, 300, 8, 8, 64, 64, {"causal": True, "q_offset": 170}),
    (1, 77, 77, 4, 2, 48, 32, {"causal": True}),
    (1, 77, 90, 4, 2, 96, 112, {"causal": False}),
    (1, 77, 77, 4, 2, 32, 32, {"causal": True}),     # bf16 on mma.sync
    (1, 77, 77, 4, 2, 40, 24, {"causal": True}),     # bf16 on the CUDA cores
]
# tolerance relative to the largest gradient (bf16 inputs: the forward's
# P is rounded to bf16, so autograd of the plain version differs more)
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv,kw", FLASH_BWD_CASES)
def test_flash_backward_kernel_vs_plain_and_autograd(cuda, dtype, B, Sq, Skv,
                                                     H, KV, D, Dv, kw):
    """dQ, dK, dV of the backward kernel (bf16 at D = Dv in {64, 128} on
    wgmma, at other multiples of 16 on mma.sync, the rest on the CUDA
    cores) against the plain formulas on the
    same (o, lse) and against autograd of the plain forward, through
    FlashAttentionFn as a training step calls it; the forward's lse
    against the plain one."""
    g = _gen(21)
    q = torch.randn((B, Sq, H, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, Dv), generator=g).to(cuda, dtype)
    do = torch.randn((B, Sq, H, Dv), generator=g).to(cuda, dtype)
    opts = (kw["causal"], kw.get("window"), kw.get("q_offset", 0), None)
    o, lse = fa._forward(q, k, v, *opts, True)
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k, v, **kw),
                               atol=1e-5, rtol=1e-5)
    route = fa._bwd_route(dtype, D, Dv)
    n = fa.flash_attention_bwd.launches_by_route[route]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd.launches_by_route[route] == n + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention_plain(*leaves, **kw),
                               leaves, do.float())
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    through = torch.autograd.grad(fa.flash_attention(qq, kk, vv, **kw),
                                  (qq, kk, vv), do)
    for a, b, c, d in zip(got, want, auto, through):
        scale = c.abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= BWD_RTOL[dtype] * scale
        assert (a.float() - c).abs().max().item() <= BWD_RTOL[dtype] * scale
        assert (d.float() - c).abs().max().item() <= BWD_RTOL[dtype] * scale


def test_mla_and_backward_routes_replay_in_a_cuda_graph(cuda):
    """The MLA forward (D = 192, Dv = 128) and the wgmma backward captured
    in one CUDA graph (tensor maps and workspaces made at capture) give,
    replayed, the bits of an eager call. With one key tile (Skv <= 128)
    each dQ element takes one bulk add into the zeroed buffer, so dQ is
    bit-exact too; with several, the fp32 adds of the key tiles land in no
    fixed order, so an element of dQ may round to the neighbouring bf16
    value (held to one bf16 step of itself), while dK and dV (summed in
    registers) stay bit-exact."""
    g = _gen(13)
    mq = torch.randn((1, 300, 128, 192), generator=g).to(cuda, torch.bfloat16)
    mk = torch.randn((1, 300, 128, 192), generator=g).to(cuda, torch.bfloat16)
    mv = torch.randn((1, 300, 128, 128), generator=g).to(cuda, torch.bfloat16)
    bwd = []
    for Sq, Skv, causal in ((300, 120, False), (700, 700, True)):
        q = torch.randn((2, Sq, 32, 128), generator=g).to(cuda, torch.bfloat16)
        k = torch.randn((2, Skv, 8, 128), generator=g).to(cuda, torch.bfloat16)
        v = torch.randn((2, Skv, 8, 128), generator=g).to(cuda, torch.bfloat16)
        do = torch.randn((2, Sq, 32, 128), generator=g).to(cuda, torch.bfloat16)
        o, lse = fa._forward(q, k, v, causal, None, 0, None, True)
        bwd.append((q, k, v, o, lse, do, causal))
    assert fa._route(torch.bfloat16, 192, 128) == "wgmma"
    assert fa._bwd_route(torch.bfloat16, 128, 128) == "wgmma"

    def calls():
        out = [fa.flash_attention(mq, mk, mv, causal=True)]
        for q, k, v, o, lse, do, causal in bwd:
            out.extend(fa.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal))
        return out

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = (fa.flash_attention.launches_by_route["wgmma"],
         fa.flash_attention_bwd.launches_by_route["wgmma"])
    with torch.cuda.graph(graph):
        captured = calls()
    assert (fa.flash_attention.launches_by_route["wgmma"],
            fa.flash_attention_bwd.launches_by_route["wgmma"]) == (n[0] + 1,
                                                                 n[1] + 2)
    graph.replay()
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(captured, eager)):
        if i == 4:                     # dQ of the 700-key case
            step = want.float().abs() * 2.0 ** -7
            assert bool(((got.float() - want.float()).abs() <= step).all())
        else:
            assert torch.equal(got, want), i


# (B, Sq, Skv, H, KV, D, Dv, kwargs) of the split wgmma backward (bf16 at
# gemma3's 256 and MLA's 192 | 128): gemma3's training shape, S = 2,048
# past its window of 1,024 and a small window, so that tiles cross the
# window's edge, a ragged Sq, an offset chunk with Skv > Sq, G = 2
# throughout; MLA's training shape at its scale 192 ** -0.5 (the default
# D ** -0.5), a ragged S = 37 and a window
FLASH_BWD_SPLIT_CASES = [
    (4, 1024, 1024, 16, 8, 256, 256, {"causal": True}),
    (1, 2048, 2048, 16, 8, 256, 256, {"causal": True, "window": 1024}),
    (1, 2048, 2048, 16, 8, 256, 256, {"causal": True, "window": 100}),
    (1, 1000, 1000, 16, 8, 256, 256, {"causal": True}),
    (1, 300, 470, 16, 8, 256, 256, {"causal": True, "q_offset": 170}),
    (2, 130, 130, 4, 2, 256, 256, {"causal": False}),
    (4, 1024, 1024, 128, 128, 192, 128, {"causal": True}),
    (2, 37, 37, 128, 128, 192, 128, {"causal": True}),
    (1, 300, 300, 16, 16, 192, 128, {"causal": True, "window": 100}),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv,kw", FLASH_BWD_SPLIT_CASES)
def test_flash_backward_split_kernel_vs_plain_and_autograd(cuda, B, Sq, Skv,
                                                           H, KV, D, Dv, kw):
    """The split wgmma backward (bf16 only) against the plain formulas on
    the same (o, lse) and autograd of the plain forward, and through
    FlashAttentionFn as a training step calls it, within 2e-2 of the
    largest gradient; the forward's lse at these widths against the plain
    one."""
    g = _gen(23)
    dtype = torch.bfloat16
    q = torch.randn((B, Sq, H, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, Dv), generator=g).to(cuda, dtype)
    do = torch.randn((B, Sq, H, Dv), generator=g).to(cuda, dtype)
    opts = (kw["causal"], kw.get("window"), kw.get("q_offset", 0), None)
    o, lse = fa._forward(q, k, v, *opts, True)
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k, v, **kw),
                               atol=1e-4, rtol=1e-5)
    assert fa._bwd_route(dtype, D, Dv) == "wgmma_split"
    n = fa.flash_attention_bwd.launches_by_route["wgmma_split"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention_bwd.launches_by_route["wgmma_split"] == n + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention_plain(*leaves, **kw),
                               leaves, do.float())
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    through = torch.autograd.grad(fa.flash_attention(qq, kk, vv, **kw),
                                  (qq, kk, vv), do)
    for a, b, c, d in zip(got, want, auto, through):
        scale = c.abs().max().item()
        assert bool(torch.isfinite(a.float()).all())
        assert (a.float() - b.float()).abs().max().item() <= BWD_RTOL[dtype] * scale
        assert (a.float() - c).abs().max().item() <= BWD_RTOL[dtype] * scale
        assert (d.float() - c).abs().max().item() <= BWD_RTOL[dtype] * scale


def test_split_backward_route_replays_in_a_cuda_graph(cuda):
    """The split backward at both widths captured in one CUDA graph gives,
    replayed, the bits of an eager call in dK and dV (summed in registers)
    and in dQ with one key tile (Skv <= 64: one bulk add an element into
    the zeroed buffer); with several key tiles dQ's fp32 adds land in no
    fixed order, so an element may round to the neighbouring bf16 value
    (held to one bf16 step of itself)."""
    g = _gen(17)
    cases = []
    for B, Sq, Skv, H, KV, D, Dv, kw in (
            (2, 60, 60, 16, 8, 256, 256, {"causal": True}),
            (1, 700, 700, 16, 8, 256, 256, {"causal": True, "window": 300}),
            (1, 500, 500, 32, 32, 192, 128, {"causal": True})):
        q = torch.randn((B, Sq, H, D), generator=g).to(cuda, torch.bfloat16)
        k = torch.randn((B, Skv, KV, D), generator=g).to(cuda, torch.bfloat16)
        v = torch.randn((B, Skv, KV, Dv), generator=g).to(cuda, torch.bfloat16)
        do = torch.randn((B, Sq, H, Dv), generator=g).to(cuda, torch.bfloat16)
        o, lse = fa._forward(q, k, v, kw["causal"], kw.get("window"), 0, None,
                             True)
        cases.append((q, k, v, o, lse, do, kw))

    def calls():
        out = []
        for q, k, v, o, lse, do, kw in cases:
            out.extend(fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        return out

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = fa.flash_attention_bwd.launches_by_route["wgmma_split"]
    with torch.cuda.graph(graph):
        captured = calls()
    assert fa.flash_attention_bwd.launches_by_route["wgmma_split"] == n + 3
    graph.replay()
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(captured, eager)):
        if i in (3, 6):                # dQ of the cases with several key tiles
            step = want.float().abs() * 2.0 ** -7
            assert bool(((got.float() - want.float()).abs() <= step).all())
        else:
            assert torch.equal(got, want), i


def test_flash_backward_kernel_rejects_what_it_does_not_take(cuda):
    """float32 above D, Dv = 128 (gemma3's 256 and MLA's 192 | 128 among
    it) and a bf16 width above the split route's have no backward kernel."""
    for dtype, D, Dv in ((torch.float32, 256, 256), (torch.float32, 192, 128),
                         (torch.bfloat16, 288, 288)):
        q = torch.zeros((1, 4, 2, D), device=cuda, dtype=dtype)
        v = torch.zeros((1, 4, 2, Dv), device=cuda, dtype=dtype)
        lse = torch.zeros((1, 2, 4), device=cuda)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd(q, q, v, v, lse, v)


def test_kernels_without_a_backward_refuse_grad(cuda):
    """Under grad, every CUDA wrapper without a backward kernel (decode
    attention, the matmul and the scans' decode steps) raises rather than
    return a tensor with no gradient; under no_grad they run."""
    q = torch.randn((2, 1, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((2, 8, 4, 64), device=cuda)
    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q, kv, kv, kv_len=lens)
    a = torch.randn((4, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        mm.matmul(a, torch.randn((16, 8), device=cuda))
    r, w, k, v, u, h0 = _scan_inputs(1, 8, 2, 64, torch.float32, cuda)
    r.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ls.rwkv_decode_step(r[:, 0], w[:, 0], k[:, 0], v[:, 0], u, h0)
    x = torch.randn((1, 4, 128), device=cuda, requires_grad=True)
    delta = torch.rand((1, 4, 128), device=cuda)
    A = -torch.rand((128, 4), device=cuda)
    Bt = torch.randn((1, 4, 4), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ls.mamba_decode_step(delta[:, 0], A, Bt[:, 0], Bt[:, 0], x[:, 0],
                             torch.zeros((1, 128, 4), device=cuda))
    with torch.no_grad():
        assert da.decode_attention(q, kv, kv, kv_len=lens).shape == q.shape


def _scan_inputs(B, S, H, K, dtype, device, seed=9):
    """r, w, k, v, u, h0 with decays exp(-exp(N(0, 1))) spanning (0, 1)
    and a non-zero bonus u; w and h0 in float32."""
    g = _gen(seed)
    r = torch.randn((B, S, H, K), generator=g)
    w = torch.exp(-torch.exp(torch.randn((B, S, H, K), generator=g)))
    k = torch.randn((B, S, H, K), generator=g) * 0.3
    v = torch.randn((B, S, H, K), generator=g)
    u = torch.randn((H, K), generator=g) * 0.5
    h0 = torch.randn((B, H, K, K), generator=g) * 0.1
    return (r.to(device, dtype), w.to(device), k.to(device, dtype),
            v.to(device, dtype), u.to(device, dtype), h0.to(device))


# tolerances relative to the largest output: float32 differs from the plain
# version only in summation order; in bfloat16 both sides round o to bf16
SCAN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,with_h0", [(1, 1024, 40, 64, False),
                                             (1, 37, 40, 64, True),
                                             (8, 1, 40, 64, True),
                                             (2, 45, 4, 16, True)])
def test_rwkv_scan_kernel_vs_plain(cuda, dtype, B, S, H, K, with_h0):
    r, w, k, v, u, h0 = _scan_inputs(B, S, H, K, dtype, cuda)
    h0 = h0 if with_h0 else None
    count = ls.rwkv_scan.launches
    o, h = ls.rwkv_scan(r, w, k, v, u, h0)
    assert ls.rwkv_scan.launches == count + 1
    po, ph = ls.rwkv_scan_plain(r, w, k, v, u, h0)
    assert o.dtype == dtype and h.dtype == torch.float32
    tol = SCAN_RTOL[dtype] * po.float().abs().max().item()
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=0)
    torch.testing.assert_close(h, ph, atol=1e-5 * ph.abs().max().item(),
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_decode_step_in_place_equals_out_of_place(cuda, dtype):
    r, w, k, v, u, h0 = _scan_inputs(8, 1, 40, 64, dtype, cuda)
    o, h = ls.rwkv_scan(r, w, k, v, u, h0)
    state = h0.clone()
    count = ls.rwkv_scan.launches
    o1, out = ls.rwkv_decode_step(r[:, 0], w[:, 0], k[:, 0], v[:, 0], u,
                                  state)
    assert ls.rwkv_scan.launches == count + 1 and out is state
    assert torch.equal(o1, o[:, 0]) and torch.equal(state, h)
    po, _ = ls.rwkv_decode_step_plain(r[:, 0], w[:, 0], k[:, 0], v[:, 0], u,
                                      h0.clone())
    tol = SCAN_RTOL[dtype] * po.float().abs().max().item()
    torch.testing.assert_close(o1.float(), po.float(), atol=tol, rtol=0)


def _hard_decays(w, seed):
    """w with exact zeros, denormals and exact ones in about 5% of its
    values each."""
    u = torch.rand(w.shape, generator=_gen(seed)).to(w.device)
    w = torch.where(u < 0.05, torch.zeros_like(w), w)
    w = torch.where((u >= 0.05) & (u < 0.10), torch.full_like(w, 1e-40), w)
    return torch.where((u >= 0.10) & (u < 0.15), torch.ones_like(w), w)


# (B, S, H, K, dtype, hard decays, route)
RWKV_ROUTE_CASES = [(1, S, 40, 64, torch.bfloat16, False, "chunk")
                    for S in (ls.CHUNK_MIN_S, 37, 64, 65, 130, 1000)]
RWKV_ROUTE_CASES += [(1, S, 40, 64, torch.bfloat16, False, "serial")
                     for S in (2, ls.CHUNK_MIN_S - 1)]
RWKV_ROUTE_CASES += [(2, 150, 3, 64, torch.bfloat16, True, "chunk"),
                     (1, 1024, 40, 64, torch.bfloat16, True, "chunk"),
                     (8, 1, 40, 64, torch.bfloat16, False, "serial"),
                     (1, 130, 40, 64, torch.float32, True, "serial"),
                     (2, 45, 4, 16, torch.bfloat16, False, "serial")]


@pytest.mark.parametrize("B,S,H,K,dtype,hard,route", RWKV_ROUTE_CASES)
def test_rwkv_scan_routes_vs_plain(cuda, B, S, H, K, dtype, hard, route):
    r, w, k, v, u, h0 = _scan_inputs(B, S, H, K, dtype, cuda, seed=S)
    if hard:
        w = _hard_decays(w, seed=S)
    assert ls._route(dtype, K, K, S) == route
    for h in (None, h0):
        n = ls.rwkv_scan.launches_by_route[route]
        o, st = ls.rwkv_scan(r, w, k, v, u, h)
        assert ls.rwkv_scan.launches_by_route[route] == n + 1
        po, ph = ls.rwkv_scan_plain(r, w, k, v, u, h)
        assert bool(torch.isfinite(o.float()).all() and torch.isfinite(st).all())
        tol = SCAN_RTOL[dtype] * po.float().abs().max().item()
        torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=0)
        torch.testing.assert_close(st, ph, atol=1e-5 * ph.abs().max().item(),
                                   rtol=0)


def test_rwkv_chunk_route_in_place_equals_out_of_place(cuda):
    r, w, k, v, u, h0 = _scan_inputs(1, 130, 40, 64, torch.bfloat16, cuda)
    o, h = ls.rwkv_scan(r, w, k, v, u, h0)
    state = h0.clone()
    n = ls.rwkv_scan.launches_by_route["chunk"]
    o1, out = ls.rwkv_scan(r, w, k, v, u, state, state_out=state)
    assert ls.rwkv_scan.launches_by_route["chunk"] == n + 1 and out is state
    assert torch.equal(o1, o) and torch.equal(state, h)


def test_rwkv_scan_routes_replay_in_a_cuda_graph(cuda):
    """A chunked prefill and a serial decode step captured in one CUDA
    graph (workspaces made at capture) give, replayed, the bits of eager
    calls, the decode step's state updated in place each replay."""
    r, w, k, v, u, h0 = _scan_inputs(1, 200, 40, 64, torch.bfloat16, cuda)
    dr, dw, dk, dv, _, dh = _scan_inputs(8, 1, 40, 64, torch.bfloat16, cuda,
                                         seed=4)
    state = dh.clone()

    def both():
        o, h = ls.rwkv_scan(r, w, k, v, u, h0)
        od, _ = ls.rwkv_decode_step(dr[:, 0], dw[:, 0], dk[:, 0], dv[:, 0], u,
                                    state)
        return o, h, od

    eager = both()
    after_one = state.clone()
    want = both()                                  # from after_one
    state.copy_(dh)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    state.copy_(dh)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, eager))
    assert torch.equal(state, after_one)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, want))


def test_rwkv_scan_kernel_rejects_what_it_does_not_take(cuda):
    r, w, k, v, u, h0 = _scan_inputs(1, 4, 2, 32, torch.float32, cuda)
    with pytest.raises(ValueError):                       # K = 32: not built
        ls.rwkv_scan(r, w, k, v, u, h0)
    r, w, k, v, u, h0 = _scan_inputs(1, 4, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError):                       # bf16 w
        ls.rwkv_scan(r, w.bfloat16(), k, v, u, h0)
    with pytest.raises(ValueError):                       # mixed r, k
        ls.rwkv_scan(r, w, k.bfloat16(), v, u, h0)
    with pytest.raises(ValueError):                       # not contiguous
        ls.rwkv_scan(r.transpose(1, 2).contiguous().transpose(1, 2), w, k,
                     v, u, h0)
    # the chunked route takes 16-byte aligned rows: 2 bytes off raises
    r, w, k, v, u, h0 = _scan_inputs(1, ls.CHUNK_MIN_S, 2, 64,
                                     torch.bfloat16, cuda)
    buf = torch.zeros(1 + r.numel(), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ls.rwkv_scan(buf[1:].view(r.shape), w, k, v, u, h0)


def _mamba_inputs(B, S, Di, N, dtype, device, seed=11):
    """delta = softplus(N(0, 1)), A = -exp(N(0, 0.5)) (Di, N) in float32,
    Bt, Ct (B, S, N), x (B, S, Di), h0 (B, Di, N) float32."""
    g = _gen(seed)
    delta = torch.nn.functional.softplus(torch.randn((B, S, Di), generator=g))
    A = -torch.exp(0.5 * torch.randn((Di, N), generator=g))
    Bt = torch.randn((B, S, N), generator=g)
    Ct = torch.randn((B, S, N), generator=g)
    x = torch.randn((B, S, Di), generator=g)
    h0 = 0.5 * torch.randn((B, Di, N), generator=g)
    return (delta.to(device, dtype), A.to(device), Bt.to(device, dtype),
            Ct.to(device, dtype), x.to(device, dtype), h0.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,with_h0", [(1, 1024, 8192, 16, False),
                                              (1, 37, 8192, 16, True),
                                              (3, 50, 8192, 16, True),
                                              (8, 1, 8192, 16, True),
                                              (2, 45, 128, 4, True),
                                              (1, 19, 200, 4, False)])
def test_mamba_scan_kernel_vs_plain(cuda, dtype, B, S, Di, N, with_h0):
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(B, S, Di, N, dtype, cuda)
    h0 = h0 if with_h0 else None
    count = ls.mamba_scan.launches
    y, h = ls.mamba_scan(delta, A, Bt, Ct, x, h0)
    assert ls.mamba_scan.launches == count + 1
    py, ph = ls.mamba_scan_plain(delta, A, Bt, Ct, x, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = SCAN_RTOL[dtype] * py.float().abs().max().item()
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=0)
    torch.testing.assert_close(h, ph, atol=1e-5 * ph.abs().max().item(),
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Di,N", [(8192, 16), (128, 4)])
def test_mamba_decode_step_in_place_equals_out_of_place(cuda, dtype, Di, N):
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(8, 1, Di, N, dtype, cuda)
    y, h = ls.mamba_scan(delta, A, Bt, Ct, x, h0)
    state = h0.clone()
    count = ls.mamba_scan.launches
    y1, out = ls.mamba_decode_step(delta[:, 0], A, Bt[:, 0], Ct[:, 0],
                                   x[:, 0], state)
    assert ls.mamba_scan.launches == count + 1 and out is state
    assert torch.equal(y1, y[:, 0]) and torch.equal(state, h)
    py, _ = ls.mamba_decode_step_plain(delta[:, 0], A, Bt[:, 0], Ct[:, 0],
                                       x[:, 0], h0.clone())
    tol = SCAN_RTOL[dtype] * py.float().abs().max().item()
    torch.testing.assert_close(y1.float(), py.float(), atol=tol, rtol=0)


def _hard_steps(delta, seed):
    """delta = 100 in about 5% of its elements: delta |A| reaches ~100 and
    more, so exp(delta A) is 0 or a denormal there."""
    u = torch.rand(delta.shape, generator=_gen(seed)).to(delta.device)
    return torch.where(u < 0.05, torch.full_like(delta, 100.0), delta)


# (B, S, Di, N, dtype, hard decays, route)
MAMBA_ROUTE_CASES = [(1, S, 8192, 16, dtype, False, "segmented")
                     for S in (ls.MAMBA_SEG_MIN_S, 16, 33, 37, 1024)
                     for dtype in (torch.bfloat16, torch.float32)]
MAMBA_ROUTE_CASES += [(1, S, 8192, 16, torch.bfloat16, False, "serial")
                      for S in (2, ls.MAMBA_SEG_MIN_S - 1)]
# float32 within 1e-5 with the segmented route's ex2.approx exponentials,
# decays of 0 and denormals included
MAMBA_ROUTE_CASES += [(1, 1024, 8192, 16, torch.float32, True, "segmented"),
                      (1, 1024, 8192, 16, torch.bfloat16, True, "segmented"),
                      (1, 130, 8192, 16, torch.float32, True, "segmented"),
                      (3, 50, 8192, 16, torch.bfloat16, False, "segmented"),
                      (2, 37, 200, 16, torch.float32, True, "segmented"),
                      (8, 1, 8192, 16, torch.bfloat16, True, "step"),
                      (8, 1, 8192, 16, torch.float32, False, "step"),
                      (3, 1, 100, 16, torch.float32, False, "step"),
                      (2, 45, 128, 4, torch.bfloat16, True, "serial")]


@pytest.mark.parametrize("B,S,Di,N,dtype,hard,route", MAMBA_ROUTE_CASES)
def test_mamba_scan_routes_vs_plain(cuda, B, S, Di, N, dtype, hard, route):
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(B, S, Di, N, dtype, cuda, seed=S)
    if hard:
        delta = _hard_steps(delta, seed=S)
    assert ls._mamba_route(dtype, N, S) == route
    for h in (None, h0):
        n = ls.mamba_scan.launches_by_route[route]
        y, st = ls.mamba_scan(delta, A, Bt, Ct, x, h)
        assert ls.mamba_scan.launches_by_route[route] == n + 1
        py, ph = ls.mamba_scan_plain(delta, A, Bt, Ct, x, h)
        assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
        tol = SCAN_RTOL[dtype] * py.float().abs().max().item()
        torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=0)
        torch.testing.assert_close(st, ph, atol=1e-5 * ph.abs().max().item(),
                                   rtol=0)


def test_mamba_segmented_route_in_place_equals_out_of_place(cuda):
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 130, 8192, 16, torch.bfloat16,
                                            cuda)
    y, h = ls.mamba_scan(delta, A, Bt, Ct, x, h0)
    state = h0.clone()
    n = ls.mamba_scan.launches_by_route["segmented"]
    y1, out = ls.mamba_scan(delta, A, Bt, Ct, x, state, state_out=state)
    assert ls.mamba_scan.launches_by_route["segmented"] == n + 1
    assert out is state and torch.equal(y1, y) and torch.equal(state, h)


def test_mamba_scan_routes_replay_in_a_cuda_graph(cuda):
    """A segmented prefill and a lane-split decode step captured in one
    CUDA graph give, replayed, the bits of eager calls, the decode step's
    state updated in place each replay."""
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 200, 8192, 16, torch.bfloat16,
                                            cuda)
    dd, _, db, dc, dx, dh = _mamba_inputs(8, 1, 8192, 16, torch.bfloat16,
                                          cuda, seed=4)
    state = dh.clone()

    def both():
        y, h = ls.mamba_scan(delta, A, Bt, Ct, x, h0)
        yd, _ = ls.mamba_decode_step(dd[:, 0], A, db[:, 0], dc[:, 0], dx[:, 0],
                                     state)
        return y, h, yd

    assert ls._mamba_route(torch.bfloat16, 16, 200) == "segmented"
    assert ls._mamba_route(torch.bfloat16, 16, 1) == "step"
    eager = both()
    after_one = state.clone()
    want = both()                                  # from after_one
    state.copy_(dh)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    state.copy_(dh)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, eager))
    assert torch.equal(state, after_one)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, want))


def test_mamba_scan_kernel_rejects_what_it_does_not_take(cuda):
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 4, 64, 8, torch.float32, cuda)
    with pytest.raises(ValueError):                       # N = 8: not built
        ls.mamba_scan(delta, A, Bt, Ct, x, h0)
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 4, 64, 4, torch.float32, cuda)
    with pytest.raises(ValueError):                       # float64
        ls.mamba_scan(delta.double(), A, Bt.double(), Ct.double(),
                      x.double(), h0)
    with pytest.raises(ValueError):                       # mixed delta, x
        ls.mamba_scan(delta, A, Bt, Ct, x.bfloat16(), h0)
    with pytest.raises(ValueError):                       # bf16 h0
        ls.mamba_scan(delta, A, Bt, Ct, x, h0.bfloat16())
    wide = torch.zeros((1, 4, 2 * 4), device=cuda)
    with pytest.raises(ValueError):                       # not contiguous
        ls.mamba_scan(delta, A, wide[..., :4], Ct, x, h0)
    # the segmented route takes Di a multiple of 8 and 16-byte aligned rows
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 64, 100, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        ls.mamba_scan(delta, A, Bt, Ct, x, h0)
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 64, 128, 16, torch.bfloat16, cuda)
    buf = torch.zeros(1 + x.numel(), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ls.mamba_scan(delta, A, Bt, Ct, buf[1:].view(x.shape), h0)


# the scan backward kernels: (kind, B, S, (H, K) or (Di, N), dtype, the
# forward route whose checkpoints they read); the chunked backwards take
# their widths at any S, behind any forward route
SCAN_BWD_CASES = [("rwkv", 1, 130, (40, 64), torch.bfloat16, "chunk"),
                  ("rwkv", 2, 65, (8, 64), torch.bfloat16, "chunk"),
                  ("rwkv", 2, 20, (8, 64), torch.bfloat16, "serial"),
                  ("rwkv", 3, 1, (8, 64), torch.bfloat16, "serial"),
                  ("rwkv", 2, 37, (4, 16), torch.bfloat16, "serial"),
                  ("rwkv", 2, 70, (8, 64), torch.float32, "serial"),
                  ("mamba", 2, 130, (256, 16), torch.bfloat16, "segmented"),
                  ("mamba", 2, 70, (256, 16), torch.float32, "segmented"),
                  ("mamba", 2, 5, (256, 16), torch.float32, "serial"),
                  ("mamba", 3, 1, (256, 16), torch.bfloat16, "step"),
                  ("mamba", 2, 45, (128, 4), torch.float32, "serial")]
# relative to the largest gradient, as flash's backward is held
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_routes(kind, dims, dtype):
    """The backward routes that take a case: the one its shape takes (a
    pure function of the shape) first, then the serial route, which takes
    every built shape, where it is another."""
    route = (ls._rwkv_bwd_route(dtype, dims[1], dims[1]) if kind == "rwkv"
             else ls._mamba_bwd_route(dtype, dims[1]))
    return [route] + (["serial"] if route != "serial" else [])


# each case on every backward route that takes it
SCAN_BWD_ROUTE_CASES = [case + (bwd,) for case in SCAN_BWD_CASES
                        for bwd in _bwd_routes(case[0], case[3], case[4])]


def _scan_bwd_inputs(kind, B, S, dims, dtype, device):
    if kind == "rwkv":
        return list(_scan_inputs(B, S, *dims, dtype, device))
    return list(_mamba_inputs(B, S, *dims, dtype, device))


def _scan_bwd_thunk(kind, ins, dy, dh, bwd_route):
    """The ``kind`` backward wrapper on ``bwd_route`` at ``ins``, ``dy`` and
    ``dh``, from the checkpoints of the forward route the shape takes
    (launched once, here): the wrapper's route chooser answers
    ``bwd_route`` for the length of each call."""
    if kind == "rwkv":
        r, w, k, v, u, h0 = ins
        uf, state = u.float(), torch.empty_like(h0)
        _, ckpt = ls._launch(ls._route(r.dtype, r.shape[3], v.shape[3],
                                       r.shape[1]), r, w, k, v, uf, h0,
                             state, True)
        call = lambda: ls.rwkv_scan_bwd(r, w, k, v, uf, h0, dy, dh,
                                        ckpt=ckpt)
    else:
        delta, A, Bt, Ct, x, h0 = ins
        B, S, Di = delta.shape
        state = torch.empty_like(h0)
        ckpt = torch.empty((B, -(-S // ls.CHUNK), Di, A.shape[1]),
                           device=x.device)
        ls._launch_mamba(ls._mamba_route(x.dtype, A.shape[1], S), delta, x,
                         A, Bt, Ct, h0, state, ckpt)
        call = lambda: ls.mamba_scan_bwd(delta, A, Bt, Ct, x, h0, dy, dh,
                                         ckpt=ckpt)

    def forced():
        with mock.patch.object(ls, f"_{kind}_bwd_route",
                               lambda *args: bwd_route):
            return call()
    return forced


@pytest.mark.parametrize("kind,B,S,dims,dtype,route,bwd_route",
                         SCAN_BWD_ROUTE_CASES)
def test_scan_backward_kernels_vs_plain_formulas(cuda, kind, B, S, dims,
                                                 dtype, route, bwd_route):
    """Autograd through the forward wrapper (its route, asked for the
    checkpoints) launches the backward route the shape takes once; the
    serial route, where it is another, is forced on the same checkpoints
    by the wrapper's route chooser; the
    gradients, with a non-zero h0 and a final-state gradient, within
    BWD_RTOL of the plain formulas' on the same inputs."""
    ins = _scan_bwd_inputs(kind, B, S, dims, dtype, cuda)
    fwd, bwd = ((ls.rwkv_scan, ls.rwkv_scan_bwd) if kind == "rwkv"
                else (ls.mamba_scan, ls.mamba_scan_bwd))
    plain = (ls.rwkv_scan_bwd_plain if kind == "rwkv"
             else ls.mamba_scan_bwd_plain)
    g = _gen(5)
    out_shape = ins[3].shape if kind == "rwkv" else ins[4].shape
    dy = torch.randn(out_shape, generator=g).to(cuda, dtype)
    dh = torch.randn(ins[5].shape, generator=g).to(cuda)
    n_f, n_b = fwd.launches_by_route[route], bwd.launches_by_route[bwd_route]
    if bwd_route == _bwd_routes(kind, dims, dtype)[0]:
        leaves = [t.detach().requires_grad_() for t in ins]
        y, h = fwd(*leaves)
        got = torch.autograd.grad((y, h), leaves, (dy, dh))
        assert fwd.launches_by_route[route] == n_f + 1
    else:
        got = list(_scan_bwd_thunk(kind, ins, dy, dh, bwd_route)())
        # the wrapper takes u (A) widened to float32; autograd narrows its
        # gradient back through the widening
        got[4 if kind == "rwkv" else 1] = got[4 if kind == "rwkv" else 1] \
            .to(ins[4 if kind == "rwkv" else 1].dtype)
    assert bwd.launches_by_route[bwd_route] == n_b + 1
    want = plain(*ins, dy, dh)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all()
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() \
            <= BWD_RTOL[dtype] * top


@pytest.mark.parametrize("kind,bwd_route", [("rwkv", "chunk"),
                                            ("rwkv", "serial"),
                                            ("mamba", "chunk"),
                                            ("mamba", "serial")])
def test_scan_backwards_replay_in_a_cuda_graph_bit_exactly(cuda, kind,
                                                           bwd_route):
    """Each backward route captured in a CUDA graph (workspaces made at
    capture) gives, replayed, the bits of the eager call, and a second
    eager call the bits of the first: its sums over blocks are partials
    added in a fixed order, no atomics."""
    if kind == "rwkv":
        ins = list(_scan_inputs(2, 100, 40, 64, torch.bfloat16, cuda))
        dy = torch.randn(ins[3].shape, generator=_gen(3)).to(cuda,
                                                             torch.bfloat16)
    else:
        ins = list(_mamba_inputs(2, 100, 512, 16, torch.bfloat16, cuda))
        dy = torch.randn(ins[4].shape, generator=_gen(3)).to(cuda,
                                                             torch.bfloat16)
    dh = torch.randn(ins[5].shape, generator=_gen(4)).to(cuda)
    call = _scan_bwd_thunk(kind, ins, dy, dh, bwd_route)
    eager = call()
    again = call()
    assert all(torch.equal(a, e) for a, e in zip(again, eager))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, eager))


def test_scan_backwards_reject_what_they_do_not_take(cuda):
    """The backward kernels need the forward's checkpoints; a width no
    route takes raises (the route functions); the chunked Mamba route takes
    Di a multiple of 8; a scan under grad takes no state_out."""
    r, w, k, v, u, h0 = _scan_inputs(1, 8, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="checkpoints"):
        ls.rwkv_scan_bwd(r, w, k, v, u.float(), h0, v)
    r, w, k, v, u, h0 = _scan_inputs(1, 8, 2, 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="K = V in"):      # K = 32: not built
        ls.rwkv_scan_bwd(r, w, k, v, u.float(), h0, v,
                         ckpt=torch.zeros((1, 2, 1, 32, 32), device=cuda))
    delta, A, Bt, Ct, x, h0 = _mamba_inputs(1, 8, 64, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="checkpoints"):
        ls.mamba_scan_bwd(delta, A, Bt, Ct, x, h0, x)
    d8, A8, B8, C8, x8, h8 = _mamba_inputs(1, 8, 64, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="N in"):          # N = 8: not built
        ls.mamba_scan_bwd(d8, A8, B8, C8, x8, h8, x8,
                          ckpt=torch.zeros((1, 1, 64, 8), device=cuda))
    d16, A16, B16, C16, x16, h16 = _mamba_inputs(1, 8, 100, 16,
                                                 torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):  # Di = 100
        ls.mamba_scan_bwd(d16, A16, B16, C16, x16, h16, x16,
                          ckpt=torch.zeros((1, 1, 100, 16), device=cuda))
    with pytest.raises(ValueError, match="state_out"):
        ls.mamba_scan(delta, A, Bt, Ct, x.requires_grad_(), h0,
                      state_out=torch.empty_like(h0))


def test_real_service_cluster_serves_on_the_card(cuda):
    """``ServingCluster(service="real")`` on the card with the device
    placement: stable at S = 4, and over the timed run every identify
    batch launched the matmul kernel twice and the YUV kernel once (the
    warm-up's launches counted apart)."""
    import collections

    from repro_torch.cluster import ClusterSpec, ServingCluster
    from repro_torch.kernels import build
    spec = ClusterSpec(service="real", placement="device", n_replicas=4,
                       n_producers=2, sim_time=3.0, warmup=1.0, speedup=4.0)
    assert spec.device == "cuda"
    cl = ServingCluster(spec)
    cl.warm()
    for wrapper in (mm.matmul, preproc.yuv_to_rgb):
        build.zero_launches(wrapper)
    res = cl.run()
    assert res.completed > 0.8 * res.produced and not res.diverged
    assert 0.0 < res.ai_tax()["ai_fraction"] < 1.0
    n_batches = len(res.batch_spans)
    sizes = collections.Counter(e.meta["batch_size"] for e in res.log.events
                                if e.stage == "identify")
    assert n_batches == round(sum(c / n for n, c in sizes.items())) > 0
    assert mm.matmul.launches == 2 * n_batches
    assert preproc.yuv_to_rgb.launches == n_batches
    tile = sum(1 for n, _ in res.batch_spans if (1 << (n - 1).bit_length()) > 8)
    assert mm.matmul.launches_by_route["tile"] == 2 * tile


# battery shapes of kernels.autotune: skinny and tile matmuls, decode on
# both routes
PLAN_MM_CASES = [(1, 6912, 256, "tanh"), (8, 256, 128, "none"),
                 (64, 6912, 256, "tanh"), (16, 3072, 256, "none")]
PLAN_DECODE_CASES = [(torch.bfloat16, 4, 128, 2048),
                     (torch.float32, 1, 64, 448)]


def _other_plan(cands, formula):
    """A candidate that is not the formula's, to tell a cached plan apart."""
    return next(c for c in reversed(cands) if c != formula)


@pytest.mark.parametrize("M,K,N,epi", PLAN_MM_CASES)
def test_every_matmul_plan_vs_plain_and_the_wrapper_takes_the_cache(
        cuda, autotune_cache, M, K, N, epi):
    g = _gen(0)
    a = torch.randn((M, K), generator=g).to(cuda)
    b = (torch.randn((K, N), generator=g) / K**0.5).to(cuda)
    want = mm.matmul_plain(a, b, epilogue=epi)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = autotune.matmul_candidates(M, K, N, n_sm)
    for plan in cands:
        torch.testing.assert_close(mm.matmul(a, b, epilogue=epi, plan=plan),
                                   want, atol=1e-4, rtol=1e-5)
        assert mm.matmul.last_plan == plan
    mm.matmul(a, b, epilogue=epi)
    assert mm.matmul.last_plan == autotune.matmul_plan(M, K, N, n_sm)
    other = _other_plan(cands, autotune.matmul_formula(M, K, N, n_sm))
    autotune_cache.store(autotune.matmul_key(M, K, N, n_sm), autotune.TuneResult(
        other, 0.0, "measured", len(cands)).to_json())
    torch.testing.assert_close(mm.matmul(a, b, epilogue=epi), want,
                               atol=1e-4, rtol=1e-5)
    assert mm.matmul.last_plan == other


@pytest.mark.parametrize("dtype,G,D,L", PLAN_DECODE_CASES)
def test_every_decode_plan_vs_plain_and_the_wrapper_takes_the_cache(
        cuda, autotune_cache, dtype, G, D, L):
    g = _gen(1)
    B, KV = 8, 8
    q = torch.randn((B, 1, KV * G, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, L, KV, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, L, KV, D), generator=g).to(cuda, dtype)
    lens = torch.tensor([0, 1, L, L // 3, L // 2, 7, L - 1, 33],
                        dtype=torch.int32, device=cuda)
    want = da.decode_attention_plain(q, k, v, kv_len=lens).float()
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = autotune.decode_candidates(L)
    for plan in cands:
        got = da.decode_attention(q, k, v, kv_len=lens, plan=plan)
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
        assert da.decode_attention.last_plan == plan
    dt = str(dtype).replace("torch.", "")
    da.decode_attention(q, k, v, kv_len=lens)
    assert da.decode_attention.last_plan == autotune.decode_plan(
        B, KV, G, D, D, L, dt, n_sm)
    other = _other_plan(cands, {"n_split": da.split_l(B, KV, L, n_sm)})
    autotune_cache.store(autotune.decode_key(B, KV, G, D, D, L, dt, n_sm),
                         autotune.TuneResult(other, 0.0, "measured",
                                             len(cands)).to_json())
    da.decode_attention(q, k, v, kv_len=lens)
    assert da.decode_attention.last_plan == other


@pytest.fixture
def host_mesh(cuda):
    """A world of one over the card (``launch.mesh.make_host_mesh``),
    destroyed after the test."""
    from repro_torch.launch.mesh import destroy, make_host_mesh
    destroy()
    mesh = make_host_mesh(device=cuda)
    yield mesh
    destroy()


def test_host_mesh_is_a_world_of_one_over_the_card(host_mesh):
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    assert dist.get_world_size() == 1 and dist.get_backend() == "nccl"
    assert host_mesh.device_type == "cuda" and host_mesh.size() == 1
    assert host_mesh.mesh_dim_names == ("data", "model")
    x = torch.ones((4, 4), device="cuda")
    with shd.use_sharding(host_mesh, shd.SERVE_RULES):
        assert shd.shard(x, "batch", "embed") is x
        assert not shd.sharded_context()


def test_serve_step_on_the_card_equals_the_direct_path(host_mesh):
    """A two-layer llama3-8b at full width in bf16: prefill and 4 greedy
    decode steps through serve_step on the mesh of one, bit for bit the
    model's own, through the flash and decode kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.serve import serve_step
    cfg = get_config("llama3-8b").replace(n_layers=2)
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    g = _gen(4)
    tok = torch.randint(0, cfg.vocab_size, (4, 64), generator=g).to("cuda")
    sh = serve_step.make_serve_shardings(model, host_mesh, 4, 72)

    def greedy(prefill, decode):
        with torch.inference_mode():
            logits, cache = prefill(params, {"tokens": tok})
            out = [logits]
            for _ in range(4):
                nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
                logits, cache = decode(params, cache, nxt)
                out.append(logits)
        return torch.stack(out)

    direct = greedy(lambda p, b: model.prefill(p, b, cache_len=72),
                    model.decode_step)
    for w in (fa.flash_attention, da.decode_attention):
        build.zero_launches(w)
    got = greedy(serve_step.make_prefill(model, sh, 72),
                 serve_step.make_decode_step(model, sh))
    assert torch.equal(got, direct)
    assert fa.flash_attention.launches == 2
    assert da.decode_attention.launches == 2 * 4
