"""RMSNorm and LayerNorm of the port (``models.layers.rmsnorm``,
``layernorm``): without grad, the reference's expressions applied in place
to one float32 copy of x; under grad, the expressions written out (the
port's earlier norms). Their outputs are bit-equal to those expressions, in
bfloat16 and float32, with per-feature and per-head (RWKV's groupnorm)
weights; their gradients within float32 rounding of autograd of those
expressions; and a forward without grad keeps at most one float32 copy of
x live, where the written-out expressions keep three
(``roofline.op_cost``'s count of live bytes).
"""
import numpy as np
import pytest
import torch

from repro_torch.models import layers
from repro_torch.roofline.op_cost import OpCounter


def rms_expr(x, w, eps=1e-6):
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def ln_expr(x, w, b, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * w.float() + b.float()).to(x.dtype)


# (x shape, weight shape): per feature, and per head as the RWKV groupnorm
SHAPES = [((2, 37, 96), (96,)), ((3, 5, 4, 16), (4, 16)),
          ((1, 7, 4096), (4096,))]


def _inputs(shape, wshape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(1.0, 3.0, shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=wshape).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=wshape).astype(np.float32))
    return x.to(dtype), w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wshape", SHAPES)
def test_norm_outputs_are_bit_equal_to_the_expressions(shape, wshape, dtype):
    x, w, b = _inputs(shape, wshape, dtype, seed=len(shape))
    assert torch.equal(layers.rmsnorm(x, w), rms_expr(x, w))
    assert torch.equal(layers.layernorm(x, w, b), ln_expr(x, w, b))
    assert torch.equal(layers.groupnorm_heads(x, w, b, eps=64e-5),
                       ln_expr(x, w, b, eps=64e-5))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("shape,wshape", SHAPES)
def test_norm_gradients_within_float32_rounding(shape, wshape, kind):
    x, w, b = _inputs(shape, wshape, torch.float32, seed=7)
    dy = torch.from_numpy(np.random.default_rng(8).normal(
        size=shape).astype(np.float32))
    args = (x, w) if kind == "rmsnorm" else (x, w, b)
    fn = layers.rmsnorm if kind == "rmsnorm" else layers.layernorm
    expr = rms_expr if kind == "rmsnorm" else ln_expr
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(fn(*leaves), leaves, dy)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(expr(*leaves), leaves, dy)
    for g, e in zip(got, want):
        assert g.shape == e.shape and g.dtype == e.dtype
        assert float((g - e).abs().max()) <= 1e-5 * float(e.abs().max())


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_keeps_one_float32_copy_of_x(kind):
    """The most bytes live at once in a bf16 forward without grad, beyond
    its inputs and its bf16 output: one float32 copy of x and the per-row
    statistics."""
    x, w, b = _inputs((4, 256, 512), (512,), torch.bfloat16, seed=1)
    fn = ((lambda: layers.rmsnorm(x, w)) if kind == "rmsnorm"
          else (lambda: layers.layernorm(x, w, b)))
    expr = ((lambda: rms_expr(x, w)) if kind == "rmsnorm"
            else (lambda: ln_expr(x, w, b)))
    copy = 4 * x.numel()
    with OpCounter() as c:
        out = fn()
    assert c.peak_bytes <= copy + out.nbytes + copy // 8
    with OpCounter() as c:
        out = expr()
    assert c.peak_bytes >= 2 * copy
