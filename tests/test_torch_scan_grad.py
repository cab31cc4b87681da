"""The gradients of the RWKV6 and Mamba scans on the CPU.

``linear_scan.mamba_scan_bwd_plain`` and ``rwkv_scan_bwd_plain`` write out
the formulas of the backward kernels (``csrc/linear_scan_bwd.cu``: the
adjoint of the state walked backwards, the inputs' gradients from it). They
are held here, in float32 at 1e-5 of each largest gradient, to torch
autograd of the plain forwards, and to ``jax.grad`` of the reference's
XLA scans (``repro.kernels.ops.mamba_scan`` / ``rwkv_scan`` with
``impl="xla"``, the chunked associative scans the JAX package trains
through) and of ``repro.kernels.ref``; on inputs made from a numpy seed,
with a ragged S, a non-zero initial state and a final-state gradient, and
with decays of 0 and denormals. ``MambaScanFn`` and ``RwkvScanFn`` (the
autograd Functions the wrappers take under grad on the card) run here
through their plain branch and give the same gradients. The kernels
themselves are held to the formulas by the ``gpu``-marked tests of
``test_torch_gpu.py`` and by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.kernels import linear_scan as ls

RTOL = 1e-5
MAMBA_NAMES = ("delta", "A", "Bt", "Ct", "x", "h0")
RWKV_NAMES = ("r", "w", "k", "v", "u", "h0")


def _mamba_inputs(B, S, Di, N, seed, hard=False):
    """float32 numpy delta, A, Bt, Ct, x, h0, dy, dh; ``hard``: delta = 100
    in about 5% of its elements, so that exp(delta A) is 0 or a denormal."""
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


def _rwkv_inputs(B, S, H, K, seed, hard=False):
    """float32 numpy r, w, k, v, u, h0, do, dh with decays exp(-exp(N(0,
    1))); ``hard``: w exactly 0, a denormal (1e-40) or 1 in about 5% of its
    values each."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, K))))
    if hard:
        u = rng.random(w.shape)
        w[u < 0.05] = 0.0
        w[(u >= 0.05) & (u < 0.10)] = 1e-40
        w[(u >= 0.10) & (u < 0.15)] = 1.0
    u = 0.5 * rng.normal(size=(H, K))
    h0 = 0.1 * rng.normal(size=(B, H, K, K))
    do, dh = rng.normal(size=(B, S, H, K)), rng.normal(size=(B, H, K, K))
    return [a.astype(np.float32) for a in (r, w, k, v, u, h0, do, dh)]


def _close(got, want, name, rtol=RTOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"d{name}: {err} against {scale}"


def _torch_grads(fn, arrays, dy, dh):
    """torch autograd of ``fn`` at float32 leaves: sum(y dy) + sum(h dh)."""
    leaves = [None if a is None else torch.tensor(a, requires_grad=True)
              for a in arrays]
    y, h = fn(*leaves)
    loss = (y * torch.tensor(dy)).sum()
    if dh is not None:
        loss = loss + (h * torch.tensor(dh)).sum()
    live = [t for t in leaves if t is not None]
    return torch.autograd.grad(loss, live)


def _jax_grads(fn, arrays, dy, dh):
    """jax.grad of ``fn`` the same way (h0 None where ``arrays`` has it)."""
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def loss(*live):
        args = list(arrays)
        for i, a in zip(idx, live):
            args[i] = a
        y, h = fn(*args)
        out = jnp.sum(y * dy)
        return out if dh is None else out + jnp.sum(h * dh)
    live = [jnp.asarray(arrays[i]) for i in idx]
    return jax.grad(loss, argnums=tuple(range(len(live))))(*live)


# (B, S, width, state, with h0 and a final-state gradient, hard decays)
MAMBA_CASES = {"ragged": (2, 37, 6, 4, False, False),
               "h0_and_dh": (2, 21, 8, 16, True, False),
               "one_step": (3, 1, 5, 4, True, False),
               "zero_and_denormal_decays": (2, 40, 8, 16, True, True)}
RWKV_CASES = {"ragged": (2, 37, 2, 8, False, False),
              "h0_and_dh": (2, 21, 3, 4, True, False),
              "one_step": (3, 1, 2, 4, True, False),
              "zero_denormal_and_unit_decays": (2, 40, 2, 8, True, True)}


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_bwd_plain_vs_torch_autograd(case):
    B, S, Di, N, with_h0, hard = MAMBA_CASES[case]
    *ins, dy, dh = _mamba_inputs(B, S, Di, N, seed=S, hard=hard)
    if not with_h0:
        ins[5], dh = None, None
    t = [None if a is None else torch.tensor(a) for a in ins]
    got = [g for g in ls.mamba_scan_bwd_plain(
        *t, torch.tensor(dy), None if dh is None else torch.tensor(dh))
        if g is not None]
    want = _torch_grads(ls.mamba_scan_plain, ins, dy, dh)
    for name, g, w in zip(MAMBA_NAMES, got, want):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_bwd_plain_vs_jax_grad(case, impl):
    B, S, Di, N, with_h0, hard = MAMBA_CASES[case]
    *ins, dy, dh = _mamba_inputs(B, S, Di, N, seed=S, hard=hard)
    if not with_h0:
        ins[5], dh = None, None
    t = [None if a is None else torch.tensor(a) for a in ins]
    got = [g for g in ls.mamba_scan_bwd_plain(
        *t, torch.tensor(dy), None if dh is None else torch.tensor(dh))
        if g is not None]
    fn = ((lambda *a: jax_ops.mamba_scan(*a, impl="xla", chunk=16))
          if impl == "xla" else jax_ref.mamba_scan)
    want = _jax_grads(fn, ins, dy, dh)
    for name, g, w in zip(MAMBA_NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("case", sorted(RWKV_CASES))
def test_rwkv_bwd_plain_vs_torch_autograd(case):
    B, S, H, K, with_h0, hard = RWKV_CASES[case]
    *ins, do, dh = _rwkv_inputs(B, S, H, K, seed=S, hard=hard)
    if not with_h0:
        ins[5], dh = None, None
    t = [None if a is None else torch.tensor(a) for a in ins]
    got = [g for g in ls.rwkv_scan_bwd_plain(
        *t, torch.tensor(do), None if dh is None else torch.tensor(dh))
        if g is not None]
    want = _torch_grads(ls.rwkv_scan_plain, ins, do, dh)
    for name, g, w in zip(RWKV_NAMES, got, want):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("case", sorted(RWKV_CASES))
def test_rwkv_bwd_plain_vs_jax_grad(case, impl):
    B, S, H, K, with_h0, hard = RWKV_CASES[case]
    *ins, do, dh = _rwkv_inputs(B, S, H, K, seed=S, hard=hard)
    if not with_h0:
        ins[5], dh = None, None
    t = [None if a is None else torch.tensor(a) for a in ins]
    got = [g for g in ls.rwkv_scan_bwd_plain(
        *t, torch.tensor(do), None if dh is None else torch.tensor(dh))
        if g is not None]
    fn = ((lambda *a: jax_ops.rwkv_scan(*a, impl="xla", chunk=16))
          if impl == "xla" else jax_ref.rwkv_scan)
    want = _jax_grads(fn, ins, do, dh)
    for name, g, w in zip(RWKV_NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_autograd_functions_take_their_plain_branch_on_the_cpu(kind):
    """MambaScanFn and RwkvScanFn on CPU tensors: the plain forward and the
    plain formulas as their backward, the same outputs and gradients as
    autograd of the plain forward (bf16 inputs, as the model feeds them)."""
    if kind == "mamba":
        *ins, dy, dh = _mamba_inputs(2, 19, 8, 4, seed=3)
        fn, plain, wrapper = ls.MambaScanFn, ls.mamba_scan_plain, ls.mamba_scan
    else:
        *ins, dy, dh = _rwkv_inputs(2, 19, 2, 8, seed=3)
        fn, plain, wrapper = ls.RwkvScanFn, ls.rwkv_scan_plain, ls.rwkv_scan
    # float32 A (as the wrapper widens it) or w, and h0; the rest bf16
    ts = [torch.tensor(a) if i in (1, 5) else torch.tensor(a).bfloat16()
          for i, a in enumerate(ins)]
    grads = []
    for call in (fn.apply, plain, wrapper):
        leaves = [t.clone().requires_grad_() for t in ts]
        y, h = call(*leaves)
        loss = ((y.float() * torch.tensor(dy)).sum()
                + (h * torch.tensor(dh)).sum())
        grads.append((y.detach(), h.detach(),
                      torch.autograd.grad(loss, leaves)))
    (y0, h0, g0), (y1, h1, g1), (y2, h2, g2) = grads
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    assert torch.equal(y2, y1) and torch.equal(h2, h1)
    names = MAMBA_NAMES if kind == "mamba" else RWKV_NAMES
    for name, a, b in zip(names, g0, g1):
        assert a.dtype == b.dtype, name
        # bf16 gradients: autograd rounds its intermediate products to bf16,
        # the formulas round once at the end
        _close(a.float(), b.float().numpy(), name,
               rtol=RTOL if a.dtype == torch.float32 else 2e-2)
    for a, b in zip(g2, g1):
        assert torch.equal(a, b)


def test_backward_wrappers_check_their_shapes():
    *ins, dy, dh = _mamba_inputs(1, 5, 4, 4, seed=1)
    t = [torch.tensor(a) for a in ins]
    with pytest.raises(ValueError, match="do not fit"):
        ls.mamba_scan_bwd(*t, torch.zeros(1, 4, 4))
    *ins, do, dh = _rwkv_inputs(1, 5, 2, 4, seed=1)
    t = [torch.tensor(a) for a in ins]
    with pytest.raises(ValueError, match="do not fit"):
        ls.rwkv_scan_bwd(*t, torch.tensor(do), torch.zeros(1, 2, 4, 3))
