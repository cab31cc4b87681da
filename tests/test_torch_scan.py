"""The port's RWKV6 scan (repro_torch.kernels.linear_scan) against the JAX
package.

On the CPU the wrappers take their plain versions: ``rwkv_scan_plain``
(the sequential recurrence in float32) and ``rwkv_decode_step_plain``
(the reference's one-step formula, written into the state in place).
They are held here to the reference's Pallas kernel run in interpret mode
(S a multiple of its 16-step tile), to ``ref.rwkv_scan`` and to the XLA
chunked scan at ragged S, on inputs made from a numpy seed, with decays
``exp(-exp(N(0, 1)))`` spanning (0, 1) and a non-zero bonus u. The CUDA
kernel is held to the plain versions by the ``gpu``-marked tests of
``test_torch_gpu.py`` and by chip_smoke.py on the card.

Tolerances, relative to the largest value compared: float32 1e-5 (the
summation order differs); bfloat16 1e-2 (both sides compute in float32
from the same bf16 inputs and round o to bf16, one bf16 ulp is 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import linear_scan as jax_ls
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops

RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, S, H, K, seed=0):
    """r, w, k, v, u, h0 as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, S, H, K))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, K))))
    k = rng.normal(size=(B, S, H, K)) * 0.3
    v = rng.normal(size=(B, S, H, K))
    u = rng.normal(size=(H, K)) * 0.5
    h0 = rng.normal(size=(B, H, K, K)) * 0.1
    return [a.astype(np.float32) for a in (r, w, k, v, u, h0)]


def _both(arrs, dtype):
    """jax arrays and torch tensors of the same values: r, k, v, u in
    ``dtype`` (rounded once, then shared), w and h0 in float32, as the
    model feeds the scan."""
    r, w, k, v, u, h0 = arrs
    js = [jnp.asarray(a).astype(JNP[dtype]) for a in (r, k, v, u)]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
          for j in js]
    (jr, jk, jv, ju), (tr, tk, tv, tu) = js, ts
    return ((jr, jnp.asarray(w), jk, jv, ju, jnp.asarray(h0)),
            (tr, torch.from_numpy(w), tk, tv, tu, torch.from_numpy(h0)))


def _rel_close(got: torch.Tensor, want, rtol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,with_h0", [(2, 32, 3, 16, True),
                                             (1, 48, 2, 64, False)])
def test_plain_scan_equals_pallas_kernel_in_interpret_mode(B, S, H, K,
                                                           with_h0, dtype):
    (jr, jw, jk, jv, ju, jh), (tr, tw, tk, tv, tu, th) = _both(
        _inputs(B, S, H, K, seed=S), dtype)
    jo, jhf = jax_ls.rwkv_scan(jr, jw, jk, jv, ju, jh if with_h0 else None,
                               interpret=True)
    to, thf = ls.rwkv_scan_plain(tr, tw, tk, tv, tu, th if with_h0 else None)
    assert to.dtype == TORCH[dtype] and thf.dtype == torch.float32
    _rel_close(to, jo, RTOL[dtype])
    _rel_close(thf, jhf, RTOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 37])
def test_plain_scan_equals_reference_and_xla_at_ragged_lengths(S, with_h0,
                                                               dtype):
    (jr, jw, jk, jv, ju, jh), (tr, tw, tk, tv, tu, th) = _both(
        _inputs(2, S, 4, 16, seed=S + 1), dtype)
    jh, th = (jh, th) if with_h0 else (None, None)
    to, thf = ls.rwkv_scan_plain(tr, tw, tk, tv, tu, th)
    for jo, jhf in (jax_ref.rwkv_scan(jr, jw, jk, jv, ju, jh),
                    jax_ops.rwkv_scan(jr, jw, jk, jv, ju, jh, impl="xla")):
        _rel_close(to, jo, RTOL[dtype])
        _rel_close(thf, jhf, RTOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_equals_reference_and_updates_the_state_in_place(dtype):
    (jr, jw, jk, jv, ju, jh), (tr, tw, tk, tv, tu, th) = _both(
        _inputs(3, 1, 4, 16, seed=5), dtype)
    jo, jhn = jax_ops.rwkv_decode_step(jr[:, 0], jw[:, 0], jk[:, 0],
                                       jv[:, 0], ju, jh)
    state = th.clone()
    so, sh = ls.rwkv_scan_plain(tr, tw, tk, tv, tu, th)
    to, out = ops.rwkv_decode_step(tr[:, 0], tw[:, 0], tk[:, 0], tv[:, 0],
                                   tu, state)
    assert out is state                                  # written in place
    _rel_close(to, jo, RTOL[dtype])
    _rel_close(state, jhn, RTOL["float32"])
    _rel_close(to, so[:, 0].float().numpy(), RTOL[dtype])   # the scan, S=1
    _rel_close(state, sh.numpy(), RTOL["float32"])


def test_prefix_then_continuation_equals_the_whole_scan():
    _, (r, w, k, v, u, h0) = _both(_inputs(2, 40, 3, 16, seed=9), "float32")
    o_all, h_all = ops.rwkv_scan(r, w, k, v, u, h0)
    o1, h1 = ops.rwkv_scan(r[:, :23], w[:, :23], k[:, :23], v[:, :23], u, h0)
    o2, h2 = ops.rwkv_scan(r[:, 23:], w[:, 23:], k[:, 23:], v[:, 23:], u, h1)
    _rel_close(torch.cat([o1, o2], dim=1), o_all.numpy(), RTOL["float32"])
    _rel_close(h2, h_all.numpy(), RTOL["float32"])
    # and token by token through the in-place decode step
    state = h1.clone()
    for t in range(23, 40):
        ot, _ = ops.rwkv_decode_step(r[:, t], w[:, t], k[:, t], v[:, t], u,
                                     state)
        _rel_close(ot, o_all[:, t].numpy(), RTOL["float32"])
    _rel_close(state, h_all.numpy(), RTOL["float32"])


def test_state_out_is_written_and_may_be_h0():
    _, (r, w, k, v, u, h0) = _both(_inputs(1, 5, 2, 16, seed=3), "float32")
    want_o, want_h = ls.rwkv_scan_plain(r, w, k, v, u, h0)
    state = h0.clone()
    o, got = ls.rwkv_scan(r, w, k, v, u, state, state_out=state)
    assert got is state
    assert torch.equal(o, want_o) and torch.equal(state, want_h)


def test_cpu_tensors_take_the_plain_scan_and_count_no_launch():
    _, (r, w, k, v, u, h0) = _both(_inputs(1, 4, 2, 16, seed=4), "float32")
    before = ls.rwkv_scan.launches
    ops.rwkv_scan(r, w, k, v, u, h0)
    ops.rwkv_decode_step(r[:, 0], w[:, 0], k[:, 0], v[:, 0], u, h0.clone())
    assert ls.rwkv_scan.launches == before


def test_the_wrapper_rejects_shapes_it_does_not_take():
    _, (r, w, k, v, u, h0) = _both(_inputs(1, 4, 2, 16, seed=4), "float32")
    bad = [(r[..., :8], w, k, v, u, h0),                  # K differs
           (r, w[:, :3], k, v, u, h0),                    # S differs
           (r, w, k, v, u[:1], h0),                       # u (1, K)
           (r, w, k, v, u, h0[..., :8]),                  # h0 (B, H, K, 8)
           (r[:, :0], w[:, :0], k[:, :0], v[:, :0], u, h0)]   # S = 0
    for args in bad:
        with pytest.raises(ValueError):
            ls.rwkv_scan(*args)
    with pytest.raises(ValueError):
        ls.rwkv_scan(r, w, k, v, u, h0,
                     state_out=torch.empty(h0.shape, dtype=torch.float64))
