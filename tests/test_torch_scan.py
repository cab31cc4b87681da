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


# ---- the chunked route (csrc/linear_scan.cu rwkv_chunk_*), emulated -----------

CHUNK, SUB = 64, 16


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 as cvt.rna.tf32.f32 rounds it: to nearest, ties away
    from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo in tf32, to ~2^-22 of x."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_a_split(a, b):
    """a @ b with a carried as tf32 hi + lo and b exact in tf32 (a bf16
    value), as the kernel's two products into one accumulator."""
    hi, lo = _split(a)
    return lo @ b + hi @ b


def _mm_b_split(a, b):
    """a @ b with a rounded to tf32 once and b carried as hi + lo."""
    hi, lo = _split(b)
    a = _tf32(a)
    return a @ lo + a @ hi


def _chunked_scan(r, w, k, v, u, h0):
    """The chunked route's arithmetic in float32 on the CPU: r, k, v hold
    bf16 values (as float32), w, u, h0 float32; (B, S, H, K) layouts as the
    kernel reads them. Returns (o (B, S, H, K) bf16, final state). Its
    three passes: each chunk's suffix-decayed k (step by step within a
    sub-chunk, times the later sub-chunks' whole decays) as tf32 hi + lo
    against v; the carry S_{c+1} = P_c S_c + U_c; the outputs per
    16-step sub-chunk, decays split at sub-chunk boundaries, the diagonal
    block per i in float32, every product with one operand rounded to tf32
    once and the other exact or carried as hi + lo."""
    B, S, H, K = r.shape
    nc = -(-S // CHUNK)

    def chunks(x, fill):
        padded = torch.full((B, nc * CHUNK, H, K), fill, dtype=torch.float32)
        padded[:, :S] = x.float()
        return padded.reshape(B, nc, CHUNK, H, K).permute(0, 3, 1, 2, 4)

    R, W, Kc, Vc = (chunks(r, 0.0), chunks(w, 1.0), chunks(k, 0.0),
                    chunks(v, 0.0))                    # (B, H, nc, C, K)
    # pass 1: U_c and P_c, the decay after j within its sub-chunk, times the
    # whole decays of the later sub-chunks
    kq = torch.empty_like(Kc)
    whole = []
    for p in range(CHUNK // SUB):
        q = torch.ones((B, H, nc, K))
        for j in range(SUB * (p + 1) - 1, SUB * p - 1, -1):
            kq[..., j, :] = Kc[..., j, :] * q
            q = q * W[..., j, :]
        whole.append(q)
    for p in range(CHUNK // SUB):
        after = torch.ones((B, H, nc, K))
        for later in range(CHUNK // SUB - 1, p, -1):
            after = after * whole[later]
        kq[..., SUB * p:SUB * (p + 1), :] *= after[..., None, :]
        if p == 0:
            P = after * whole[0]
    U = _mm_a_split(kq.transpose(-1, -2), Vc)
    # pass 2: the carry
    s = torch.zeros((B, H, K, K)) if h0 is None else h0.float().clone()
    Sc = torch.empty((B, H, nc, K, K))
    for c in range(nc):
        Sc[:, :, c] = s
        s = P[:, :, c, :, None] * s + U[:, :, c]
    # pass 3: the outputs
    rl, kb = torch.empty_like(R), torch.empty_like(Kc)
    wsub = torch.empty((B, H, nc, CHUNK // SUB, K))
    ell = torch.ones((B, H, nc, K))
    for t in range(CHUNK):
        if t % SUB == 0:
            ell = torch.ones((B, H, nc, K))
        rl[..., t, :] = R[..., t, :] * ell
        ell = ell * W[..., t, :]
        if t % SUB == SUB - 1:
            wsub[..., t // SUB, :] = ell
    qb = torch.ones((B, H, nc, K))
    for j in range(CHUNK - 1, -1, -1):
        if j % SUB == SUB - 1:
            qb = torch.ones((B, H, nc, K))
        kb[..., j, :] = Kc[..., j, :] * qb
        qb = qb * W[..., j, :]
    o = torch.empty_like(Vc)
    uf = u.float()[None, :, None, :]
    for qi in range(CHUNK // SUB):
        rows = slice(SUB * qi, SUB * (qi + 1))
        dec = torch.ones((B, H, nc, K))
        for p in range(qi):
            dec = dec * wsub[..., p, :]
        acc = _mm_b_split(rl[..., rows, :] * dec[..., None, :], Sc)
        dec = torch.ones((B, H, nc, K))
        for p in range(qi - 1, -1, -1):
            keys = slice(SUB * p, SUB * (p + 1))
            score = _mm_b_split(rl[..., rows, :] * dec[..., None, :],
                                kb[..., keys, :].transpose(-1, -2))
            acc = acc + _mm_a_split(score, Vc[..., keys, :])
            dec = dec * wsub[..., p, :]
        diag = torch.zeros((B, H, nc, SUB, SUB))
        for t in range(SUB):
            rt = R[..., SUB * qi + t, :]
            diag[..., t, t] = (rt * uf * Kc[..., SUB * qi + t, :]).sum(-1)
            pr = torch.ones((B, H, nc, K))
            for j in range(t - 1, -1, -1):
                diag[..., t, j] = (rt * pr * Kc[..., SUB * qi + j, :]).sum(-1)
                pr = pr * W[..., SUB * qi + j, :]
        o[..., rows, :] = acc + _mm_a_split(diag, Vc[..., rows, :])
    o = o.permute(0, 2, 3, 1, 4).reshape(B, nc * CHUNK, H, K)[:, :S]
    return o.to(torch.bfloat16), s


def _hard_decays(w: np.ndarray, seed: int) -> np.ndarray:
    """w with exact zeros, denormals and exact ones in some steps and
    channels, as w = exp(-exp(z)) gives them in float32."""
    rng = np.random.default_rng(seed)
    w = w.copy()
    for value in (0.0, 1e-40, 1.0):
        w[rng.random(w.shape) < 0.05] = value
    w[:, ::7, :, :3] = 0.0                     # whole channels, every 7th step
    w[:, 3::11, :, 5:9] = 1.0
    return w


CHUNK_S = [1, 15, 16, 17, 63, 64, 65, 130]


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", CHUNK_S)
def test_chunked_emulation_equals_reference(S, with_h0, hard):
    arrs = _inputs(1, S, 2, 64, seed=100 + S)
    if hard:
        arrs[1] = _hard_decays(arrs[1], seed=S)
    (jr, jw, jk, jv, ju, jh), (tr, tw, tk, tv, tu, th) = _both(arrs,
                                                               "bfloat16")
    jh, th = (jh, th) if with_h0 else (None, None)
    to, thf = _chunked_scan(tr, tw, tk, tv, tu, th)
    jo, jhf = jax_ref.rwkv_scan(jr, jw, jk, jv, ju, jh)
    assert bool(torch.isfinite(to.float()).all() and torch.isfinite(thf).all())
    _rel_close(to, jo, RTOL["bfloat16"])
    _rel_close(thf, jhf, RTOL["float32"])


@pytest.mark.parametrize("S", [15, 16, 64])
def test_chunked_emulation_equals_pallas_kernel_in_interpret_mode(S):
    arrs = _inputs(1, S, 2, 64, seed=200 + S)
    arrs[1] = _hard_decays(arrs[1], seed=S + 1)
    (jr, jw, jk, jv, ju, jh), (tr, tw, tk, tv, tu, th) = _both(arrs,
                                                               "bfloat16")
    jo, jhf = jax_ls.rwkv_scan(jr, jw, jk, jv, ju, jh, interpret=True)
    to, thf = _chunked_scan(tr, tw, tk, tv, tu, th)
    _rel_close(to, jo, RTOL["bfloat16"])
    _rel_close(thf, jhf, RTOL["float32"])


def test_chunked_emulation_needs_the_hi_lo_split_of_the_state_product():
    """One tf32 rounding of the decayed k would put the state past 1e-5 of
    the largest: the split is what holds it."""
    arrs = _inputs(1, 130, 2, 64, seed=7)
    _, (r, w, k, v, u, h0) = _both(arrs, "bfloat16")
    _, want = ls.rwkv_scan_plain(r, w, k, v, u, h0)
    _, got = _chunked_scan(r, w, k, v, u, h0)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    B, S, H, K = r.shape
    s = h0.clone()
    for c in range(-(-S // CHUNK)):                    # hi alone
        sl = slice(CHUNK * c, min(S, CHUNK * (c + 1)))
        kc, wc, vc = k[:, sl].float(), w[:, sl], v[:, sl].float()
        q = torch.ones((B, H, K))
        kq = torch.empty_like(kc)
        for j in range(kc.shape[1] - 1, -1, -1):
            kq[:, j] = kc[:, j] * q
            q = q * wc[:, j]
        s = q[..., None] * s + torch.einsum("bjhk,bjhv->bhkv", _tf32(kq), vc)
    assert (s - want).abs().max() > 1e-5 * scale


def test_route_sends_bf16_prefills_at_width_64_to_the_chunked_scan():
    assert ls._route(torch.bfloat16, 64, 64, 1024) == "chunk"
    assert ls._route(torch.bfloat16, 64, 64, ls.CHUNK_MIN_S) == "chunk"
    # short prompts: the chunked route's fixed cost passes the serial one's
    assert ls._route(torch.bfloat16, 64, 64, ls.CHUNK_MIN_S - 1) == "serial"
    assert ls._route(torch.bfloat16, 64, 64, 2) == "serial"
    assert ls._route(torch.bfloat16, 64, 64, 1) == "serial"     # decode step
    assert ls._route(torch.float32, 64, 64, 1024) == "serial"   # held to 1e-5
    assert ls._route(torch.bfloat16, 16, 16, 1024) == "serial"  # smoke width
    assert ls._route(torch.float32, 16, 16, 37) == "serial"
    for dtype, K, V in ((torch.float16, 64, 64), (torch.bfloat16, 32, 32),
                        (torch.bfloat16, 64, 16)):
        with pytest.raises(ValueError):
            ls._route(dtype, K, V, 64)
