"""The Mamba scan's CUDA routes, emulated in NumPy float32 on the CPU.

The segmented route (``csrc/linear_scan.cu`` ``mamba_segmented_kernel``)
cuts S into ``linear_scan.MAMBA_SEGMENTS`` segments of ceil(S / segments)
steps: each segment is scanned from a zero state beside the sum of its step
sizes, its decay is exp(A * that sum) (never a quotient of prefix products),
the segments' end states are carried in order, h_in(s + 1) = P(s) h_in(s) +
h_end(s), and each segment is replayed from its incoming state with y summed
in four partial sums over n % 4. Its exponentials are 2^(delta a) with
a = A log2(e) rounded to float32 once, on the SFU's ex2.approx (2 ulp):
the emulation takes numpy's exp2, and one test moves every such value
2 ulp at random to show that float32 still holds 1e-5. The step route
(``mamba_step_kernel``) gives each channel four lanes of four state
values and sums y as ((p0 + p1) + (p2 + p3)). The emulations below follow
that arithmetic and are held at 1e-5 of the largest y and state to
``repro.kernels.ref`` and to the Pallas kernel in interpret mode (its
16-step tiles and 128 lanes), on
inputs made from a numpy seed: step sizes softplus(N(0, 1)), A =
-exp(N(0, 0.5)), a random initial state; and with hard decays, step sizes
of 100 in about 5% of the elements, so that exp(delta A) is 0 or a
denormal there. The kernels themselves are held to the plain versions by
the ``gpu``-marked tests of ``test_torch_gpu.py`` and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import linear_scan as jax_ls
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.kernels import linear_scan as ls

RTOL = 1e-5
N = ls.MAMBA_SEG_WIDTH


def _inputs(B, S, Di, seed, hard=False):
    """float32 numpy delta, A, Bt, Ct, x, h0; ``hard``: delta = 100 in
    about 5% of its elements (delta |A| up to ~500)."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(size=(B, S, Di))))
    if hard:
        delta[rng.random(delta.shape) < 0.05] = 100.0
    A = -np.exp(0.5 * rng.normal(size=(Di, N)))
    Bt, Ct = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    x = rng.normal(size=(B, S, Di))
    h0 = 0.5 * rng.normal(size=(B, Di, N))
    return [a.astype(np.float32) for a in (delta, A, Bt, Ct, x, h0)]


def _close(got: np.ndarray, want, rtol=RTOL):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _step(h, d, dx, A, Bt, exp=np.exp):
    """One step of every (b, channel, n): exp(d A) h + (d x) B_t, or with
    ``exp`` = exp2 and A log2(e) for A, 2^(d A log2 e) h + (d x) B_t."""
    return exp(d[..., None] * A[None]) * h + dx[..., None] * Bt[:, None, :]


def _off_by_ulps(rng, ulps: int):
    """2^x in float32, moved ``ulps`` ulp up or down at random (none for
    0): the SFU approximation's documented error, at its worst."""
    def exp2(x):
        y = np.exp2(x)
        for _ in range(ulps):
            up = rng.random(y.shape) < 0.5
            y = np.where(up, np.nextafter(y, np.float32(np.inf)),
                         np.nextafter(y, np.float32(0)))
        return y.astype(np.float32)
    return exp2


def _segmented_scan(delta, A, Bt, Ct, x, h0, segments=ls.MAMBA_SEGMENTS,
                    exp2=np.exp2):
    """The segmented route's arithmetic: returns (y (B, S, Di), final
    state (B, Di, N)), with the segment decays and end states."""
    B, S, Di = delta.shape
    a = A * np.float32(np.log2(np.e))         # once, rounded to float32
    length = -(-S // segments)
    bounds = [(t, min(S, t + length)) for t in range(0, S, length)]
    dx = delta * x
    # (a) each segment from a zero state, and its summed step sizes
    decays, ends = [], []
    for t0, t1 in bounds:
        h = np.zeros((B, Di, N), np.float32)
        sumd = np.zeros((B, Di), np.float32)
        for t in range(t0, t1):
            h = _step(h, delta[:, t], dx[:, t], a, Bt[:, t], exp2)
            sumd = sumd + delta[:, t]
        decays.append(exp2(a[None] * sumd[..., None]))
        ends.append(h)
    # (b) the carry, segment by segment from h0
    h = np.zeros((B, Di, N), np.float32) if h0 is None else h0
    incoming = []
    for p, e in zip(decays, ends):
        incoming.append(h)
        h = p * h + e
    # (c) the replay: y in four partial sums over n % 4
    y = np.empty((B, S, Di), np.float32)
    for (t0, t1), h in zip(bounds, incoming):
        for t in range(t0, t1):
            h = _step(h, delta[:, t], dx[:, t], a, Bt[:, t], exp2)
            terms = h * Ct[:, t, None, :]
            acc = [np.zeros((B, Di), np.float32) for _ in range(4)]
            for n in range(N):
                acc[n % 4] = acc[n % 4] + terms[..., n]
            y[:, t] = (acc[0] + acc[1]) + (acc[2] + acc[3])
    return y, h, decays, ends


def _lane_split_step(delta, A, Bt, Ct, x, h):
    """The step route's arithmetic, delta, x (B, Di), Bt, Ct (B, N): lane q
    of a channel holds n = 4q .. 4q + 3 and its partial dot product
    (h0 c0 + h1 c1) + (h2 c2 + h3 c3); y = (p0 + p1) + (p2 + p3)."""
    h = _step(h, delta, delta * x, A, Bt)
    terms = (h * Ct[:, None, :]).reshape(*h.shape[:2], 4, 4)
    parts = (terms[..., 0] + terms[..., 1]) + (terms[..., 2] + terms[..., 3])
    return (parts[..., 0] + parts[..., 1]) + (parts[..., 2] + parts[..., 3]), h


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# S: fewer steps than segments, one a segment, ragged lengths no segment
# count divides, and the prefill-like 130
SEG_S = [2, 3, 16, 17, 37, 50, 130]


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", SEG_S)
def test_segmented_emulation_equals_reference(S, with_h0, hard):
    delta, A, Bt, Ct, x, h0 = _inputs(2, S, 24, seed=300 + S, hard=hard)
    h0 = h0 if with_h0 else None
    y, h, _, _ = _segmented_scan(delta, A, Bt, Ct, x, h0)
    jy, jh = jax_ref.mamba_scan(*_jax(delta, A, Bt, Ct, x, h0))
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("S", [16, 48])
def test_segmented_emulation_equals_pallas_kernel_in_interpret_mode(S):
    delta, A, Bt, Ct, x, h0 = _inputs(1, S, 128, seed=400 + S, hard=True)
    jy, jh = jax_ls.mamba_scan(*_jax(delta, A, Bt, Ct, x, h0), interpret=True)
    y, h, _, _ = _segmented_scan(delta, A, Bt, Ct, x, h0)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("S,hard", [(130, False), (130, True), (1024, True)])
def test_segmented_emulation_holds_float32_with_the_sfu_error(S, hard):
    """Every 2^x of the scan, the replay and the segment decays 2 ulp off
    (the ex2.approx bound, at its worst): y and the state still within
    1e-5 of the largest, also with decays of 0 and denormals."""
    delta, A, Bt, Ct, x, h0 = _inputs(1, S, 16, seed=500 + S, hard=hard)
    exp2 = _off_by_ulps(np.random.default_rng(S), ulps=2)
    y, h, _, _ = _segmented_scan(delta, A, Bt, Ct, x, h0, exp2=exp2)
    jy, jh = jax_ref.mamba_scan(*_jax(delta, A, Bt, Ct, x, h0))
    _close(y, jy)
    _close(h, jh)


def test_hard_decays_give_zero_and_denormal_segment_decays():
    """The hard case reaches what the kernel must survive: exp(delta A) of
    exactly 0 and denormals in single steps, and whole-segment decays of 0,
    which a quotient of prefix products would turn into 0 / 0."""
    delta, A, Bt, Ct, x, h0 = _inputs(2, 130, 24, seed=7, hard=True)
    steps = np.exp(delta[..., None] * A[None, None])
    tiny = np.finfo(np.float32).tiny
    assert (steps == 0).any() and ((steps > 0) & (steps < tiny)).any()
    _, _, decays, _ = _segmented_scan(delta, A, Bt, Ct, x, h0)
    assert any((p == 0).any() for p in decays)
    y, h, _, _ = _segmented_scan(delta, A, Bt, Ct, x, h0)
    jy, jh = jax_ref.mamba_scan(*_jax(delta, A, Bt, Ct, x, h0))
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("hard", [False, True])
def test_lane_split_step_emulation_equals_reference(hard):
    delta, A, Bt, Ct, x, h0 = _inputs(8, 1, 64, seed=11, hard=hard)
    y, h = _lane_split_step(delta[:, 0], A, Bt[:, 0], Ct[:, 0], x[:, 0], h0)
    jy, jh = jax_ops.mamba_decode_step(
        *_jax(delta[:, 0], A, Bt[:, 0], Ct[:, 0], x[:, 0], h0))
    _close(y, jy)
    _close(h, jh)
    sy, sh = jax_ref.mamba_scan(*_jax(delta, A, Bt, Ct, x, h0))
    _close(y, np.asarray(sy)[:, 0])
    _close(h, sh)


def test_mamba_route_sends_prefills_to_segmented_and_steps_to_step():
    for dtype in (torch.bfloat16, torch.float32):
        assert ls._mamba_route(dtype, 16, 1) == "step"
        assert ls._mamba_route(dtype, 16, ls.MAMBA_SEG_MIN_S) == "segmented"
        assert ls._mamba_route(dtype, 16, 1024) == "segmented"
        for S in range(2, ls.MAMBA_SEG_MIN_S):          # short prompts
            assert ls._mamba_route(dtype, 16, S) == "serial"
        # the smoke config's state size stays on the serial kernel
        for S in (1, 2, 37, 1024):
            assert ls._mamba_route(dtype, 4, S) == "serial"
    for dtype, n in ((torch.float16, 16), (torch.float64, 16),
                     (torch.bfloat16, 8), (torch.float32, 32)):
        with pytest.raises(ValueError):
            ls._mamba_route(dtype, n, 64)


def test_plain_scan_on_each_ranks_shards_under_a_two_by_four_mesh(tmp_path):
    """On an 8-rank gloo (2, 4) mesh (``tests/torch_mesh_worker.py``), the
    plain scan on DTensors laid out as the model lays them out runs on each
    rank's shard of the batch and of the inner dim (y comes back sharded so)
    and, gathered, gives the whole scan's y, final state and gradients of
    every input on one device, within 1e-6 of each largest value (the
    gradients of Bt, Ct and A add the ranks' shares in another order)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    B, S, Di = 4, 37, 32
    delta, A, Bt, Ct, x, h0 = _inputs(B, S, Di, seed=5)
    rng = np.random.default_rng(6)
    dy = rng.normal(size=(B, S, Di)).astype(np.float32)
    dh = rng.normal(size=(B, Di, N)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **{
        f"mamba/{k}": v for k, v in (("delta", delta), ("A", A), ("Bt", Bt),
                                     ("Ct", Ct), ("x", x), ("h0", h0),
                                     ("dy", dy), ("dh", dh))})
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, str(root / "tests" / "torch_mesh_worker.py"),
         "--world", "8", str(tmp_path), "mamba_scan"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    got = json.loads((tmp_path / "result.json").read_text())["mamba_scan"]
    assert got.pop("y_placements") == ["S(0)", "S(2)"]
    assert len(got) == 8 and max(got.values()) <= 1e-6, got
