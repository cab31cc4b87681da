"""The port's distributed-optimization tricks (repro_torch.distributed.
collectives) against the JAX package's, on the CPU: int8 quantization and
error-feedback compression on seeded numpy gradients (int8 payloads equal,
scales within 1 ulp, the residuals within 1 ulp of the largest value),
the distributed log-sum-exp combine, the convergence check of
``tests/test_system.py``, and ``compressed_psum`` on a 4-rank gloo group
(``tests/torch_mesh_worker.py``) against the reference's formula: the
summed int8 payloads of the ranks' ``compress_grads``, times the rank's
own scale, over the world size.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcol

from repro_torch.distributed import collectives as col

ROOT = Path(__file__).resolve().parents[1]


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((16, 8)) * 0.3).astype(np.float32),
            "b": [(rng.standard_normal(8) * 2.0).astype(np.float32)]}


def _ulp_close(a, b, n=1):
    a, b = np.float32(a), np.float32(b)
    return abs(a - b) <= n * np.spacing(max(abs(a), abs(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_equals_the_reference(seed):
    x = _grads(seed)["w"]
    q, s = col.quantize_int8(torch.from_numpy(x))
    jq, js = jcol.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _ulp_close(float(s), float(js))
    np.testing.assert_allclose(
        col.dequantize_int8(q, s).numpy(),
        np.asarray(jcol.dequantize_int8(jq, js)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_compress_grads_with_error_feedback_equals_the_reference(seed):
    g1, g2 = _grads(seed), _grads(seed + 10)
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)      # noqa: E731
    q, s, err = col.compress_grads(to_t(g1), None)
    jq, js, jerr = jcol.compress_grads(jax.tree.map(jnp.asarray, g1), None)
    q2, s2, err2 = col.compress_grads(to_t(g2), err)
    jq2, js2, jerr2 = jcol.compress_grads(jax.tree.map(jnp.asarray, g2),
                                          jerr)
    for got, want in ((q, jq), (q2, jq2)):
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"][0].numpy(),
                                      np.asarray(want["b"][0]))
    for got, want in ((s, js), (s2, js2)):
        assert _ulp_close(float(got["w"]), float(want["w"]))
        assert _ulp_close(float(got["b"][0]), float(want["b"][0]))
    for got, want in ((err, jerr), (err2, jerr2)):
        for a, b in ((got["w"], want["w"]), (got["b"][0], want["b"][0])):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=np.spacing(np.abs(b).max()))


def test_distributed_lse_combine_equals_the_reference_and_full_softmax():
    rng = np.random.default_rng(7)
    scores = rng.standard_normal((3, 4, 64)).astype(np.float32)
    vals = rng.standard_normal((64, 16)).astype(np.float32)
    parts = np.split(np.arange(64), 4)
    m = np.stack([scores[..., p].max(-1) for p in parts], -1)
    l = np.stack([np.exp(scores[..., p] - m[..., i:i + 1]).sum(-1)
                  for i, p in enumerate(parts)], -1)
    o = np.stack([np.exp(scores[..., p] - m[..., i:i + 1]) @ vals[p]
                  for i, p in enumerate(parts)], -2)
    got = col.distributed_lse_combine(*map(torch.from_numpy, (m, l, o)))
    want = jcol.distributed_lse_combine(*map(jnp.asarray, (m, l, o)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    full = torch.softmax(torch.from_numpy(scores), -1) @ torch.from_numpy(vals)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_compressed_gradient_collective_preserves_convergence():
    """int8 EF-compressed gradients: the quadratic still converges (the
    counterpart of ``tests/test_system.py``'s check)."""
    params = torch.tensor([2.0, -3.0, 1.5])
    err = None
    for _ in range(120):
        q, s, err = col.compress_grads({"w": 2 * params}, err)
        params = params - 0.2 * col.dequantize_int8(q["w"], s["w"])
    assert float(torch.sum(params ** 2)) < 1e-2


def test_compressed_psum_on_four_gloo_ranks_equals_the_reference(tmp_path):
    arrays = {}
    for r in range(4):
        g = _grads(20 + r)
        arrays[f"grad{r}"], arrays[f"bias{r}"] = g["w"], g["b"][0]
    np.savez(tmp_path / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(tmp_path), "psum"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads((tmp_path / "result.json").read_text())["psum"]
    # rank 0's result: the ranks' payloads summed, times rank 0's scale
    qs = [jcol.compress_grads({"w": jnp.asarray(arrays[f"grad{r}"]),
                               "b": jnp.asarray(arrays[f"bias{r}"])}, None)
          for r in range(4)]
    for key, name in (("w", "w"), ("b", "b")):
        total = sum(np.asarray(q[0][key]).astype(np.int32) for q in qs)
        want = total.astype(np.float32) * np.asarray(qs[0][1][key]) / 4
        np.testing.assert_allclose(np.asarray(got[name], np.float32), want,
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got["err_w"], np.float32),
                               np.asarray(qs[0][2]["w"]), rtol=0,
                               atol=np.spacing(np.abs(arrays["grad0"]).max()))
