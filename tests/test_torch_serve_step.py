"""The port's serving steps under shardings (repro_torch.serve.serve_step)
on the CPU.

  * Without a mesh of more than one device, ``make_prefill`` and
    ``make_decode_step`` are ``Model.prefill`` / ``decode_step`` bit for
    bit (a shape-only mesh, as the reference's spec tests use, leaves
    every tensor plain).
  * ``make_serve_shardings`` lays every parameter and cache leaf out by
    the serve rules: the llama3-8b cache at batch 128 and 32,768
    positions is sequence-sharded over the model axis, the weights over
    (data, model), the logits of ``placed_decode_step`` by ("batch",
    "vocab").
  * On a 4-rank gloo (2, 2) mesh (``tests/torch_mesh_worker.py``), the
    llama3-8b smoke config in float32: the prefill and 4 greedy decode
    steps give logits within 1e-5 of the unsharded ones and the same
    tokens, the sequence-sharded cache written shard by shard equals the
    unsharded cache.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import Model
from repro_torch.serve import serve_step

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _smoke(arch="llama3-8b"):
    cfg = configs.get_config(arch, smoke=True).replace(dtype="float32")
    return cfg, Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b",
                                  "granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_steps_without_a_device_mesh_are_the_models_bit_for_bit(arch):
    cfg, model = _smoke(arch)
    params = model.init(0)
    sh = serve_step.make_serve_shardings(
        model, _FakeMesh({"data": 2, "model": 2}), 2, 16)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)))
    with torch.no_grad():
        l0, c0 = model.prefill(params, {"tokens": tok}, cache_len=16)
        l1, c1 = serve_step.make_prefill(model, sh, 16)(params,
                                                        {"tokens": tok})
        assert torch.equal(l0, l1)
        step = serve_step.make_decode_step(model, sh)
        for _ in range(3):
            t = l0.argmax(-1, keepdim=True)
            l0, c0 = model.decode_step(params, c0, t)
            l1, c1 = step(params, c1, t)
            assert torch.equal(l0, l1)
    for name, leaf in c0["blocks"].items():
        assert torch.equal(leaf, c1["blocks"][name])


def test_serve_shardings_follow_the_serve_rules():
    cfg = configs.get_config("llama3-8b")
    model = Model(cfg, device="cpu")
    mesh = _FakeMesh({"data": 16, "model": 16})
    sh = serve_step.make_serve_shardings(model, mesh, 128, 32768)
    assert sh.rules == shd.SERVE_RULES
    assert sh.cache["blocks"]["k"].spec == (None, "data", "model")
    assert sh.cache["cur_len"].spec == ()
    mix = sh.params["blocks"][0]["mix"]
    assert mix["wq"].spec == ("data", "model")
    assert mix["wk"].spec == ("data", "model")     # 8 x 128 = 1,024 wide
    assert sh.params["embed"]["tok"].spec == ("model", "data")
    assert sh.params["ln_f"]["w"].spec == ()
    repl = serve_step.make_serve_shardings(
        model, mesh, 128, 32768,
        rules=dict(shd.SERVE_RULES, embed=None))     # serve_repl_w
    assert repl.params["blocks"][0]["mix"]["wq"].spec == (None, "model")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve")
    cfg, _ = _smoke()
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (4, 12))
    np.savez(out / "inputs.npz", tokens=toks.astype(np.int64))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(out), "serve"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / "result.json").read_text())["serve"]


def test_sharded_prefill_and_decode_equal_the_unsharded(served):
    assert len(served["logit_errs"]) == 5
    assert max(served["logit_errs"]) <= 1e-5, served["logit_errs"]
    assert served["same_tokens"]
    assert served["cur_len"] == 12 + 4


def test_sequence_sharded_cache_is_written_shard_by_shard(served):
    # (n, B, L, KV, D): batch over data, positions over model
    assert served["cache_layout"]["k"] == ["Shard(dim=1)", "Shard(dim=2)"]
    assert served["cache_layout"]["v"] == ["Shard(dim=1)", "Shard(dim=2)"]
    assert served["cache_err"] <= 1e-5
    assert served["logits_layout"] == ["Shard(dim=0)", "Shard(dim=1)"]
