"""The port's logical-axis sharding (repro_torch.distributed.sharding,
launch.mesh, the axes of every parameter and cache leaf, the sharded train
step and elastic restore) against the JAX package, on the CPU.

  * ``spec_for`` on the cases of ``tests/test_sharding.py``, compared with
    ``tuple()`` of the reference's ``PartitionSpec``;
  * every parameter and cache leaf of all ten archs at full size
    (metadata only) under the train and serve rules of the ``baseline``,
    ``attn_q`` and ``seq_data_cache`` variants, on shape-only 16x16 and
    2x16x16 meshes: the port's spec equals the reference's
    ``tree_shardings`` spec (the reference's stacked leaves carry a
    leading None the port's per-layer lists do not; its cache leaves are
    reached through ``transformer.cache_names``, as ``cache_by_pattern``
    maps them);
  * in subprocesses (a process group is process-global): a mesh of one
    keeps tensors plain; on a 4-rank gloo (2, 2) mesh
    (``tests/torch_mesh_worker.py``), one AdamW step of the llama3-8b
    smoke config in float32 sharded under the train rules equals the
    unsharded port step and the reference's single-device step at the
    reference's atol = rtol = 2e-5, an unsharded checkpoint restores
    onto the mesh equal, and a dim split over ("pod", "data") takes
    JAX's block order.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jshd
from repro.launch import variants as jvariants
from repro.models.model import build_model as jax_build_model
from repro.train import optimizer as jax_opt

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import variants
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    """Shape-only mesh stand-in for spec_for tests."""
    def __init__(self, shape):
        self.shape = shape


SPEC_CASES = [
    ({"data": 4, "model": 8}, "TRAIN", ("embed", "mlp"), (64, 128)),
    ({"data": 4, "model": 16}, "TRAIN", ("embed", "heads"), (64, 40)),
    ({"data": 4, "model": 16}, "SERVE", (None, "kv_seq", "kv_heads", None),
     (8, 1024, 8, 128)),
    ({"data": 4, "model": 16}, "TRAIN", ("experts", "embed", "mlp"),
     (160, 64, 1536)),
    ({"pod": 2, "data": 16, "model": 16}, "TRAIN", ("batch", None),
     (256, 128)),
    ({"pod": 2, "data": 16, "model": 16}, "SERVE",
     ("batch", "kv_seq", "kv_heads", None), (128, 32768, 8, 128)),
]


@pytest.mark.parametrize("sizes,rules,axes,shape", SPEC_CASES)
def test_spec_for_equals_the_reference(sizes, rules, axes, shape):
    mesh = _FakeMesh(sizes)
    want = jshd.spec_for(axes, shape, mesh, getattr(jshd, f"{rules}_RULES"))
    got = shd.spec_for(axes, shape, mesh, getattr(shd, f"{rules}_RULES"))
    assert got == tuple(want)


def test_rules_and_variants_are_the_references():
    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.SERVE_RULES == jshd.SERVE_RULES
    assert set(variants.VARIANTS) == set(jvariants.VARIANTS)
    for name, v in variants.VARIANTS.items():
        w = jvariants.VARIANTS[name]
        assert (v.train_rules, v.serve_rules, v.model_overrides) == \
            (w.train_rules, w.serve_rules, w.model_overrides)


def test_shard_outside_a_context_or_on_a_shape_only_mesh_is_identity():
    x = torch.ones((4, 4))
    assert shd.shard(x, "batch", None) is x
    with shd.use_sharding(_FakeMesh({"data": 2, "model": 2}),
                          shd.TRAIN_RULES):
        assert shd.shard(x, "batch", None) is x
        assert not shd.sharded_context()
    assert shd.active() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")
    assert shd.placements((("pod", "data"), None, "model"), 3, Named()) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.placements((), 2, Named()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        shd.placements((None, None, "data"), 2, Named())


def _ref_mesh(sizes: dict) -> Mesh:
    n = int(np.prod(list(sizes.values())))
    devs = np.array([jax.devices()[0]] * n).reshape(tuple(sizes.values()))
    return Mesh(devs, tuple(sizes))


def _port_param_specs(model, mesh, rules):
    sh = shd.tree_shardings(model.param_axes(), model.abstract_params(),
                            mesh, rules)
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        else:
            out[path] = tree.spec
    walk(sh, "")
    return out


def _ref_param_specs(cfg, jm, mesh, rules):
    """path in the port's layout -> the reference's spec (a stacked leaf
    of layer ``r * n_pat + j`` has its leading None dropped)."""
    sh = jshd.tree_shardings(jm.param_axes(), jm.abstract_params(), mesh,
                             rules)
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    out = {}
    n_pat = len(cfg.block_pattern)
    for path, s in flat:
        keys = [p.key for p in path]
        spec = tuple(s.spec)
        if keys[0] == "blocks":
            j = int(keys[1][1:])
            for r in range(cfg.n_repeats):
                out["/blocks/" + str(r * n_pat + j) + "/"
                    + "/".join(keys[2:])] = spec[1:]
        elif keys[0] in ("enc", "dec"):
            depth = cfg.n_enc_layers if keys[0] == "enc" else cfg.n_layers
            for i in range(depth):
                out[f"/{keys[0]}/{i}/" + "/".join(keys[1:])] = spec[1:]
        else:
            out["/" + "/".join(keys)] = spec
    return out


def _cache_specs(cfg, model, jm, pmesh, jmesh, prules, jrules):
    """(port spec, reference spec) of every cache leaf at batch 128 and a
    32,768-long cache."""
    B, L = 128, 32768
    port = shd.tree_shardings(model.cache_axes(), model.abstract_cache(B, L),
                              pmesh, prules)
    ref = jshd.tree_shardings(jm.cache_axes(), jm.abstract_cache(B, L),
                              jmesh, jrules)
    pairs = [(port["cur_len"].spec, tuple(ref["cur_len"].spec))]
    if cfg.encdec:
        for n in ("k", "v", "xk", "xv"):
            pairs.append((port["dec"][n].spec, tuple(ref["dec"][n].spec)))
        return pairs
    for j, spec in enumerate(cfg.block_pattern):
        for ref_name, leaf in tf.cache_names(cfg, spec).items():
            pairs.append((port["blocks"][leaf].spec,
                          tuple(ref["blocks"][f"l{j}"][ref_name].spec)))
    return pairs


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("variant", ["baseline", "attn_q", "seq_data_cache"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_leaf_has_the_references_spec(arch, mesh_name, variant):
    cfg = configs.get_config(arch)
    model = Model(cfg, device="cpu")
    jm = jax_build_model(jax_get_config(arch))
    sizes = MESHES[mesh_name]
    pmesh, jmesh = _FakeMesh(sizes), _ref_mesh(sizes)
    pv, jv = variants.get_variant(variant), jvariants.get_variant(variant)
    for prules, jrules in ((pv.train_rules, jv.train_rules),
                           (pv.serve_rules, jv.serve_rules)):
        got = _port_param_specs(model, pmesh, prules)
        want = _ref_param_specs(cfg, jm, jmesh, jrules)
        assert got.keys() == want.keys()
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        assert not bad, list(bad.items())[:5]
        for g, w in _cache_specs(cfg, model, jm, pmesh, jmesh, prules,
                                 jrules):
            assert g == w


def _run_worker(tmp_path, *checks) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(tmp_path), *checks], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads((tmp_path / "result.json").read_text())


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """The 4-rank gloo run of the train, restore and order checks; the
    reference's one step and an unsharded checkpoint written first."""
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import init_opt_state
    out = tmp_path_factory.mktemp("mesh")
    jcfg = jax_get_config("llama3-8b", smoke=True).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = jax.value_and_grad(jm.loss)(
        jp, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    stepped, _, _ = jax_opt.adamw_update(grads, jax_opt.init_opt_state(jp),
                                         jp, jax_opt.AdamWConfig())
    arrays = {**_flat(jax.tree.map(np.asarray, jp), "params", {}),
              **_flat(jax.tree.map(np.asarray, stepped), "stepped", {}),
              **batch, "loss": np.asarray(loss)}
    np.savez(out / "inputs.npz", **arrays)
    cfg = configs.get_config("llama3-8b", smoke=True).replace(
        dtype="float32")
    m = Model(cfg, device="cpu")
    params = m.init(3, masters=True)
    Checkpointer(str(out / "ckpt")).save(
        7, {"params": params, "opt": init_opt_state(params)}, blocking=True)
    return _run_worker(out, "train", "restore", "order")


def test_sharded_train_step_equals_unsharded_and_the_reference(mesh_results):
    r = mesh_results["train"]
    assert r["close_unsharded"], r
    assert r["close_reference"], r
    assert abs(r["loss_sharded"] - r["loss_reference"]) <= \
        2e-5 * abs(r["loss_reference"])
    assert abs(r["loss_sharded"] - r["loss_unsharded"]) <= \
        2e-5 * abs(r["loss_unsharded"])


def test_sharded_train_state_is_laid_out_by_the_train_rules(mesh_results):
    r = mesh_results["train"]
    # wq (64, 4 x 16): ("embed", "heads") -> (data, model)
    assert r["wq_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert r["wq_local"] == [32, 32]
    assert r["moments_laid_out"] == r["wq_placements"]


def test_unsharded_checkpoint_restores_onto_the_mesh(mesh_results):
    r = mesh_results["restore"]
    assert r["step"] == 7 and r["count"] == 0
    assert r["equal"] and r["moments_zero"] and r["resaved_equal"]
    assert r["wq_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert r["wq_local"] == [32, 32]


def test_pod_data_split_takes_the_references_block_order(mesh_results):
    r = mesh_results["order"]
    assert r["spec"] == [["pod", "data"]]
    for (pod, data), block in zip(r["coords"], r["blocks"]):
        start = 2 * (pod * 2 + data)     # PS(("pod", "data")): pod major
        assert block == [float(start), float(start + 1)]


MESH_OF_ONE = """
import torch, torch.distributed as dist
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import destroy, make_host_mesh
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serve.serve_step import (
    make_decode_step, make_prefill, make_serve_shardings)
assert not dist.is_initialized()
mesh = make_host_mesh(device="cpu")
assert dist.get_world_size() == 1 and mesh.size() == 1
cfg = get_config("llama3-8b", smoke=True).replace(dtype="float32")
m = Model(cfg, device="cpu")
p = m.init(0)
sh = make_serve_shardings(m, mesh, 2, 12)
lp = shd.lay_out_tree(p, sh.params)
assert lp["blocks"][0]["mix"]["wq"] is p["blocks"][0]["mix"]["wq"]
x = torch.ones(4, 4)
with shd.use_sharding(mesh, sh.rules):
    assert shd.shard(x, "batch", "embed") is x
tok = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
with torch.no_grad():
    l0, c0 = m.prefill(p, {"tokens": tok}, cache_len=12)
    l1, c1 = make_prefill(m, sh, 12)(p, {"tokens": tok})
    assert torch.equal(l0, l1) and type(l1) is torch.Tensor
    t = l0.argmax(-1, keepdim=True)
    d0, _ = m.decode_step(p, c0, t)
    d1, _ = make_decode_step(m, sh)(p, c1, t)
    assert torch.equal(d0, d1)
try:
    make_host_mesh((2, 1), device="cpu")
except RuntimeError as e:
    assert "need 2 ranks" in str(e)
else:
    raise AssertionError("a mesh larger than the world must raise")
destroy()
assert not dist.is_initialized()
print("MESH_OF_ONE_OK")
"""


def test_a_mesh_of_one_keeps_tensors_plain_and_steps_bit_equal():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", MESH_OF_ONE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert "MESH_OF_ONE_OK" in proc.stdout, proc.stdout + proc.stderr


PRODUCTION_MESH = """
import torch.distributed as dist
from repro_torch.launch.mesh import FAKE_WORLD, make_production_mesh
assert not dist.is_initialized()
m = make_production_mesh()
assert dist.get_world_size() == FAKE_WORLD == 512
assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (16, 16)
p = make_production_mesh(multi_pod=True)
assert p.mesh_dim_names == ("pod", "data", "model")
assert tuple(p.shape) == (2, 16, 16)
print("PRODUCTION_OK")
"""

SMALL_GROUP = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
try:
    make_production_mesh()
except RuntimeError as e:
    assert "need 256 ranks" in str(e), e
    print("SMALL_OK")
"""


@pytest.mark.parametrize("code,marker", [(PRODUCTION_MESH, "PRODUCTION_OK"),
                                         (SMALL_GROUP, "SMALL_OK")])
def test_production_meshes_on_a_fake_group(code, marker):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert marker in proc.stdout, proc.stdout + proc.stderr


def test_host_mesh_on_the_card_without_one_raises():
    from repro_torch.launch.mesh import make_host_mesh
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
