"""The port's dry run (repro_torch.launch.dryrun) on the CPU, in
subprocesses (a fake process group is process-global).

  * A cell of the llama3-8b smoke config on a fake (2, 4) ("data",
    "model") mesh of 8 ranks counts one rank's step for train, prefill and
    decode: ``chips`` 8, collective bytes > 0 split by kind, a per-device
    peak, and every parameter's local shard has the shape its spec gives.
  * The CLI records a cell that raises with ``status: "error"`` and its
    message, and exits 1; the fake group is created by ``main``, never at
    import.
  * The count of a smoke cell agrees with the reference's compiled count
    of the same cell (each package in its own subprocess): the layouts
    that ``shard()`` pins, forward and backward, keep every rank's share
    of the products what GSPMD gives the reference, whatever layout this
    torch's DTensor would pick by itself.
  * Query chunks bound the plain attention's scores: a long prefill's
    peak falls with them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]

SMALL_CELLS = """
import json, math, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models.model import Model
from repro_torch.train.train_step import make_train_shardings

assert not dist.is_initialized()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = get_config("llama3-8b", smoke=True)
out = {}
for kind, S, B in (("train", 32, 4), ("prefill", 32, 4), ("decode", 32, 8)):
    roof, meta = dryrun.lower_cell("llama3-8b", "smoke_" + kind,
                                   multi_pod=False, mesh=mesh, cfg=cfg,
                                   shape=ShapeConfig("smoke_" + kind, kind,
                                                     S, B))
    d = roof.to_dict()
    out[kind] = {k: d[k] for k in ("chips", "mesh", "hlo_flops", "hlo_bytes",
                                   "coll_bytes", "coll_breakdown",
                                   "bytes_per_device", "peak_memory_ok",
                                   "bottleneck")}
    out[kind]["t_count_s"] = meta["t_count_s"]
model = Model(cfg, device="cpu")
sh = make_train_shardings(model, mesh)
bad = []
def check(meta, s, path=""):
    if isinstance(meta, dict):
        for k in meta:
            check(meta[k], s[k], path + "/" + k)
    elif isinstance(meta, list):
        for i, (m, t) in enumerate(zip(meta, s)):
            check(m, t, path + "/" + str(i))
    else:
        t = shd.empty_laid_out(tuple(meta.shape), meta.dtype, s)
        want = list(meta.shape)
        for d, e in enumerate(s.spec):
            for ax in ((e,) if isinstance(e, str) else (e or ())):
                want[d] //= shd.mesh_shape(mesh)[ax]
        if list(t.to_local().shape) != want:
            bad.append((path, list(t.to_local().shape), want))
check(model.abstract_params(), sh.params)
out["bad_local_shapes"] = bad
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def small_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SMALL_CELLS], env=env,
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert lines, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cell_on_a_fake_eight_rank_mesh(small_cells, kind):
    r = small_cells[kind]
    assert r["chips"] == 8 and r["mesh"] == "data2xmodel4"
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["coll_bytes"] > 0
    split = {k: v for k, v in r["coll_breakdown"].items() if k != "total"}
    assert sum(split.values()) == r["coll_breakdown"]["total"] \
        == r["coll_bytes"]
    assert 0 < r["bytes_per_device"] and r["peak_memory_ok"]


def test_every_local_shard_has_its_specs_shape(small_cells):
    assert small_cells["bad_local_shapes"] == []


def test_train_cell_counts_one_ranks_share(small_cells):
    # a quarter of the model axis and half the batch: far below the
    # unsharded step's FLOPs on the same shapes
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.model import Model
    from repro_torch.roofline import analysis
    cfg = get_config("llama3-8b", smoke=True)
    whole = analysis.count_step(Model(cfg, device="cpu"), None,
                                ShapeConfig("t", "train", 32, 4), "train")
    assert small_cells["train"]["hlo_flops"] < 0.5 * whole.counter.cost.flops


def test_mesh_names():
    class M:
        def __init__(self, names, sizes):
            self.mesh_dim_names, self.shape = names, sizes
    assert dryrun.mesh_name_of(M(("data", "model"), (16, 16))) == "pod16x16"
    assert dryrun.mesh_name_of(M(("pod", "data", "model"), (2, 16, 16))) \
        == "pod2x16x16"
    assert dryrun.mesh_name_of(M(("data", "model"), (2, 4))) == \
        "data2xmodel4"


def test_run_cell_records_an_error(tmp_path):
    ok = dryrun.run_cell("no-such-arch", "train_4k", False, "baseline",
                         str(tmp_path))
    assert not ok
    rec = json.loads((tmp_path / "pod16x16" /
                      "no-such-arch__train_4k.json").read_text())
    assert rec["status"] == "error" and rec["error"].startswith("KeyError")
    assert rec["mesh"] == "pod16x16" and rec["variant"] == "baseline"


def test_cli_exits_one_for_a_failing_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "decode_32k", "--multi-pod", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 1
    assert "dry-run: 0/1 cells passed" in proc.stdout
    rec = json.loads((tmp_path / "pod2x16x16" /
                      "no-such-arch__decode_32k.json").read_text())
    assert rec["status"] == "error"


# the reference's count of llama3-8b smoke cells on a (2, 4) mesh of 8 host
# devices: its dry run's lower_cell with the smoke config, the small mesh
# and the cell's shape (its hlo_flops: hlo_cost of the compiled module)
REF_CELLS = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import mesh as rmesh
import repro.launch.dryrun as rd
rd.make_production_mesh = lambda multi_pod=False: rmesh.make_host_mesh((2, 4))
rd.get_config = lambda arch: get_config(arch, smoke=True)
out = {}
for kind, S, B in json.loads(sys.argv[1]):
    name = "smoke_" + kind
    rd.SHAPES = {name: ShapeConfig(name, kind, S, B)}
    _, _, roof, _ = rd.lower_cell("llama3-8b", name, multi_pod=False)
    out[f"{kind}_{S}"] = roof.hlo_flops
print("RESULT " + json.dumps(out))
"""

# the port's count of the same cells, as SMALL_CELLS counts them
PORT_CELLS = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = get_config("llama3-8b", smoke=True)
out = {}
for kind, S, B in json.loads(sys.argv[1]):
    roof, _ = dryrun.lower_cell("llama3-8b", "smoke_" + kind,
                                multi_pod=False, mesh=mesh, cfg=cfg,
                                shape=ShapeConfig("smoke_" + kind, kind, S, B))
    out[f"{kind}_{S}"] = roof.hlo_flops
print("RESULT " + json.dumps(out))
"""

# (kind, S, B): a prefill, whose residual the port's DTensor would leave
# partial over the model axis (its MLP then gathers the weights whole),
# and a training step, whose residual's gradient it would leave partial.
# At S = 32 the prefill's count is 2.1% over the reference's, from the
# two counters' conventions for elementwise ops alone (the products agree
# exactly), which a longer prompt dilutes
FLOP_CELLS = [["prefill", 128, 4], ["train", 32, 4]]


def _result(script: str, env: dict) -> dict:
    proc = subprocess.run([sys.executable, "-c", script,
                           json.dumps(FLOP_CELLS)], env=env,
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert lines, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def flop_pair():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return _result(PORT_CELLS, env), _result(REF_CELLS, env)


@pytest.mark.parametrize("cell", [f"{k}_{s}" for k, s, _ in FLOP_CELLS])
def test_smoke_cell_counts_the_references_flops(flop_pair, cell):
    """One rank's FLOPs within 2% of the reference's compiled count."""
    port, ref = flop_pair
    assert abs(port[cell] / ref[cell] - 1) <= 0.02, (port[cell], ref[cell])


def test_query_chunks_lower_a_long_prefills_peak(monkeypatch):
    """A fake-tensor count of the llama3-8b smoke prefill at S = 4,096:
    the peak of live bytes with the plain attention in query chunks of
    1,024 against the same count as one block, and the FLOPs unchanged
    but for the chunks' own masks."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.roofline import analysis
    cfg = get_config("llama3-8b", smoke=True)
    shape = ShapeConfig("p", "prefill", 4096, 1)

    def count():
        c = analysis.count_step(Model(cfg, device="cpu"), None, shape,
                                "prefill").counter
        return c.peak_bytes, c.cost.dot_flops

    chunked = count()
    monkeypatch.setattr(fa, "Q_CHUNK", 1 << 30)
    whole = count()
    assert chunked[0] < 0.5 * whole[0], (chunked, whole)
    assert chunked[1] == whole[1]


SHARD_SCAN = """
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import linear_scan as ls
from repro_torch.roofline.op_cost import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
B, S, Di, N = 4, 64, 256, 4
g = torch.Generator().manual_seed(0)
delta = torch.rand((B, S, Di), generator=g)
A = -torch.rand((Di, N), generator=g)
Bt, Ct = torch.randn((B, S, N), generator=g), torch.randn((B, S, N), generator=g)
x = torch.randn((B, S, Di), generator=g)
with shd.use_sharding(mesh, shd.SERVE_RULES):
    def lay(t, spec):
        return shd.lay_out(t, shd.NamedSharding(mesh, spec))
    args = (lay(delta, ("data", None, "model")), lay(A, ("model",)),
            lay(Bt, ("data", "model")), lay(Ct, ("data", "model")),
            lay(x, ("data", None, "model")))
    with OpCounter() as c:
        y, h = ls.mamba_scan_plain(*args)
print("RESULT " + json.dumps({
    "peak": c.peak_bytes, "whole_y": B * S * Di * 4,
    "y": [str(p) for p in y.placements], "h": [str(p) for p in h.placements],
    "local_y": list(y.to_local().shape)}))
"""


def test_plain_mamba_scan_runs_on_each_ranks_shards():
    """The plain Mamba scan handed DTensors laid out as jamba's prefill lays
    them out (delta and x over the batch and the inner dim, Bt and Ct over
    the batch and the sequence) on a fake (2, 4) mesh of 8 ranks: one rank's
    peak of live bytes stays below half of the whole float32 output, and y
    and the state come back sharded over the batch and the inner dim, each
    rank holding an eighth of y. Handed to the whole scan, DTensor made the
    stacked output whole on every rank (jamba-v0.1-52b prefill_32k read
    82.63 GB a rank against the reference's 18.03)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = _result(SHARD_SCAN, env)
    assert r["peak"] < 0.5 * r["whole_y"], r
    assert r["y"] == ["S(0)", "S(2)"] and r["h"] == ["S(0)", "S(1)"], r
    assert r["local_y"] == [2, 64, 64], r
