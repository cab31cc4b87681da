"""Whole runs of each cell at the port's smoke sizes on the CPU (the look
for a card skipped), sound and with the timed path broken underneath:
``correct`` must come out true for the sound run and false for every
fault the cell can have, against the cell's own limits."""
import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]

from benchkit import configs, faults, harness  # noqa: E402
from test_portbench_reference import smoke_config  # noqa: E402

SEED = 2_718_281_828_459
# long enough that a window finishes requests on a loaded CPU (test
# workers beside each other)
SMOKE_SECONDS = 15.0


def smoke_traffic(workload: str) -> dict:
    """The cell's traffic file at the smoke model's size: serving with
    outputs of 16-64 tokens (long enough that a cache fault shows) and a
    sample of 200 served tokens; training on 64-token rows."""
    bench = configs.load_benchmark()
    tr = copy.deepcopy(configs.load_traffic(
        configs.find_cell(bench, workload)["traffic"]))
    if tr["driver"] == "serve_closed":
        tr.update(clients=4, slots=4, cache_len=160, requests_per_client=16,
                  check_tokens=200,
                  prompt={"dist": "loguniform", "min": 8, "max": 64},
                  output={"dist": "uniform", "min": 16, "max": 64})
    else:
        tr.update(seq_len=64, batches=8)
    return tr


def smoke_run(workload: str, seconds: float = SMOKE_SECONDS):
    bench = configs.load_benchmark()
    cell = configs.find_cell(bench, workload)
    run, bench = harness.make_run(
        workload, SEED, seconds, False, "cpu", time.perf_counter(),
        smoke=True, bench=bench, config=smoke_config(cell["config"]),
        traffic=smoke_traffic(workload))
    res, _ = harness.run_cell(run, bench)
    return res


SERVE = ["chameleon-34b.chat", "jamba-v0.1-52b.code"]


@pytest.mark.parametrize("workload", SERVE + ["chameleon-34b.train"])
def test_sound_run_is_correct(workload):
    res = smoke_run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


# jamba's cache fault moves the smoke model's mean gap by ~0.04 (sound
# runs ~0.0014), under any limit its own readings at the cell's size allow
# (the program reads up to 0.065 there): that case is read at the cell's
# size on the card (test_portbench_control.py, gpu)
SERVE_FAULTS = [(w, f) for w in SERVE for f in faults.SERVE
                if (w, f) != ("jamba-v0.1-52b.code", faults.cache_unchanged)]


@pytest.mark.parametrize("workload,fault", SERVE_FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_serve_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = smoke_run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN, ids=lambda f: f.__name__)
def test_train_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = smoke_run("chameleon-34b.train")
    assert not res["correct"], res["checks"]
