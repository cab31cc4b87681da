"""The control: the reference put in the program's place and computed in
fp8 (a step below the bf16 the configurations state). At a size a test run
holds (the port's smoke configs on the CPU) it must read well above the
program on the same sample, and for training fail a limit; at the cell's
own size on the card (``gpu``) it must fail the cell's limit where the
program passes it."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]

from benchkit import checks, configs, harness  # noqa: E402
from reference.lm import fp8_round, serve_logits, served_gaps  # noqa: E402
from reference.train import train_reference  # noqa: E402
from test_portbench_faults import (  # noqa: E402
    SEED, SERVE, SMOKE_SECONDS, smoke_traffic)
from test_portbench_reference import smoke_config  # noqa: E402


def test_fp8_round_keeps_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    r = fp8_round(t, dim=-1)
    assert r[0, 0] == 1.0 and r[0, 2] == 448.0
    assert r[0, 1] in (1.0, 1.125)
    assert abs(r[0, 3] + 3.3) <= 3.3 / 16


def driven(workload):
    bench = configs.load_benchmark()
    cell = configs.find_cell(bench, workload)
    run, bench = harness.make_run(
        workload, SEED, SMOKE_SECONDS, False, "cpu", time.perf_counter(),
        smoke=True, bench=bench, config=smoke_config(cell["config"]),
        traffic=smoke_traffic(workload))
    return run, harness.driver(run.traffic["driver"]).run(run)


@pytest.mark.parametrize("workload", SERVE)
def test_serve_control_reads_well_above_the_program(workload):
    run, out = driven(workload)
    ex = out.extra
    seqs, lens = [], []
    for rid, toks, _ in ex["sample"]:
        p = torch.as_tensor(ex["prompts"][rid], dtype=torch.int64)
        seqs.append(torch.cat([p, torch.as_tensor(toks[:-1],
                                                  dtype=torch.int64)]))
        lens.append(len(p))
    ctl = serve_logits(run.config, SEED, seqs, lens, torch.bfloat16, "cpu",
                       quant="fp8")
    picks = [c.argmax(dim=-1).tolist() for c in ctl]
    gap = checks.gap_numbers(served_gaps(ex["ref_logits"], picks))[
        out.checks[0].name]
    # the smoke model's logits move less under fp8 than the full width's
    # (chat's widest gap 0.27-0.32 here against 0.71-0.84 there), so at
    # this size the separation is held, and the limit at the cell's size
    # on the card
    assert out.checks[0].ok
    assert gap > 3 * out.checks[0].value, (gap, out.checks[0].value)


def test_train_control_fails_a_limit():
    run, out = driven("chameleon-34b.train")
    ex, ref = out.extra, out.extra["ref"]
    ctl = train_reference(run.config, run.traffic, SEED, ex["batches"],
                          "cpu", quant="fp8")
    nums = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(ctl["losses"], ref["losses"])),
            "grad_gap": checks.leaf_gap(ctl["grad"], ref["grad"],
                                        list(ref["grad"]))[0],
            "change_gap": checks.leaf_gap(ctl["change"], ref["change"],
                                          ex["moving"])[0]}
    assert all(c.ok for c in out.checks)
    assert any(nums[k] > run.limits[k] for k in nums), nums


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      configs.load_benchmark()["workloads"]])
def test_control_fails_the_limit_at_the_cells_size(card, workload, tmp_path):
    out = tmp_path / "control.jsonl"
    seeds = ["2147483801", "2147483802", "2147483803"]
    subprocess.run([sys.executable, str(ROOT / "portbench" / "tools" /
                                       "control.py"), "--workload", workload,
                    "--seconds", "15", "--control", "3", "--out", str(out),
                    "--seeds", *seeds], cwd=ROOT, check=True, timeout=3000)
    limits = json.loads((ROOT / "portbench" / "limits" /
                         f"{workload}.json").read_text())
    for line in out.read_text().splitlines():
        row = json.loads(line)
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SERVE)
def test_cache_fault_fails_the_limit_at_the_cells_size(card, workload,
                                                       tmp_path):
    out = tmp_path / "fault.jsonl"
    seeds = ["2147483811", "2147483812", "2147483813"]
    subprocess.run([sys.executable, str(ROOT / "portbench" / "tools" /
                                       "control.py"), "--workload", workload,
                    "--seconds", "15", "--control", "0", "--fault",
                    "cache_unchanged", "--out", str(out), "--seeds", *seeds],
                   cwd=ROOT, check=True, timeout=3000)
    limits = json.loads((ROOT / "portbench" / "limits" /
                         f"{workload}.json").read_text())
    for line in out.read_text().splitlines():
        row = json.loads(line)
        assert any(row["program"][k] > lim for k, lim in limits.items()), row
