"""One run of one cell: find the cell's files by name, hand them to the
cell's driver, read the per-layer metrics, print the result line.

A driver (``portbench/drivers/<driver>.py``, named by the traffic file)
has ``run(run: Run) -> Outcome``: it builds the program, warms it up, runs
the measured window, frees the program and checks what the window
produced against the reference. A per-layer metric is
``portbench/metrics/<name>.py`` with ``read(ctx) -> float | None``; the
harness calls the readers of the cell's per-layer metrics in a traced
run and leaves out a metric whose reader finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

from benchkit import configs

# top-level module names that may not be loaded once the window has closed:
# JAX, its libraries, and the JAX package the port was made from (compared
# whole: the port's own name, repro_torch, begins with repro)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


@dataclass
class Run:
    """What a driver is given: the cell's files and the run's arguments."""
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                     # perf_counter at process start
    smoke: bool = False           # tests: the port's smoke config


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver returns: the end-to-end metrics it measured (setup_s
    among them), the checks of ``correct``, the requests or steps
    attempted and failed, the peak device memory, and for a traced run the
    context its per-layer readers take."""
    e2e: dict[str, float]
    checks: list[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    ctx: object = None
    extra: dict = field(default_factory=dict)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load_module(configs.PORTBENCH / "drivers" / f"{name}.py",
                        f"portbench_driver_{name}")


def reader(metric: str):
    return _load_module(configs.PORTBENCH / "metrics" / f"{metric}.py",
                        "portbench_metric_" + metric.replace(".", "_"))


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def make_run(workload: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, *, smoke: bool = False,
             bench: dict | None = None, config: dict | None = None,
             traffic: dict | None = None) -> tuple[Run, dict]:
    """The :class:`Run` of ``workload`` from its files (tests may pass the
    benchmark, config and traffic dicts in their place)."""
    bench = bench or configs.load_benchmark()
    cell = configs.find_cell(bench, workload)
    limits_path = configs.PORTBENCH / "limits" / f"{workload}.json"
    run = Run(workload=workload,
              config=config or configs.load_config(cell["config"]),
              traffic=traffic or configs.load_traffic(cell["traffic"]),
              limits=configs.load_json(limits_path),
              seed=seed, seconds=seconds, trace=trace, device=device,
              t0=t0, smoke=smoke)
    return run, bench


def result(run: Run, bench: dict, out: Outcome, device_info: dict) -> dict:
    """The result line's object; ``checks`` comes last."""
    e2e, layer = cell_metrics(bench, run.workload)
    metrics = {}
    if run.trace:
        for m in layer:
            value = reader(m["name"]).read(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    res = {"correct": all(c.ok for c in out.checks),
           "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": device_info}
    if run.trace and out.ctx is not None:
        res["breakdown"] = out.ctx.breakdown()
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    return res


def run_cell(run: Run, bench: dict) -> tuple[dict, Outcome]:
    """Drive the cell (no look for a card: :func:`main` makes it) and
    return (result object, outcome)."""
    import torch
    out = driver(run.traffic["driver"]).run(run)
    if run.device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": configs.find_cell(bench, run.workload)["chips"],
                "memory_peak_bytes": out.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": out.memory_peak_bytes}
    if run.trace and out.ctx is not None:
        info["busy_s"] = out.ctx.trace.busy_s()
        info["window_s"] = out.ctx.window[1] - out.ctx.window[0]
    return result(run, bench, out, info), out


def main(args, t0: float) -> int:
    """The command's body: refuse without enough cards, run, refuse a
    result if JAX or the JAX package was loaded, print."""
    import torch
    bench = configs.load_benchmark()
    chips = configs.find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    run, bench = make_run(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t0, bench=bench)
    res, _ = run_cell(run, bench)
    bad = foreign_modules()
    if bad:
        print(f"portbench: modules loaded in the run: {bad} (JAX or the "
              "JAX package); no result", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    sys.stdout.flush()
    return 0
