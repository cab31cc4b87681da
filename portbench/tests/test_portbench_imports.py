"""No module the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program either. Top-level module names are
compared whole: the port's name, repro_torch, begins with repro."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"

PROBE = """
import importlib.util, json, sys
sys.path[:0] = [{src!r}, {pb!r}]
for mod in {mods!r}:
    importlib.import_module(mod)
for path in {files!r}:
    spec = importlib.util.spec_from_file_location("m" + str(abs(hash(path))), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after(mods, files=()) -> set:
    code = PROBE.format(src=str(ROOT / "src"), pb=str(PB), mods=list(mods),
                        files=[str(f) for f in files])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_neither_jax_nor_the_jax_package():
    files = sorted((PB / "drivers").glob("*.py")) \
        + sorted((PB / "metrics").glob("*.py"))
    mods = ["benchkit.harness", "benchkit.checks", "reference.lm",
            "reference.train", "repro_torch.serve.engine",
            "repro_torch.train.train_step", "repro_torch.models.model"]
    loaded = top_level_after(mods, files)
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded
    assert "repro_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = top_level_after(["reference.lm", "reference.train"])
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, \
        loaded


def test_foreign_modules_compares_whole_names(monkeypatch):
    sys.path[:0] = [str(ROOT / "src"), str(PB)]
    from benchkit import harness
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.x", object())
    assert harness.foreign_modules() == ["repro"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload",
         "chameleon-34b.chat", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
