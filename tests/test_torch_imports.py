"""The port stands alone: importing every repro_torch module (and
chip_smoke.py) loads neither JAX nor anything of the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.kernels.build", "repro_torch.kernels.ops",
            "repro_torch.kernels.matmul", "repro_torch.kernels.preproc",
            "repro_torch.kernels.resize", "repro_torch.core.events",
            "repro_torch.core.batching", "repro_torch.core.metrics",
            "repro_torch.core.facerec", "repro_torch.core.pipeline",
            "repro_torch.data.video", "repro_torch.preprocess.host",
            "repro_torch.preprocess.device",
            "repro_torch.preprocess.stage"} <= mods


def test_port_has_the_serving_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.llama3_8b", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.models.model", "repro_torch.serve.engine",
            "repro_torch.launch.serve"} <= mods


def test_port_has_the_rwkv_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.configs.rwkv6_3b", "repro_torch.models.ssm",
            "repro_torch.kernels.linear_scan"} <= mods


def test_port_has_the_jamba_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.configs.jamba_v0_1_52b", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.kernels.linear_scan"} <= mods


def test_port_has_the_tax_meter_and_zoo_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.core.taxmeter", "repro_torch.core.acceleration",
            "repro_torch.configs.qwen2_5_14b",
            "repro_torch.configs.chameleon_34b",
            "repro_torch.configs.granite_moe_3b"} <= mods


def test_port_has_the_window_and_mla_zoo_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.configs.gemma3_12b",
            "repro_torch.configs.deepseek_v2_236b",
            "repro_torch.configs.qwen1_5_110b"} <= mods


def test_port_has_the_cluster_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.core.broker", "repro_torch.core.simulator",
            "repro_torch.core.queueing", "repro_torch.core.tco",
            "repro_torch.cluster", "repro_torch.cluster.metrics",
            "repro_torch.cluster.scheduler", "repro_torch.cluster.topic",
            "repro_torch.cluster.loadgen", "repro_torch.cluster.reliability",
            "repro_torch.cluster.trace", "repro_torch.cluster.scenarios",
            "repro_torch.cluster.faults", "repro_torch.cluster.autoscaler",
            "repro_torch.cluster.cluster",
            "repro_torch.cluster.crossval"} <= mods


def test_port_has_the_whisper_and_training_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.configs.whisper_large_v3",
            "repro_torch.models.encdec", "repro_torch.data.tokens",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.train.checkpoint",
            "repro_torch.train.trainer", "repro_torch.launch.train"} <= mods


def test_port_has_the_cost_model_and_autotune_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.roofline", "repro_torch.roofline.hw",
            "repro_torch.roofline.op_cost", "repro_torch.roofline.analysis",
            "repro_torch.roofline.calibrate",
            "repro_torch.kernels.autotune"} <= mods
    assert (PORT / "kernels" / "tilings.json").is_file()


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_name_jax_or_repro_imports():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)",
                         re.M)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
