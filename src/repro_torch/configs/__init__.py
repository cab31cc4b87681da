"""Config registry of the port (counterpart of ``repro.configs``).

``get_config(name)`` returns the full published config and
``get_config(name, smoke=True)`` the reduced config of the CPU tests, for
every architecture of :data:`ARCHS`, listed as the reference lists them;
an unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    LayerSpec, MLAConfig, ModelConfig, MoEConfig,
)

ARCHS = [
    "llama3-8b",
    "qwen2.5-14b",
    "gemma3-12b",
    "qwen1.5-110b",
    "chameleon-34b",
    "whisper-large-v3",
    "jamba-v0.1-52b",
    "rwkv6-3b",
    "granite-moe-3b-a800m",
    "deepseek-v2-236b",
]

# architecture -> module
_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-110b": "qwen1_5_110b",
    "chameleon-34b": "chameleon_34b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def list_configs() -> list[str]:
    """The architectures the port can build."""
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke_config() if smoke else mod.config()
