"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt]. Local layers use a 1024-token sliding window
(rolling decode cache), so the arch qualifies for long_500k.

A copy of ``repro.configs.gemma3_12b``."""
from repro_torch.configs.base import LayerSpec, ModelConfig

_W = 1024  # sliding-window size


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        d_ff=15360, vocab_size=262144, head_dim=256,
        act="gelu", norm="rmsnorm", rope_theta=1_000_000.0,
        embed_scale=True, tie_embeddings=True, qk_norm=True,
        block_pattern=tuple([LayerSpec(window=_W)] * 5 + [LayerSpec()]),
        supports_long=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="gemma3-12b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        block_pattern=tuple([LayerSpec(window=8)] * 5 + [LayerSpec()]))
