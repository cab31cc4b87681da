"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B]. A copy of
``repro.configs.qwen2_5_14b``."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab_size=152064, head_dim=128, qkv_bias=True,
        act="silu", norm="rmsnorm", rope_theta=1_000_000.0,
        block_pattern=(LayerSpec(),),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen2.5-14b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
