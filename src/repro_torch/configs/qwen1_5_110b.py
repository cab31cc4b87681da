"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-0.5B]. Largest dense arch:
needs 2-D (FSDP x TP) weight sharding to fit.

A copy of ``repro.configs.qwen1_5_110b``."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab_size=152064, head_dim=128, qkv_bias=True,
        act="silu", norm="rmsnorm", rope_theta=1_000_000.0,
        block_pattern=(LayerSpec(),),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen1.5-110b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
