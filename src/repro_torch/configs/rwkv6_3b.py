"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892]. 40 heads x 64 matrix
state; O(1) decode state -> runs long_500k. A copy of
``repro.configs.rwkv6_3b``."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab_size=65536, head_dim=64,
        act="silu", norm="layernorm", mlp_kind="rwkv", pos="sincos",
        rwkv_head_dim=64,
        block_pattern=(LayerSpec(kind="rwkv"),),
        supports_long=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        rwkv_head_dim=16)
