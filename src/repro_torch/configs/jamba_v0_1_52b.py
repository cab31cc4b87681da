"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba:attention 7:1 interleave
[arXiv:2403.19887].

Block pattern: 8 layers, attention at position 4, Mamba elsewhere; MoE MLP
at every other (odd) position. State caches are O(1) in context for 28/32
layers, so the arch runs long_500k. A copy of
``repro.configs.jamba_v0_1_52b``."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def _pattern(window=None):
    out = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        out.append(LayerSpec(kind=kind, moe=(i % 2 == 1)))
    return tuple(out)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536, head_dim=128,
        act="silu", norm="rmsnorm", rope_theta=10_000.0,
        block_pattern=_pattern(),
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
        ssm_state=16, ssm_expand=2, ssm_conv=4,
        supports_long=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
        ssm_state=4)
