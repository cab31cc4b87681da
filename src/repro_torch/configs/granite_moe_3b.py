"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

E=40 does not divide the 16-way model axis, so expert weights shard on the
d_expert axis instead (tensor-parallel experts) — handled automatically by
the reference's divisibility-aware sharding rules (one card here: no
sharding). A copy of ``repro.configs.granite_moe_3b``."""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        act="silu", norm="rmsnorm", rope_theta=10_000.0,
        tie_embeddings=True,
        block_pattern=(LayerSpec(moe=True),),
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="granite-moe-3b-a800m-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=4, d_expert=64))
