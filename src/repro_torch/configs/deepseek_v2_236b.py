"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA) routed d_ff=1536
vocab=102400, MoE 160e top-6 + 2 shared — MLA kv_lora=512
[arXiv:2405.04434].

MLA keeps a 512-d compressed latent cache (+64-d shared rope key) per
position instead of 128 heads x 256; decode uses the absorbed-matrix form
attending directly in latent space.

A copy of ``repro.configs.deepseek_v2_236b``."""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab_size=102400, head_dim=192,
        act="silu", norm="rmsnorm", rope_theta=10_000.0,
        block_pattern=(LayerSpec(moe=True),),
        moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2),
        mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                      v_head=128),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-236b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=24, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1),
        mla=MLAConfig(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8,
                      v_head=16))
