"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion VQ image tokens [arXiv:2405.09818].

Early fusion means image patches are VQ-quantized into the SAME 65536
vocab, so model inputs are plain token ids; the vision frontend is the
(stubbed) VQ tokenizer upstream of the model. QK-norm per the paper.

A copy of ``repro.configs.chameleon_34b``; ``frontend="vision"`` is
copied as a field only: neither package has frontend code for it."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=65536, head_dim=128, qk_norm=True,
        act="silu", norm="rmsnorm", rope_theta=10_000.0,
        frontend="vision",
        block_pattern=(LayerSpec(),),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="chameleon-34b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
