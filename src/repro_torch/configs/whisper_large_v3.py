"""whisper-large-v3 [audio]: enc-dec, 32L d_model=1280 20H (kv=20, i.e.
MHA) d_ff=5120 vocab=51866, conv frontend stubbed [arXiv:2212.04356].
A copy of ``repro.configs.whisper_large_v3``.

Shape convention: the shape's seq_len is the encoder frame count for
train/prefill (decoder length = seq_len/8) and the decoder self-cache
length for decode shapes (cross-attending 1500 stub frames)."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51866, head_dim=64,
        act="gelu", norm="layernorm", mlp_kind="plain", pos="sincos",
        encdec=True, n_enc_layers=32, dec_ratio=8, cross_seq=1500,
        frontend="audio", qkv_bias=True,
        block_pattern=(LayerSpec(),),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="whisper-large-v3-smoke", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, cross_seq=12)
