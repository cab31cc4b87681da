"""Config schema: model architecture + benchmark input shapes.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
``repro``); ``tests/test_torch_models.py`` holds the copies equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating block pattern."""
    kind: str = "attn"            # attn | mamba | rwkv
    window: int | None = None     # sliding-window size (attn only)
    moe: bool = False             # MoE MLP at this position


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0             # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"             # silu | gelu
    mlp_kind: str = "glu"         # glu | plain | rwkv
    pos: str = "rope"             # rope | sincos
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma: scale embeddings by sqrt(d)
    block_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # SSM
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int | None = None
    rwkv_head_dim: int = 64
    # encoder-decoder
    encdec: bool = False
    n_enc_layers: int = 0
    dec_ratio: int = 8            # decoder len = seq_len // dec_ratio
    cross_seq: int = 1500         # stub encoder length for decode shapes
    frontend: str = "none"        # none | audio | vision
    # capability flags
    supports_long: bool = False   # sub-quadratic: may run long_500k
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.block_pattern)}")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for MODEL_FLOPS = 6·N·D roofline term) ----
    def param_counts(self) -> dict[str, float]:
        """Returns dict with 'total' and 'active' parameter counts."""
        d, V = self.d_model, self.vocab_size
        D = self.head_dim
        H, KV = self.n_heads, self.n_kv_heads
        embed = V * d * (1 if self.tie_embeddings else 2)
        per = {"total": 0.0, "active": 0.0}

        def attn_params():
            if self.mla:
                m = self.mla
                n = (d * m.q_lora + m.q_lora * H * (m.qk_nope + m.qk_rope)
                     + d * (m.kv_lora + m.qk_rope)
                     + m.kv_lora * H * (m.qk_nope + m.v_head)
                     + H * m.v_head * d)
            else:
                n = d * H * D + 2 * d * KV * D + H * D * d
                if self.qkv_bias:
                    n += H * D + 2 * KV * D
            return n

        def mlp_params(moe: bool):
            mult = 3 if self.mlp_kind == "glu" else 2
            if moe and self.moe:
                tot = self.moe.n_experts * mult * d * self.moe.d_expert
                act = self.moe.top_k * mult * d * self.moe.d_expert
                tot += d * self.moe.n_experts          # router
                act += d * self.moe.n_experts
                if self.moe.n_shared:
                    sh = self.moe.n_shared * mult * d * self.moe.d_expert
                    tot += sh
                    act += sh
                return tot, act
            if self.mlp_kind == "rwkv":
                n = 2 * d * self.d_ff + d * d
                return n, n
            n = mult * d * self.d_ff
            return n, n

        def mixer_params(spec: LayerSpec):
            if spec.kind == "attn":
                n = attn_params()
            elif spec.kind == "mamba":
                di = self.ssm_expand * d
                dtr = self.ssm_dt_rank or max(d // 16, 1)
                n = (2 * d * di + di * self.ssm_conv
                     + di * (dtr + 2 * self.ssm_state) + dtr * di
                     + di * self.ssm_state + di + di * d)
            else:  # rwkv time-mix
                n = 4 * d * d + d * d // 2   # r,k,v,o,g(~half) rough but counted exactly in init
            return n

        for spec in self.block_pattern:
            mix = mixer_params(spec)
            mt, ma = mlp_params(spec.moe)
            per["total"] += mix + mt
            per["active"] += mix + ma
        per["total"] *= self.n_repeats
        per["active"] *= self.n_repeats
        if self.encdec:
            # encoder mirrors the decoder stack without cross-attn
            enc = self.n_enc_layers * (attn_params() + mlp_params(False)[0])
            dec_cross = self.n_layers * attn_params()      # cross-attention
            per["total"] += enc + dec_cross
            per["active"] += enc + dec_cross
        per["total"] += embed
        per["active"] += embed
        return per


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def supports_shape(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.supports_long
    return True
