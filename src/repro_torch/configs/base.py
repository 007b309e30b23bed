"""Architecture + shape configuration schema for the model zoo (a copy of
``repro.configs.base``; the port imports nothing of the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | ssm | audio | vlm | hybrid | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # block mix
    block_pattern: str = "attn"  # attn | xlstm | hymba
    window: int = 0  # 0 = full attention; >0 sliding-window size
    full_attn_layers: Tuple[int, ...] = ()  # hybrid: layers with full attn
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_heads: int = 0
    conv_width: int = 4
    slstm_every: int = 0  # xlstm: one sLSTM per group of this size (0 = none)
    chunk: int = 128  # recurrent chunk length
    # enc-dec (audio)
    encdec: bool = False
    enc_layers: int = 0
    d_frontend: int = 0  # stub frontend feature dim (audio frames / patches)
    num_patches: int = 0  # vlm: prepended patch embeddings
    # capabilities
    supports_long_context: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # structure
    use_scan: bool = True
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.block_pattern == "attn" or self.block_pattern == "hymba":
            att = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
            per_layer += att
        if self.block_pattern == "hymba":
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d + di * (2 * self.ssm_state) + self.ssm_heads * 2
        if self.block_pattern == "xlstm":
            per_layer += 2 * d * d + 3 * d * d + 2 * d * self.num_heads + d * d
        if self.is_moe:
            per_layer += self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            if self.num_shared_experts:
                per_layer += 3 * d * self.moe_d_ff * self.num_shared_experts
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        total = emb + self.num_layers * per_layer
        if self.encdec:
            enc_att = 4 * d * d
            total += self.enc_layers * (enc_att + 3 * d * self.d_ff)
            total += self.num_layers * 4 * d * d  # cross attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        inactive = self.num_layers * (self.num_experts - self.top_k) * 3 * d * self.moe_d_ff
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
