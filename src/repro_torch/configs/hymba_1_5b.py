"""hymba-1.5b [hybrid] — parallel attention + Mamba(-2/SSD) heads per layer,
sliding window with 3 global-attention layers, ssm_state=16
[arXiv:2411.13676].  Decode uses a ring-buffer window cache for ALL layers
(global layers degrade to windowed during decode)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    block_pattern="hymba", window=1024, full_attn_layers=(0, 15, 31),
    ssm_state=16, ssm_expand=2, ssm_heads=25, conv_width=4, chunk=128,
    supports_long_context=True, rope_theta=1e4,
)
