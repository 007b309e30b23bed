"""pixtral-12b [vlm] — pixtral-ViT frontend stubbed (precomputed patch
embeddings prepended); mistral-nemo-like decoder [hf:mistralai/Pixtral-12B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=160, d_ff=14336, vocab_size=131072, rope_theta=1e6,
    num_patches=256, d_frontend=1024,
)
