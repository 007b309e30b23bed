"""seamless-m4t-large-v2 [audio] — enc-dec backbone; audio frontend stubbed
(precomputed frame embeddings) [arXiv:2308.11596]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encdec=True, enc_layers=24, d_frontend=160, rope_theta=1e4,
)
