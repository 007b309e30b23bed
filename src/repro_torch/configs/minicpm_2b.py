"""minicpm-2b [dense] — llama-like, MHA, tied embeddings; trained with the
WSD schedule (the JAX package's repro.train.optimizer.wsd_schedule;
training is not ported yet)
[arXiv:2404.06395]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, rope_theta=1e4, tie_embeddings=True,
)
