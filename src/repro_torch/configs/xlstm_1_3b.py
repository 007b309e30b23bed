"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (one sLSTM leading each group of
8), chunkwise-parallel training form [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern="xlstm", slstm_every=8, conv_width=4, chunk=128,
    supports_long_context=True,
)
