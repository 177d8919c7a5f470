"""recurrentgemma-9b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
    vocab=256000, activation="geglu",
    block_pattern=("rec", "rec", "attn"), local_window=2048, d_rnn=4096,
    source="arXiv:2402.19427; unverified",
))
