"""tinyllama-1.1b — llama2-arch small, GQA kv=4 [arXiv:2401.02385; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv=4, d_ff=5632,
    vocab=32000, activation="swiglu",
    source="arXiv:2401.02385; hf",
))
