"""qwen3-32b — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv=8, d_ff=25600,
    vocab=151936, qk_norm=True, activation="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
))
