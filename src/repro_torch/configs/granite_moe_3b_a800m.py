"""granite-moe-3b-a800m — MoE 40 experts top-8, d_ff(expert)=512.

NOTE: the assignment line also says "32 experts top-8" in its comment; we
implement the structured field (40e).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512,
    vocab=49155, n_experts=40, top_k=8, activation="swiglu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
