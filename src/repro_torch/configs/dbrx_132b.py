"""dbrx-132b — fine-grained MoE 16 experts top-4
[hf:databricks/dbrx-base]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752,
    vocab=100352, n_experts=16, top_k=4, activation="swiglu",
    source="hf:databricks/dbrx-base; unverified",
))
