"""pixtral-12b — VLM: pixtral-ViT frontend (STUB: precomputed patch
embeddings per task spec) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
    vocab=131072, activation="swiglu", n_img_tokens=1024,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
))
