"""whisper-small — encoder-decoder; conv audio frontend STUBBED (the model
consumes precomputed frame embeddings per task spec) [arXiv:2212.04356]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=51865, activation="geglu", enc_layers=12, enc_seq=1500,
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
))
