"""nemotron-4-340b — dense GQA kv=8, squared-ReLU [arXiv:2402.16819]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv=8, d_ff=73728,
    vocab=256000, activation="relu2",
    source="arXiv:2402.16819; unverified",
))
