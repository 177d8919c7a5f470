"""repro_torch.ckpt — atomic, async, name-keyed checkpoints."""
