"""repro_torch.data — the deterministic, sharded token pipeline."""
