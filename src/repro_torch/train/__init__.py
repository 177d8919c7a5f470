"""repro_torch.train — the train step and the fault-tolerant trainer."""
