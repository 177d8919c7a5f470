"""repro_torch.optim — AdamW and int8 gradient compression over a
model's named parameters."""
