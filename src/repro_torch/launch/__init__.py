"""repro_torch.launch — command-line launchers (``python -m
repro_torch.launch.serve``)."""
