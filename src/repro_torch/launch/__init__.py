"""repro_torch.launch — command-line launchers (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``) and
the production grids (``launch/mesh.py``)."""
