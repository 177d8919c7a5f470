"""repro_torch.sharding — process-grid selection for the DFT workload.

``choose_dft_grid_shape`` is the reference's chooser line for line (pure
arithmetic: 1D fft, 2D batch×fft or 3-axis pencil grids);
``choose_dft_grid`` builds the port's ``ProcGrid`` over the processes of
the run (one per card).
"""

from .grids import (DFT_AXES_1D, DFT_AXES_2D, DFT_AXES_3D, choose_dft_grid,
                    choose_dft_grid_shape)

__all__ = ["DFT_AXES_1D", "DFT_AXES_2D", "DFT_AXES_3D", "choose_dft_grid",
           "choose_dft_grid_shape"]
