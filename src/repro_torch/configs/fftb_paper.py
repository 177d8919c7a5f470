"""The paper's own workload: batched plane-wave FFT, 256³ grid, sphere
diameter 128, 256 bands (Fig. 9 red line); the reference's
``configs/fftb_paper.py``, field for field."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PlaneWaveConfig:
    name: str = "fftb-paper"
    n: int = 256           # FFT grid width
    diameter: int = 128    # cut-off sphere diameter (= n/2, Fig. 2)
    nb: int = 256          # bands (batch)
    backend: str = "matmul"


CONFIG = PlaneWaveConfig()
