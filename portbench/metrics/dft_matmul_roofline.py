"""Kernel #1 (the line DFT, ``dft_matmul``): the least time of the lines
it was called on, counted per call from the call's shape
(:func:`portbench.roofline.pair_calls`), over its device time."""
from portbench.roofline import kernel_roofline_pct


def read(facts):
    return kernel_roofline_pct(facts, "dft_matmul")
