"""Kernels #3 and #4 (``unpack_dft`` and ``dft_pack``, summed, with
#4's zeroing of padded lanes): the least time of their calls, counted from
each call's shape, over their device time."""
from portbench.roofline import kernel_roofline_pct


def read(facts):
    return kernel_roofline_pct(facts, "sphere_pack",
                               also=("sphere_pack_tail",))
