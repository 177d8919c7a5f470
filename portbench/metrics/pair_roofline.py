"""The whole pair's share of its roofline: the least time the card could
take for the pairs of the traced window (the problem's bytes and FFT
operations, :func:`portbench.roofline.pair_work`) over the window."""
from portbench.roofline import bound_s


def read(facts):
    tr, work = facts.get("trace"), facts.get("pair_work")
    if tr is None or work is None or not facts.get("pairs"):
        return None
    return 100.0 * facts["pairs"] * bound_s(*work) / tr.window_s
