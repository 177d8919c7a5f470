"""The Γ-point fold and unfold's share of their roofline: the least time
of their bytes counted from the problem (each real band's half sphere and
each complex full-sphere row read once and written once, both passes;
``drivers/gamma.py::fold_work``) at the card's HBM rate, over the device
time of the ``gamma:fold`` and ``gamma:unfold`` spans the program records
(the profiler's trace buckets only the GEMM kernels by name).  None where
``fold_ms.gamma`` finds no such spans."""
from portbench import registry
from portbench.roofline import HBM_BYTES_PER_S


def read(facts):
    work = facts.get("fold_work")
    if facts.get("trace") is None or not work:
        return None
    ms = registry.reader("fold_ms.gamma")(facts)
    if not ms:
        return None
    return 100.0 * (work / HBM_BYTES_PER_S) / (ms / 1e3)
