"""Runtime flags for lowering modes (the reference's ``models/flags.py``).

UNROLL: when True, the dry-run's *accounting* pass counts every layer of
the stack one by one (the reference unrolls its ``lax.scan`` over layers,
because XLA's cost analysis counts a while-loop body once).  The port's
layer loops are Python loops and always unrolled; the flag is kept with
its API for the training slice's dry-run, which reads it.
"""
import contextlib

UNROLL = False


def scan_unroll():
    return UNROLL


@contextlib.contextmanager
def unrolled():
    global UNROLL
    old = UNROLL
    UNROLL = True
    try:
        yield
    finally:
        UNROLL = old
