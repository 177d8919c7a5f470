"""The share of the traced window in which no operation ran on the
device (kernels, copies and fills, from the device trace)."""


def read(facts):
    tr = facts.get("trace")
    return None if tr is None else tr.idle_pct
