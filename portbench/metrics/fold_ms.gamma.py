"""The device time of the Γ-point fold and unfold (the real bands' half
spheres to the complex full-sphere rows before the inverse, and back after
the forward), per pair: the window's ``gamma:fold`` and ``gamma:unfold``
spans, timed by the program on the device
(``repro_torch.obs.Tracer.device_summary``), over the pairs.  None where
the program records no such spans (it follows no profiler, or has no Γ
mode), where its tracer dropped spans, where the spans are not the same
number in every pair, or off CUDA."""

NAMES = ("gamma:fold", "gamma:unfold")


def read(facts):
    if facts.get("trace") is None or not facts.get("pairs"):
        return None
    from repro_torch.obs import get_tracer
    tr = get_tracer()
    query = getattr(tr, "device_summary", None)
    if query is None or tr.dropped:
        return None
    spans = query()
    got = [spans.get(name) for name in NAMES]
    if any(s is None or s["count"] % facts["pairs"] or s["device_ms"] is None
           for s in got):
        return None
    return sum(s["device_ms"] for s in got) / facts["pairs"]
