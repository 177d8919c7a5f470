"""The device time of the pair-density product between the legs (the
product of each conduction band with conj(ψ_v) on the grid), per pair:
the window's ``mtxel:product`` spans, timed by the program on the device
(``repro_torch.obs.Tracer.device_summary``), over the pairs.  None where
the program records no such spans (it follows no profiler, or has no
such product), where its tracer dropped spans, where the spans are not
the same number in every pair, or off CUDA."""


def read(facts):
    if facts.get("trace") is None or not facts.get("pairs"):
        return None
    from repro_torch.obs import get_tracer
    tr = get_tracer()
    query = getattr(tr, "device_summary", None)
    if query is None or tr.dropped:
        return None
    prod = query().get("mtxel:product")
    if (prod is None or prod["count"] % facts["pairs"]
            or prod["device_ms"] is None):
        return None
    return prod["device_ms"] / facts["pairs"]
