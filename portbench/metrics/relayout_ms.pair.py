"""The device time of the plan executor's relayout copies (the line
stages' and the kernel wrappers' copies of lines into GEMM order), per
pair: the window's ``relayout`` spans, timed by the program on the device
(``repro_torch.obs.Tracer.device_summary``), over the pairs.  None where
the program records no such spans (it follows no profiler), where its
tracer dropped spans, where the spans are not the same number in every
pair, or off CUDA."""


def read(facts):
    if facts.get("trace") is None or not facts.get("pairs"):
        return None
    from repro_torch.obs import get_tracer
    tr = get_tracer()
    query = getattr(tr, "device_summary", None)
    if query is None or tr.dropped:
        return None
    spans = query()
    if not spans:
        return None
    rel = spans.get("relayout", {"count": 0, "device_ms": 0.0})
    if rel["count"] % facts["pairs"] or rel["device_ms"] is None:
        return None
    return rel["device_ms"] / facts["pairs"]
