"""The bytes the plan executor's relayout copies read and write (each
copy reads its tensor once and writes it once: twice the ``bytes`` the
program's ``relayout`` spans carry), in GB per pair, over the window.
None where the program records no such spans (it follows no profiler),
where its tracer dropped spans, or where the spans are not the same
number in every pair."""


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
    rel = spans.get("relayout", {"count": 0, "bytes": 0})
    if rel["count"] % facts["pairs"]:
        return None
    return 2 * rel["bytes"] / 1e9 / facts["pairs"]
