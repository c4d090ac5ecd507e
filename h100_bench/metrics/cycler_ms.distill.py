"""cycler_ms.distill: mean host-clock milliseconds of the window's
``ExpertCycler.next_segment_device()`` calls (a span the benchmark takes
around each call)."""


def read(rec):
    spans = rec.spans.get("cycler")
    if rec.kind != "distill" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
