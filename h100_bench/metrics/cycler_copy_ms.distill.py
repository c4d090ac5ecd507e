"""cycler_copy_ms.distill: the host's milliseconds in ``ExpertCycler``'s
host->device copies (a miss's synchronous copy, a prefetch's pinning and
the enqueuing of its copy) per served segment: what the program's
``cycler`` counter ``copy_ns`` gained inside its ``cycler.segment`` span,
mean over the profiled outer steps."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "distill":
        return None
    return program_spans.mean_count_ms(rec, "cycler.segment", "copy_ns")
