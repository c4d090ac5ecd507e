"""loader_ms.expert: mean host-clock milliseconds of the program's
``data.batch`` span (``ArrayPairLoader``'s gather of one batch) over the
profiled trainer steps."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "expert":
        return None
    return program_spans.mean_ms(rec, "data.batch")
