"""put_ms.expert: mean host-clock milliseconds of the program's
``expert.put`` span (``train_batch``'s host->device copies of the batch's
texts and images) over the profiled trainer steps."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "expert":
        return None
    return program_spans.mean_ms(rec, "expert.put")
