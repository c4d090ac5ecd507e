"""unroll_saved_gib.distill: what the inner unroll leaves allocated for the
meta-backward: the CUDA allocator's ``memory_allocated()`` at the end of
the program's ``distill.unroll`` span less at its start, GiB, mean over
the profiled outer steps.  Nothing off a CUDA device."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "distill":
        return None
    got = program_spans.profiled(rec, "distill.unroll")
    if not got or got[0].mem0 is None:
        return None
    return sum(s.mem1 - s.mem0 for s in got) / len(got) / 2 ** 30
