"""step_host_ms.expert: mean host-clock milliseconds of the program's
``expert.step`` span (the whole of ``BiEncoderTrainer.train_batch``) over
the profiled trainer steps."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "expert":
        return None
    return program_spans.mean_ms(rec, "expert.step")
