"""unroll_host_ms.distill: mean host-clock milliseconds of the program's
``distill.unroll`` span (``Distiller._meta_grads``' inner unroll,
``grand_loss``) over the profiled outer steps."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "distill":
        return None
    return program_spans.mean_ms(rec, "distill.unroll")
