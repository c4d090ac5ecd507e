"""meta_backward_host_ms.distill: mean host-clock milliseconds of the
program's ``distill.meta_backward`` span (``torch.autograd.grad`` over the
unroll: the ``_FrCore`` backwards) over the profiled outer steps."""

from h100_bench import program_spans


def read(rec):
    if rec.kind != "distill":
        return None
    return program_spans.mean_ms(rec, "distill.meta_backward")
