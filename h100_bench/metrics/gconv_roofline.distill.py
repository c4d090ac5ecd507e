"""gconv_roofline.distill: the least time the grouped-conv work of the
profiled steps needs (the benchmark's own count, ``flops.gconv_step_bound_s``)
over the device time of every ``gconv3x3`` kernel in the stretch, in
percent.  Nothing when no such kernel ran."""

from h100_bench import flops


def read(rec):
    tr = rec.trace
    if rec.kind != "distill" or tr is None:
        return None
    t = tr.time_of("gconv3x3")
    if t <= 0:
        return None
    return 100.0 * tr.steps * flops.gconv_step_bound_s(rec.cfg, "distill") / t
