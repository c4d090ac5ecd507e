"""mfu.distill: model FLOPs of an outer step (``flops.distill_step_flops``)
times the outer steps per second of the window's unprofiled part, over the
peak of the configuration's compute dtype, in percent."""

from h100_bench import flops


def read(rec):
    if rec.kind != "distill" or not rec.rate:
        return None
    peak = rec.cfg["distill"]["mfu_peak_flops"]
    return 100.0 * flops.distill_step_flops(rec.cfg) * rec.rate / peak
