"""mfu.expert: model FLOPs of a trainer step (3 F(batch),
``flops.expert_step_flops``) times the steps per second of the window's
unprofiled part, over the configuration's peak (TF32: both cuDNN and the
program's kernels run the float32 convolutions on the tensor cores), in
percent."""

from h100_bench import flops


def read(rec):
    if rec.kind != "expert" or not rec.rate:
        return None
    peak = rec.cfg["expert"]["mfu_peak_flops"]
    return 100.0 * flops.expert_step_flops(rec.cfg) * rec.rate / peak
