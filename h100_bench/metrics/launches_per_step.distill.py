"""launches_per_step.distill: CUDA kernel launches (the runtime's launch events
in the profiled stretch) per step of the stretch."""


def read(rec):
    tr = rec.trace
    if rec.kind != "distill" or tr is None or not tr.launches:
        return None
    return tr.launches / tr.steps
