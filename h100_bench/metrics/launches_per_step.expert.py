"""launches_per_step.expert: CUDA kernel launches (the runtime's launch events
in the profiled stretch) per step of the stretch."""


def read(rec):
    tr = rec.trace
    if rec.kind != "expert" or tr is None or not tr.launches:
        return None
    return tr.launches / tr.steps
