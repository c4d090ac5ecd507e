"""idle_share.distill: the share of the profiled stretch's wall (host clock,
synchronized at both ends) in which no operation ran on the device (the
union of the trace's device intervals), in percent."""


def read(rec):
    tr = rec.trace
    if rec.kind != "distill" or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
