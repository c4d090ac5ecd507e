"""idle_share.expert: the share of the profiled stretch's wall (host clock,
synchronized at both ends) in which no operation ran on the device (the
union of the trace's device intervals), in percent."""


def read(rec):
    tr = rec.trace
    if rec.kind != "expert" or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
