"""``idle_share`` (the traced window's share with no device operation)
in the cells that report no ``merges_per_s`` end to end."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
