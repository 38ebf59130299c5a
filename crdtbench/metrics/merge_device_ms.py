"""Device milliseconds a call of the merge (``fanout_merge_into``,
retries included), from the profiler's trace: the device operations
launched inside the driver's ``merge`` span, over the traced calls."""


def read(run):
    calls = run.work.get("calls") if run.trace is not None else None
    if not calls:
        return None
    s = run.trace.span_device_s.get("merge")
    return s / calls * 1e3 if s else None
