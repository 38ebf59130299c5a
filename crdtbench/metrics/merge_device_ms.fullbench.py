"""``merge_device_ms`` (device milliseconds a call launched inside the
driver's ``merge`` span, retries included) in the cells that report no
``merges_per_s`` end to end."""


def read(run):
    calls = run.work.get("calls") if run.trace is not None else None
    if not calls:
        return None
    s = run.trace.span_device_s.get("merge")
    return s / calls * 1e3 if s else None
