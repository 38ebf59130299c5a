"""The 99th percentile of an update's latency at the client, in ms: from
its ``mutate_async`` to the acknowledgement of its admission group's
commit (the ticket's resolution time), by the host clock, over the
updates acknowledged in the window."""


def read(run):
    p = run.e2e.get("update_p99_ms") if run.e2e else None
    return p["value"] if p else None
