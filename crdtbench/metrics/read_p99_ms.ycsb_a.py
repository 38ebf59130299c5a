"""The 99th percentile of a read's latency at the client, in ms: a
``read_keys([key])`` on the front door, timed by the host clock around
the call, over the window's reads."""


def read(run):
    p = run.e2e.get("read_p99_ms") if run.e2e else None
    return p["value"] if p else None
