"""Acknowledged operations a second through both front doors over the
whole window: reads returned and updates acknowledged by the window's
end, over its seconds (the driver's host clock)."""


def read(run):
    rate = run.e2e.get("ops_per_s") if run.e2e else None
    return rate["value"] if rate else None
