"""The window's merge rate, per layer: every delta merged into every
receiving lane over the whole window's seconds (the driver's
``merges_per_s``, taken by the host's clock), in the cells whose runs
spread too widely on a shared host for it to stand end to end with a
bound."""


def read(run):
    rate = run.e2e.get("merges_per_s") if run.e2e else None
    return rate["value"] if rate else None
