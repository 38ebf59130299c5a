"""The share of the window's anti-entropy rounds whose push was cut at
``max_sync_size`` buckets, in %: ``Replica.stats()["sync"]``'s
``capped_rounds`` over its ``rounds`` (one a tick a neighbour), read at
the window's start and end. A program without those counters gives
none."""


def read(run):
    rounds = run.counters.get("sync_rounds")
    return 100.0 * run.counters["sync_capped"] / rounds if rounds else None
