"""The 95th percentile of staleness, in ms: from an update's
acknowledgement on its replica to its first appearance in the other
replica's ``on_diffs`` feed, by the host clock, over the window's
updates acknowledged before its last anti-entropy round began (those a
later write overwrote before they appeared are counted apart)."""


def read(run):
    p = run.e2e.get("staleness_p95_ms") if run.e2e else None
    return p["value"] if p else None
