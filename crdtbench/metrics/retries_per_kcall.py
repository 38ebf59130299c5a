"""Tier retries of the merge entry a thousand calls: the ``n_retries``
that ``fanout_merge_into`` returns, summed over every call of the
window (a program counter; each retry is a whole merge again, after a
kill-tier step, an insert-tier step or a compaction)."""


def read(run):
    calls = run.counters.get("calls")
    if not calls or "retries" not in run.counters:
        return None
    return run.counters["retries"] / calls * 1000.0
