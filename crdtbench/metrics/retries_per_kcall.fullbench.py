"""``retries_per_kcall`` (tier retries of the merge entry a thousand
calls, the ``n_retries`` that ``fanout_merge_into`` returns) in the
cells that report no ``merges_per_s`` end to end."""


def read(run):
    calls = run.counters.get("calls")
    if not calls or "retries" not in run.counters:
        return None
    return run.counters["retries"] / calls * 1000.0
