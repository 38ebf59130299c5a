"""Operations an admission commit in the window: the front doors'
admitted operations over their commits (``Frontdoor.stats()``), a
program counter read at the window's start and end."""


def read(run):
    commits = run.counters.get("commits")
    return run.counters["admitted"] / commits if commits else None
