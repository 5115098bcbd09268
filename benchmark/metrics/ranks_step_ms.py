"""ranks_step_ms: the window's milliseconds over its steps on several
ranks, the segment restores included (the slowest rank's window): a
step on several cards waits in each exchange for the slowest rank and
spreads apart from one card's, so its step time is a metric of its own,
with a bound of its own."""


def read(m):
    if m.workload["kind"] != "segment" or m.world < 2:
        return None
    return 1e3 * m.window_s / m.steps
