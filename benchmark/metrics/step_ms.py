"""step_ms: the window's milliseconds over its steps on one card, the
restores of the segment replay included."""


def read(m):
    if m.workload["kind"] != "segment" or m.world > 1:
        return None
    return 1e3 * m.window_s / m.steps
