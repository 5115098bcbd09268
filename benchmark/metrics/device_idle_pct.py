"""device_idle_pct: the share of the traced stretch with no kernel, copy
or memset running on the device: the busy time of the stretch's profiled
run (torch.profiler) over the stretch's length run as the window runs it,
unprofiled; on several ranks the mean of the ranks."""


def read(m):
    t = m.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
