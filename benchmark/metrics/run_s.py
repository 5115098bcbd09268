"""run_s: the window's seconds over the whole runs to t_stop it
completed (outputs and post-processing included)."""


def read(m):
    if m.workload["kind"] != "to_tstop":
        return None
    return m.window_s / m.units
