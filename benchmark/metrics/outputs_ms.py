"""outputs_ms: milliseconds a run to t_stop in the spans of layer
``outputs`` (the event file, the run accumulator, finalize_outputs, the
event file read back, post-processing) over the window."""


def read(m):
    if m.workload["kind"] != "to_tstop":
        return None
    return m.spans_ms["outputs"] / m.units
