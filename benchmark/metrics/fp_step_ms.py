"""fp_step_ms: milliseconds a step in the spans of layer ``fp``
(``layers/fp.json``) over the window, on the slowest rank."""


def read(m):
    return m.spans_ms["fp"] / m.steps
