"""transport_ms: milliseconds a step in the spans of layer ``tracking``
(``layers/tracking.json``) over the window, on the slowest rank."""


def read(m):
    return m.spans_ms["tracking"] / m.steps
