"""volume_em_ms: milliseconds a step in the spans of layer ``zone_pass``
(``layers/zone_pass.json``) over the window, on the slowest rank."""


def read(m):
    return m.spans_ms["zone_pass"] / m.steps
