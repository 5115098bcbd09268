"""census_source_ms: device milliseconds a step in the program's spans
``step.census`` (census replay, roulette, zone sort) and ``step.source``
(budget, emission), from ``compton2d_tpu_torch.telemetry`` over the
traced stretch's steps (``harness/program_trace.py``)."""
from pathlib import Path

from harness import program_trace

ROOT = Path(__file__).resolve().parent.parent


def _ms(rec):
    spans = rec["snapshot"]["spans"]
    ms = [spans[k]["device_ms"] for k in ("step.census", "step.source")
          if k in spans]
    return sum(ms) if ms and None not in ms else None


def read(m):
    return program_trace.per_step(m, ROOT, _ms)
