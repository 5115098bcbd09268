"""pairs_ms: device milliseconds a step in the program's span
``step.pairs`` (the census field on the gamma-gamma grid, its fit, the
opacity, pair production and annihilation rates), from
``compton2d_tpu_torch.telemetry`` over the traced stretch's steps
(``harness/program_trace.py``); nothing where the cell has no pairs."""
from pathlib import Path

from harness import program_trace

ROOT = Path(__file__).resolve().parent.parent


def _ms(rec):
    span = rec["snapshot"]["spans"].get("step.pairs")
    return None if span is None else span["device_ms"]


def read(m):
    return program_trace.per_step(m, ROOT, _ms)
