"""fp_idle_pct: the share of the program's ``step.fp`` spans (their
union, on the host clock) with no kernel, copy or memset running on the
device, from the traced stretch's run under the profiler with CUDA
activity alone (``harness/program_trace.py``)."""
from pathlib import Path

from harness import program_trace

ROOT = Path(__file__).resolve().parent.parent


def read(m):
    rec = program_trace.record(m, ROOT)
    if rec is None or rec["trace"] is None:
        return None
    return rec["trace"]["fp_idle_pct"]
