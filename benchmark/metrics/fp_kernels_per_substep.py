"""fp_kernels_per_substep: the kernels launched inside the program's
``step.fp`` spans over its FP substeps (the count ``fp.substeps``), both
from the traced stretch's run under the profiler with CUDA activity
alone (``harness/program_trace.py``: a kernel's launch is its runtime
launch event, or its start where the trace has none)."""
from pathlib import Path

from harness import program_trace

ROOT = Path(__file__).resolve().parent.parent


def read(m):
    rec = program_trace.record(m, ROOT)
    if rec is None or rec["trace"] is None:
        return None
    t = rec["trace"]
    return t["fp_kernels"] / t["fp_substeps"] if t["fp_substeps"] else None
