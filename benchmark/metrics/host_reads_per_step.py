"""host_reads_per_step: the program's explicit device-to-host reads a
step, every read site of ``compton2d_tpu_torch.telemetry`` counted over
the traced stretch's steps (``harness/program_trace.py``)."""
from pathlib import Path

from harness import program_trace

ROOT = Path(__file__).resolve().parent.parent


def read(m):
    return program_trace.per_step(m, ROOT, lambda rec: sum(
        r["count"] for r in rec["snapshot"]["reads"].values()))
