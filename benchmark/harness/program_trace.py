"""The program's own telemetry over a traced stretch, for the readers of
the per-layer metrics that read it (``census_source_ms``,
``host_reads_per_step``, ``host_read_wait_ms``, ``fp_idle_pct``,
``fp_kernels_per_substep``).

The first of those readers to run measures, once a process, on a CUDA
card; the others read its record (kept on the readers' record ``m`` as
``m.program_trace``). It builds the cell again from its files and the
seed, runs the window's last repetition (the last stream of the seed's
order) and takes its last ``trace_steps`` steps, with a run's outputs of
those steps, as the traced stretch. That stretch then runs

1. as the window runs it, telemetry off, timed (``plain_s``);
2. under ``torch.profiler`` with CUDA activity alone and telemetry on
   (``profiled_s``): the device's busy intervals, each kernel's launch
   (the runtime's launch event of the same correlation, or the kernel's
   start where the trace has none: ``launch_from_runtime_pct``), and the
   program's spans put on the trace's clock (``baseTimeNanoseconds`` +
   ``ts``) by the telemetry's anchor;
3. unprofiled with telemetry on (``telemetry_s``): the telemetry's own
   cost beside ``plain_s``.

Span times and counters come from run 2, or from run 3 when run 2 took
more than 10% longer than run 1 (``spans_from``); the idle share inside
FP, the kernels a substep and the idle gaps from run 2 alone. Each idle
gap is labelled with the innermost program span open on the host when it
began ("outside" where none is); the labels go to a ``# gaps`` line.

A program without ``compton2d_tpu_torch.telemetry`` (or a cell on
several ranks, or no card) gives no record, and the readers leave their
metrics out.
"""
from __future__ import annotations

import bisect
import collections
import importlib.util
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import torch

from harness import specs
from harness.trace import DEVICE_CATS, _timed, _union

STRETCH_SLACK = 1.10        # run 2 over run 1 above which run 3 is read
# the direct children of the ``step`` span
STEP_CHILDREN = ("step.census", "step.zone_pass", "step.source",
                 "step.pairs", "step.track", "step.fp", "step.outputs")


def has_telemetry() -> bool:
    return importlib.util.find_spec("compton2d_tpu_torch.telemetry") \
        is not None


def workload_name(w: dict, root: Path) -> Optional[str]:
    """The name of the workload file whose contents are ``w``."""
    for p in sorted((root / "workloads").glob("*.json")):
        if specs.load_workload(p.stem, root) == w:
            return p.stem
    return None


def record(m, root: Path) -> Optional[dict]:
    """The program's telemetry of the traced stretch of ``m``'s cell,
    measured at the first call (on cuda:0) and kept on ``m``; None where
    there is nothing to measure."""
    if not hasattr(m, "program_trace"):
        ok = (m.world == 1 and torch.cuda.is_available()
              and has_telemetry())
        m.program_trace = measure(m, root, torch.device("cuda", 0)) \
            if ok else None
        if m.program_trace is not None:
            print("# gaps " + json.dumps(m.program_trace["gaps_line"]),
                  flush=True)
    return m.program_trace


def measure(m, root: Path, device) -> Optional[dict]:
    """Runs 1-3 of the module docstring on ``device`` (on the CPU run 2
    is left out: there is no device trace)."""
    from compton2d_tpu_torch import telemetry as tm
    from harness.cell import Capture, CellRun

    name = workload_name(m.workload, root)
    if name is None:
        return None
    device = torch.device(device)
    cell = CellRun(name, m.cfg.run.seed, 0.0, device, root=root)
    try:
        cell.setup()
        last = Capture()
        cell.unit(cell.order[-1], capture=last)
        k = min(cell.w["trace_steps"], len(last.steps))
        pre, g, _ = last.steps[-k]

        def stretch():
            cell.unit(start=(pre, g), n_steps=k, out_dir=cell._other())

        plain_s = _timed(stretch)[1]
        trace = None
        profiled_s = None
        snaps = {}
        if device.type == "cuda":
            tm.reset()
            tm.enable()
            try:
                events, base_ns, profiled_s = _profiled(stretch)
            finally:
                tm.disable()
            snaps["profiled"] = tm.snapshot()
            trace = summarize(events, base_ns, snaps["profiled"])
        tm.reset()
        tm.enable()
        try:
            telemetry_s = _timed(stretch)[1]
        finally:
            tm.disable()
        snaps["unprofiled"] = tm.snapshot()
        tm.reset()
    finally:
        cell.outputs.clear()
        cell.close()
    spans_from = ("profiled" if profiled_s is not None
                  and profiled_s <= STRETCH_SLACK * plain_s
                  else "unprofiled")
    snap = snaps[spans_from]
    rec = {"steps": k, "snapshot": snap, "spans_from": spans_from,
           "plain_s": plain_s, "profiled_s": profiled_s,
           "telemetry_s": telemetry_s, "trace": trace,
           "step_outside_pct": step_outside_pct(snap)}
    rec["gaps_line"] = {
        k2: rec[k2] for k2 in ("steps", "spans_from", "plain_s",
                               "profiled_s", "telemetry_s",
                               "step_outside_pct")}
    if trace is not None:
        rec["gaps_line"].update(
            {k2: trace[k2] for k2 in (
                "idle_gaps", "idle_s", "named_idle_pct", "busy_s",
                "launch_from_runtime_pct", "fp_kernels", "fp_substeps",
                "fp_idle_pct")})
    rec["gaps_line"]["reads"] = {s: v["count"] for s, v in
                                 snap["reads"].items()}
    rec["gaps_line"]["counts"] = snap["counts"]
    return rec


def _profiled(fn):
    """``fn()`` under the profiler with CUDA activity alone: the trace's
    events, its base time (ns) and the run's host seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = _timed(fn)[1]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    return doc.get("traceEvents", []), int(doc.get("baseTimeNanoseconds",
                                                   0)), s


def _length(intervals) -> float:
    return float(sum(b - a for a, b in intervals))


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _inside(intervals, t) -> bool:
    """Whether ``t`` lies in one of the sorted disjoint ``intervals``."""
    i = bisect.bisect_right([a for a, _ in intervals], t) - 1
    return i >= 0 and t < intervals[i][1]


def step_outside_pct(snap: dict) -> Optional[float]:
    """The share of the ``step`` span's host time outside every one of
    its children's spans."""
    sp = snap["spans"]
    if "step" not in sp:
        return None
    step = _union(sp["step"]["intervals"])
    kids = _union([iv for k in STEP_CHILDREN if k in sp
                   for iv in sp[k]["intervals"]])
    total = _length(step)
    return 100.0 * (total - _overlap(step, kids)) / total if total else None


def summarize(events, base_ns: int, snap: dict) -> dict:
    """From a CUDA-only trace (``ts``/``dur`` in microseconds after
    ``base_ns``) and the telemetry of the same run: the idle share inside
    ``step.fp``, the kernels launched inside it and the idle gaps by the
    innermost program span, all on the Unix clock in nanoseconds."""
    def ns(us):
        return base_ns + us * 1e3

    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    busy = _union([(ns(e["ts"]), ns(e["ts"] + e["dur"])) for e in dev])
    launch = {e["args"]["correlation"]: ns(e["ts"]) for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    kernels = [e for e in dev if e["cat"] == "kernel"]
    launched = [launch.get(e.get("args", {}).get("correlation"))
                for e in kernels]
    starts = [ns(e["ts"]) if t is None else t
              for e, t in zip(kernels, launched)]
    spans = snap["spans"]
    fp = _union(spans["step.fp"]["intervals"]) if "step.fp" in spans else []
    fp_len = _length(fp)
    fp_kernels = sum(1 for t in starts if _inside(fp, t))
    # each idle gap by the innermost span open at its start: the spans of
    # one thread nest, so of those open then, the one opened last
    opened = sorted((a, b, k) for k, v in spans.items()
                    for a, b in v["intervals"])
    opens = [a for a, _, _ in opened]
    gaps = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = "outside"
        for j in range(bisect.bisect_right(opens, a) - 1, -1, -1):
            if a < opened[j][1]:
                label = opened[j][2]
                break
        gaps[label] += (b - a) * 1e-9
    idle_s = sum(gaps.values())
    return {
        "busy_s": _length(busy) * 1e-9,
        "fp_s": fp_len * 1e-9,
        "fp_idle_pct": (100.0 * (1.0 - _overlap(busy, fp) / fp_len)
                        if fp_len else None),
        "fp_kernels": fp_kernels,
        "fp_substeps": snap["counts"].get("fp.substeps", 0),
        # the share of kernels timed by their runtime launch event (the
        # rest by their start on the device)
        "launch_from_runtime_pct": (
            100.0 * sum(t is not None for t in launched) / len(kernels)
            if kernels else None),
        "idle_gaps": [[k, v] for k, v in gaps.most_common()],
        "idle_s": idle_s,
        "named_idle_pct": (100.0 * (idle_s - gaps.get("outside", 0.0))
                           / idle_s if idle_s else None),
    }


def per_step(m, root: Path, what):
    """``what(record)`` over the stretch's steps, or None without a
    record."""
    rec = record(m, root)
    if rec is None:
        return None
    v = what(rec)
    return None if v is None else v / rec["steps"]

