"""The device's busy time, its busiest kernels and its idle gaps, from a
``torch.profiler`` trace of a stretch of the cell's own work.

The stretch runs twice: first as the window runs it, timed on the host
clock with the card synchronised at both ends (``window_s``), then under
the profiler, whose cost on every operation the host launches stretches
the host's time (``profiled_s``, reported beside it). On several ranks
the ranks are lined up (``align``) before each run's clock starts, the
second time after the profiler has started, so that no rank's run holds
another's lateness. The device's work inside that second lining-up (the
annotation ``harness.align`` on the trace) is no part of the stretch and
is left out of every figure but ``align_s``, its length: how long this
rank waited for the last to start its profiler.

Busy time is the union of the intervals in which a kernel, a copy or a
memset ran on the device in the profiled run, less the collectives'
kernels (named ``nccl...``): on several ranks such a kernel runs from
its launch until every peer has arrived, so its length is mostly
waiting; their summed time is ``comm_kernel_s``. The idle share divides
busy time by ``window_s``, the stretch's own length. Each idle gap of
the profiled run is labelled with the innermost harness span open on the
host when it began ("unwrapped" outside every span); those gaps hold the
profiler's cost.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COMM_PREFIX = "nccl"
ALIGN = "harness.align"


def _timed(fn):
    """fn's result and its host seconds, the card synchronised at both
    ends."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile(fn, spans, align=None):
    """Run ``fn()`` as it is, timed, then again under the profiler, each
    time after ``align()`` where given; returns (the second result,
    trace)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    if align is not None:
        align()
    _, window_s = _timed(fn)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    spans.profiling = True
    try:
        with prof_ctx(activities=acts) as prof:
            if align is not None:
                with torch.profiler.record_function(ALIGN):
                    align()
            out, profiled_s = _timed(fn)
    finally:
        spans.profiling = False
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        nbytes = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return out, dict(summarize(events, window_s), profiled_s=profiled_s,
                     trace_bytes=nbytes)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, window_s: float, top: int = 10) -> dict:
    """busy_s, comm_kernel_s, align_s, window_s (as given), the ``top``
    device operations by time (the collectives' kernels among them) and
    the ``top`` labels of idle time, all in seconds, from chrome-trace
    events (``ts`` and ``dur`` in microseconds)."""
    aligns = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name") == ALIGN]
    dev, align_ops = [], []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            inside = any(a <= e["ts"] <= b for a, b in aligns)
            (align_ops if inside else dev).append(e)
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    comm = [e for e in dev if e["name"].startswith(COMM_PREFIX)]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev
                   if not e["name"].startswith(COMM_PREFIX)])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][5:])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("span:"))
    starts = [s[0] for s in spans]
    gaps = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = "unwrapped"
        for s in spans[:bisect.bisect_right(starts, a)]:
            if s[0] <= a < s[1]:
                label = s[2]       # the last opened of those still open
        gaps[label] += (b - a) * 1e-6
    return {
        "busy_s": busy_s,
        "comm_kernel_s": sum(e["dur"] for e in comm) * 1e-6,
        "align_s": sum(e["dur"] for e in align_ops) * 1e-6,
        "window_s": window_s,
        "device_ops": [[k, v] for k, v in by_name.most_common(top)],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(top)],
    }
