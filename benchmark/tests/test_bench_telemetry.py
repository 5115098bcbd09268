"""The readers of the program's telemetry (``harness/program_trace.py``
and the five metrics that read it) on synthetic records and traces, and
the stretch's telemetry measured on a tiny cell on the CPU."""
from types import SimpleNamespace

import pytest

from harness import program_trace as pt
from harness import specs

NAMES = ("census_source_ms", "host_reads_per_step", "host_read_wait_ms",
         "fp_idle_pct", "fp_kernels_per_substep")
MS = 1_000_000      # nanoseconds


def _span(intervals, device_ms=None):
    return {"calls": len(intervals), "intervals": intervals,
            "host_ms": sum(b - a for a, b in intervals) / MS,
            "device_ms": device_ms}


def _record():
    snap = {
        "spans": {"step.census": _span([[0, 2 * MS], [3 * MS, 4 * MS]], 3.0),
                  "step.source": _span([[2 * MS, 3 * MS]], 1.5),
                  "step.fp": _span([[10 * MS, 20 * MS]], 9.0)},
        "reads": {"fp.done": {"count": 9, "wait_ms": 4.0},
                  "track.more": {"count": 3, "wait_ms": 2.0}},
        "counts": {"fp.substeps": 7}, "launches": {}, "anchor": [0, 0]}
    return {"steps": 3, "snapshot": snap,
            "trace": {"fp_idle_pct": 80.0, "fp_kernels": 70,
                      "fp_substeps": 7}}


def test_readers_on_a_synthetic_record():
    m = SimpleNamespace(program_trace=_record())
    got = {n: specs.load_metric(n).read(m) for n in NAMES}
    assert got == pytest.approx({
        "census_source_ms": 1.5, "host_reads_per_step": 4.0,
        "host_read_wait_ms": 2.0, "fp_idle_pct": 80.0,
        "fp_kernels_per_substep": 10.0})


def test_readers_find_nothing_without_the_programs_telemetry(monkeypatch,
                                                             capsys):
    """A program without the telemetry module (the parent of the PR that
    added it) gives no record: each reader returns None, nothing runs."""
    monkeypatch.setattr(pt, "has_telemetry", lambda: False)
    monkeypatch.setattr(pt, "measure", lambda *a: pytest.fail("measured"))
    m = SimpleNamespace(world=1, workload={}, cfg=None)
    assert [specs.load_metric(n).read(m) for n in NAMES] == [None] * 5
    assert "# gaps" not in capsys.readouterr().out
    # no device trace (the CPU): the device metrics read nothing
    m = SimpleNamespace(program_trace=dict(_record(), trace=None))
    assert specs.load_metric("fp_idle_pct").read(m) is None
    assert specs.load_metric("fp_kernels_per_substep").read(m) is None


def _x(cat, ts_us, dur_us, corr=None, name="k"):
    e = {"ph": "X", "cat": cat, "ts": ts_us, "dur": dur_us, "name": name}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.mark.parametrize("runtime", [True, False])
def test_fp_idle_kernels_and_gaps_from_a_cuda_only_trace(runtime):
    """step.fp spans 10-20 ms and kernels run at 10-12, 15-16 and
    19.5-19.6 ms in it (busy 3.1 of 10 ms), launched at 9.5 (before FP),
    14 and 19 ms by the runtime, or counted at their starts; three more
    kernels and a memset run after it. Each gap takes the innermost span
    open at its start."""
    base = 5 * MS
    ev = [_x("kernel", 5000, 2000, 1), _x("kernel", 10000, 1000, 2),
          _x("kernel", 14500, 100, 3), _x("kernel", 17000, 100, 4),
          _x("gpu_memset", 30000, 100), _x("kernel", 40000, 100, 5),
          _x("kernel", 45000, 100, 6)]
    if runtime:
        ev += [_x("cuda_runtime", t, 5, c) for t, c in (
            (4500, 1), (9000, 2), (14000, 3), (16500, 4), (39000, 5),
            (44000, 6))]
    snap = {"spans": {"step": _span([[0, 40 * MS]]),
                      "step.fp": _span([[10 * MS, 20 * MS]]),
                      "step.outputs": _span([[25 * MS, 36 * MS]])},
            "counts": {"fp.substeps": 2}}
    t = pt.summarize(ev, base, snap)
    assert t["fp_idle_pct"] == pytest.approx(100.0 * (1 - 3.1 / 10))
    assert t["fp_kernels"] == (2 if runtime else 3)
    assert t["fp_substeps"] == 2
    assert t["launch_from_runtime_pct"] == (100.0 if runtime else 0.0)
    gaps = dict(t["idle_gaps"])
    assert gaps == pytest.approx({"step.fp": 8.9e-3, "step": 12.9e-3,
                                  "step.outputs": 9.9e-3,
                                  "outside": 4.9e-3})
    assert t["idle_s"] == pytest.approx(36.6e-3)
    assert t["named_idle_pct"] == pytest.approx(100.0 * 31.7 / 36.6)


def test_step_time_outside_its_children():
    snap = {"spans": {"step": _span([[0, 10 * MS], [20 * MS, 30 * MS]]),
                      "step.census": _span([[1 * MS, 4 * MS]]),
                      "step.fp": _span([[4 * MS, 9 * MS],
                                        [20 * MS, 29 * MS]]),
                      "track.flight": _span([[0, 10 * MS]])}}
    assert pt.step_outside_pct(snap) == pytest.approx(15.0)
    assert pt.step_outside_pct({"spans": {}}) is None


def test_stretch_telemetry_of_a_tiny_cell_on_the_cpu(tiny_root):
    """Runs 1 and 3 of the stretch (no device trace on the CPU): the
    snapshot counts the stretch's reads, its FP substeps and its spans."""
    w = specs.load_workload("tiny_corona.evolve", tiny_root)
    cfg, _ = specs.sim_config(specs.load_config(w["config"], tiny_root), w,
                              2 ** 31 + 9)
    m = SimpleNamespace(workload=w, cfg=cfg, world=1)
    rec = pt.measure(m, tiny_root, "cpu")
    assert rec["steps"] == w["trace_steps"] and rec["trace"] is None
    assert rec["spans_from"] == "unprofiled"
    snap = rec["snapshot"]
    assert snap["spans"]["step"]["calls"] == rec["steps"]
    subs = snap["counts"]["fp.substeps"]
    assert snap["reads"]["fp.done"]["count"] == subs + rec["steps"]
    assert 0.0 <= rec["step_outside_pct"] < 100.0
    assert rec["plain_s"] > 0 and rec["telemetry_s"] > 0
