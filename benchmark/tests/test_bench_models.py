"""The span wrappers and the work models, at hand-checked shapes."""
from types import SimpleNamespace

import pytest
import torch

from harness import peaks, specs
from harness.spans import Spans


def test_spans_restore_every_attribute():
    from compton2d_tpu_torch import driver, run_mrk421
    from compton2d_tpu_torch.io import events, outputs

    layers = specs.load_layers()
    before = {(m, a): specs_obj(m, a) for spans in layers.values()
              for m, a in spans}
    sp = Spans(layers, "cpu").install()
    assert driver.fp_step is not before[("compton2d_tpu_torch.driver",
                                         "fp_step")]
    sp.remove()
    after = {k: specs_obj(*k) for k in before}
    assert after == before
    assert events.EventFileWriter.write is before[
        ("compton2d_tpu_torch.io.events", "EventFileWriter.write")]
    assert run_mrk421.postprocess is before[
        ("compton2d_tpu_torch.run_mrk421", "postprocess")]
    assert outputs.OutputAccumulator.add_step is before[
        ("compton2d_tpu_torch.io.outputs", "OutputAccumulator.add_step")]


def specs_obj(module, attr):
    from harness.spans import _resolve
    owner, name = _resolve(module, attr)
    return getattr(owner, name)


def test_nested_calls_of_one_layer_open_one_span():
    import types
    mod = types.ModuleType("m")
    mod.inner = lambda: 1
    mod.outer = lambda: mod.inner() + 1
    import sys
    sys.modules["bench_test_mod"] = mod
    sp = Spans({"x": [("bench_test_mod", "inner"),
                      ("bench_test_mod", "outer")]}, "cpu").install()
    try:
        assert mod.outer() == 2
        assert sp.calls() == {"x": 1}
    finally:
        sp.remove()
        del sys.modules["bench_test_mod"]


def grid(**kw):
    g = dict(nz=2, nr=3, num_nt=10, n_vol=20, nphfield=30, nmu=4,
             nphtotal=50, nph_lc=2)
    g.update(kw)
    return SimpleNamespace(**g)


def model(steps=2, histories=1000, fp_substeps=7, world=1, spans=1.0,
          **g):
    cfg = SimpleNamespace(grid=grid(**g),
                          run=SimpleNamespace(zone_shard=True))
    return SimpleNamespace(cfg=cfg, steps=steps, histories=histories,
                           fp_substeps=fp_substeps, world=world,
                           spans_ms={"fp": spans, "zone_pass": spans,
                                     "tracking": spans})


def test_fp_work_model():
    m = model()
    z, n, p = 6, 10, 30
    nbytes = 2 * z * (2 * n * 4 + p * 4 + 64)
    flops = 2 * z * 2 * p * n + 7 * z * n * 60
    want = 100 * max(flops / peaks.PEAK_F32_S,
                     nbytes / peaks.PEAK_BYTES_S) / 1e-3
    assert specs.load_metric("fp_roofline_pct").read(m) == pytest.approx(
        want, rel=1e-12)
    # the zone farm: each of 4 ranks holds 2 of the 6 zones
    m4 = model(world=4)
    assert specs.load_metric("fp_roofline_pct").read(m4) == pytest.approx(
        want * 2 / 6, rel=1e-12)


def test_volume_em_work_model():
    m = model()
    flops = 2 * 6 * 20 * 10 * 90
    nbytes = 2 * (6 * (40 + 52 + 240) + 120)
    want = 100 * max(flops / peaks.PEAK_F32_S,
                     nbytes / peaks.PEAK_BYTES_S) / 1e-3
    assert specs.load_metric("volume_em_roofline_pct").read(m) == \
        pytest.approx(want, rel=1e-12)


def test_tracking_work_model():
    m = model()
    tables = 4 * (6 * 40 + 6 * 10 + 2 + 3 + 2 + 10)
    tallies = 4 * (24 + 6 * 30 + 4 * 50 + 4 * 2 + 4 + 6 + 20)
    nbytes = 1000 * 86 + 2 * (tables + tallies)
    want = 100 * nbytes / peaks.PEAK_BYTES_S / 1e-3
    assert specs.load_metric("tracking_roofline_pct").read(m) == \
        pytest.approx(want, rel=1e-12)


def test_work_models_read_only_shapes_and_named_counts():
    """A model that read a round, a log or a chunk count would fail on
    this record, which has none."""
    m = model()
    for name in ("fp_roofline_pct", "volume_em_roofline_pct",
                 "tracking_roofline_pct"):
        assert specs.load_metric(name).read(m) > 0


def test_idle_share_divides_by_the_unprofiled_stretch():
    """Busy time from the profiled run over the stretch's own length,
    not over the profiled run's longer host time."""
    from harness import trace

    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 300},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 200},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 900,
           "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "span:fp",
           "ts": 350, "dur": 600}]
    t = trace.summarize(ev, window_s=1e-3)
    assert t["busy_s"] == pytest.approx(5e-4)
    assert t["comm_kernel_s"] == 0
    assert t["idle_gaps"] == [["fp", pytest.approx(5e-4)]]
    m = SimpleNamespace(trace=dict(t, profiled_s=4e-3))
    assert specs.load_metric("device_idle_pct").read(m) == \
        pytest.approx(50.0)


def test_collective_kernels_are_left_out_of_busy_time():
    """A collective's kernel overlapping a compute kernel and running on
    alone into an idle stretch: busy time is the compute kernels' union
    alone, the collective's length is ``comm_kernel_s``, and it stays
    among the device operations."""
    from harness import trace

    nccl = "ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long)"
    base = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 300},
            {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 900,
             "dur": 100}]
    ev = base + [{"ph": "X", "cat": "kernel", "name": nccl, "ts": 100,
                  "dur": 700}]
    t = trace.summarize(ev, window_s=1e-3)
    assert t["busy_s"] == pytest.approx(4e-4)
    assert t["comm_kernel_s"] == pytest.approx(7e-4)
    assert [nccl, pytest.approx(7e-4)] in t["device_ops"]
    assert t["idle_gaps"] == [["unwrapped", pytest.approx(6e-4)]]
    # the same trace without the collective reads the same busy time
    t0 = trace.summarize(base, window_s=1e-3)
    assert t0["busy_s"] == t["busy_s"] and t0["comm_kernel_s"] == 0
    assert t0["idle_gaps"] == t["idle_gaps"]
    assert t0["align_s"] == t["align_s"] == 0


def test_the_ranks_lining_up_is_no_part_of_the_stretch():
    """The device's work inside the ``harness.align`` annotation (the
    lining-up's all_reduce, waiting for the last rank's profiler) is left
    out of every figure but ``align_s``."""
    from harness import trace

    stretch = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 2000,
                "dur": 300},
               {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather",
                "ts": 2400, "dur": 50}]
    ev = stretch + [
        {"ph": "X", "cat": "user_annotation", "name": trace.ALIGN, "ts": 0,
         "dur": 1900},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce",
         "ts": 10, "dur": 1800},
        {"ph": "X", "cat": "kernel", "name": "fill", "ts": 5, "dur": 2}]
    t, t0 = (trace.summarize(e, window_s=1e-3) for e in (ev, stretch))
    assert t["align_s"] == pytest.approx(1.802e-3)
    assert {k: v for k, v in t.items() if k != "align_s"} == \
        {k: v for k, v in t0.items() if k != "align_s"}
    assert t0["comm_kernel_s"] == pytest.approx(5e-5)


@pytest.mark.parametrize("aligned", [False, True])
def test_profile_times_the_stretch_before_profiling_it(aligned):
    """The stretch runs unprofiled, then under the profiler; ``align``,
    where given, runs before each, the second time under the profiler."""
    from harness import trace

    calls = []

    def mark(what):
        return lambda: calls.append(
            (what, torch.autograd._profiler_enabled())) or 7

    sp = Spans({}, "cpu")
    out, t = trace.profile(mark("run"), sp,
                           mark("align") if aligned else None)
    assert out == 7
    runs = [("run", False), ("run", True)]
    assert calls == ([("align", False), runs[0], ("align", True), runs[1]]
                     if aligned else runs)
    assert 0 < t["window_s"] and 0 < t["profiled_s"]
    assert not sp.profiling


@pytest.mark.parametrize("visible, index, card", [
    (None, 0, 0), (None, 3, 3), ("2", 0, 2), ("1,3", 1, 3),
    ("GPU-5f3a", 0, 0)])
def test_a_rank_is_pinned_by_the_card_it_drives(monkeypatch, visible,
                                                index, card):
    import run as entry

    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert entry.card_index(f"cuda:{index}") == card
