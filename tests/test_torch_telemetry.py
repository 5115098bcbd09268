"""The port's telemetry (``compton2d_tpu_torch.telemetry``) on the CPU:
off it reads no clock and changes nothing; on, its spans nest, its read
sites count the loops' condition tests, its spans land on a profiler
trace's clock, and on 2 gloo ranks it counts the exchange."""
import json
import os
import time

import pytest
import torch

from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.fp import update
from compton2d_tpu_torch.parallel.distributed import run_ranks
from compton2d_tpu_torch.physics import emissivity
from compton2d_tpu_torch.transport import flight

torch.set_num_threads(2)

SMALL = dict(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50, n_vol=64,
             nphfield=64, device="cpu")
# the gate's pair corona (tools/pallas_e2e.py), at SMALL's size
PAIRS = dict(SMALL, pair_switch=1, amxwl=0.5, gmin=3.0, gmax=20.0)


@pytest.fixture(autouse=True)
def telemetry_off():
    tm.disable()
    tm.reset()
    yield
    tm.disable()
    tm.reset()


def _forbid_clocks(monkeypatch):
    """Make every clock, CUDA event and record_function raise."""
    def boom(*a, **k):
        raise AssertionError("telemetry off touched a clock or an event")

    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)


def _run(sim, steps):
    outs = [sim.step() for _ in range(steps)]
    return outs


def test_off_span_and_read_take_no_clock(monkeypatch):
    _forbid_clocks(monkeypatch)
    a, b = tm.span("step"), tm.span("step.fp")
    assert a is tm.OFF and b is tm.OFF
    with a:
        assert tm.read("fp.done", torch.tensor(True), bool) is True
        assert tm.read("track.it_used", torch.tensor(7), int) == 7
        assert torch.equal(tm.read("step.outputs", torch.ones(3),
                                   tm.to_host), torch.ones(3))
    tm.count("fp.substeps", 5)
    snap = tm.snapshot()
    assert snap["spans"] == {} and snap["reads"] == {} \
        and snap["counts"] == {}


def test_off_no_clock_event_or_record_function_at_any_site(monkeypatch,
                                                           tmp_path):
    """A corona step, a pair corona step and a blob step with its event
    file and outputs, to t_stop and post-processed, with every clock
    forbidden; the pair step computes none of its counts."""
    from compton2d_tpu_torch import run_mrk421
    from compton2d_tpu_torch.examples import mrk421
    from compton2d_tpu_torch.io import events

    counted = []
    count = tm.count
    monkeypatch.setattr(tm, "count", lambda name, n: (
        counted.append(name), count(name, n)))
    _forbid_clocks(monkeypatch)
    _run(small_corona(**SMALL), 2)
    _run(small_corona(**PAIRS), 2)
    assert not [c for c in counted if c.startswith("pairs.")]
    assert tm._card_counts == {}
    sim = mrk421(nz=4, nr=2, nst=400, n_slots=4096, num_nt=60, n_vol=32,
                 nphfield=32, n_e=2e6, device="cpu")
    d = str(tmp_path)
    sim.attach_outputs(d)
    sim.step()
    sim.finalize_outputs()
    ev = events.read_event_file(os.path.join(d, "evb.dat"))
    run_mrk421.postprocess(ev, sim.cfg.grid.r_max, d)


def _state_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, tuple):
            _state_equal(x, y)


def test_on_and_off_give_bitwise_equal_steps():
    """The corona and the pair corona, whose counts are kept on the card
    while on."""
    for kw in (SMALL, PAIRS):
        tm.reset()
        off = small_corona(**kw)
        outs_off = _run(off, 2)
        tm.enable()
        on = small_corona(**kw)
        outs_on = _run(on, 2)
        tm.disable()
        _state_equal(off.state, on.state)
        for a, b in zip(outs_off, outs_on):
            _state_equal(a, b)
        snap = tm.snapshot()
        assert snap["spans"]["step"]["calls"] == 2
        assert ("pairs.gg_photons" in snap["counts"]) == (kw is PAIRS)


def _inside(child, parents) -> bool:
    return any(p0 <= c0 and c1 <= p1 for p0, p1 in parents
               for c0, c1 in [child])


def test_spans_nest_within_their_parents():
    sim = small_corona(**SMALL)
    tm.enable()
    _run(sim, 2)
    snap = tm.snapshot()["spans"]
    tree = {"step": ["step.census", "step.zone_pass", "step.source",
                     "step.track", "step.fp", "step.outputs"],
            "step.track": ["track.tables", "track.flight", "track.leak"]}
    for parent, kids in tree.items():
        kids = [k for k in kids if k in snap]
        assert len(kids) >= 3, (parent, sorted(snap))
        assert sum(snap[k]["host_ms"] for k in kids) \
            <= snap[parent]["host_ms"]
        for k in kids:
            for iv in snap[k]["intervals"]:
                assert _inside(iv, snap[parent]["intervals"]), (k, parent)
    assert snap["step"]["calls"] == 2
    assert snap["step.fp"]["calls"] == 2
    # the census is timed in two stretches a step (before and after the
    # budget), the sourcing likewise (the budget, then the emission)
    assert snap["step.census"]["calls"] == 4
    assert snap["step.source"]["calls"] == 4


def test_pair_spans_nest_under_step_pairs():
    sim = small_corona(**PAIRS)
    tm.enable()
    _run(sim, 2)
    snap = tm.snapshot()["spans"]
    kids = ("pairs.field", "pairs.fit", "pairs.rates")
    assert snap["step.pairs"]["calls"] == 2
    for k in kids:
        assert snap[k]["calls"] == 2
        for iv in snap[k]["intervals"]:
            assert _inside(iv, snap["step.pairs"]["intervals"]), k
    assert sum(snap[k]["host_ms"] for k in kids) \
        <= snap["step.pairs"]["host_ms"]
    # in order inside each step: the field, its fit, the rates
    for i in range(2):
        ends = [snap[k]["intervals"][i] for k in kids]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


def test_pair_counts_equal_counts_made_directly(monkeypatch):
    """``pairs.gg_photons``: the census photons alive with an energy on
    the gamma-gamma grid (above one ratio under its first point);
    ``pairs.fit_zones``: the zones whose raw field tops 1 in its 2nd and
    10th bins (pp2d.f:384-386); each over two steps."""
    from compton2d_tpu_torch import driver

    want = {"pairs.gg_photons": 0, "pairs.fit_zones": 0}
    real = driver.pair_fields

    def spy(photons, zones, tables, *a, **k):
        x = (torch.log(photons.e) - tables.e_gg_log0) / tables.e_gg_dlog
        want["pairs.gg_photons"] += int(torch.sum(photons.alive & (x > -1)))
        pf = real(photons, zones, tables, *a, **k)
        raw = pf.nph_raw.reshape(-1, pf.nph_raw.shape[-1])
        want["pairs.fit_zones"] += int(torch.sum((raw[:, 1] > 1)
                                                 & (raw[:, 9] > 1)))
        return pf

    monkeypatch.setattr(driver, "pair_fields", spy)
    sim = small_corona(**PAIRS)
    tm.enable()
    _run(sim, 2)
    counts = tm.snapshot()["counts"]
    assert want["pairs.gg_photons"] > 0 and want["pairs.fit_zones"] > 0
    assert {k: counts[k] for k in want} == want


def test_fp_done_reads_are_the_substep_loop_tests():
    sim = small_corona(**SMALL)
    tm.enable()
    outs = _run(sim, 3)
    snap = tm.snapshot()
    subs = sum(int(o.fp_substeps) for o in outs)
    assert all(int(o.fp_substeps) < sim.cfg.physics.fp_max_substeps
               for o in outs)
    assert snap["counts"]["fp.substeps"] == subs
    assert snap["reads"]["fp.done"]["count"] == subs + len(outs)
    assert snap["reads"]["fp.done"]["wait_ms"] >= 0.0


def test_track_more_reads_are_the_round_loop_tests():
    sim = small_corona(**SMALL)
    assert sim.tracker == "kernel"
    tm.enable()
    outs = _run(sim, 3)
    snap = tm.snapshot()
    rounds = sum(int(o.tallies.trk_rounds) for o in outs)
    assert snap["counts"]["track.rounds"] == rounds
    assert snap["reads"]["track.more"]["count"] == rounds + len(outs)
    assert snap["spans"]["track.flight"]["calls"] == rounds
    assert snap["spans"]["track.tables"]["calls"] == len(outs)
    # the census's roulette trigger is read once a step
    assert snap["reads"]["census.trigger"]["count"] == len(outs)


def test_loop_tracker_counts_its_condition_reads():
    import dataclasses

    sim = small_corona(**SMALL)
    sim = sim.with_config(dataclasses.replace(sim.cfg, run=dataclasses.replace(
        sim.cfg.run, pallas_tracking="off")))
    assert sim.tracker == "loop"
    tm.enable()
    outs = _run(sim, 2)
    snap = tm.snapshot()
    its = sum(int(o.tallies.trk_rounds) for o in outs)
    assert snap["counts"]["loop.iterations"] == its
    assert snap["reads"]["loop.more"]["count"] == its + len(outs)
    assert snap["reads"]["loop.scatter"]["count"] == its
    assert "track.more" not in snap["reads"]


def test_read_counts_each_site_and_its_wait():
    def slow(x):
        time.sleep(0.002)
        return int(x)

    tm.enable()
    assert tm.read("track.it_used", torch.tensor(3), slow) == 3
    tm.read("track.it_used", torch.tensor(4), slow)
    tm.read("fp.done", torch.tensor(False), bool)
    tm.count("track.rounds", 2)
    tm.count("track.rounds", 1)
    snap = tm.snapshot()
    assert snap["reads"]["track.it_used"]["count"] == 2
    assert snap["reads"]["track.it_used"]["wait_ms"] >= 4.0
    assert snap["reads"]["fp.done"]["count"] == 1
    assert snap["counts"] == {"track.rounds": 3}
    assert snap["launches"] == dict(flight.launch_counts(),
                                    **update.launch_counts(),
                                    **emissivity.launch_counts())
    tm.reset()
    assert tm.snapshot()["reads"] == {}


def test_snapshot_reads_each_registered_kernel_modules_launches(
        monkeypatch):
    """A kernel module hands its launch counts to the telemetry once; the
    snapshot reads them as they stand, and a reset of the module's count
    shows there."""
    monkeypatch.setattr(tm, "_launches", dict(tm._launches))
    tm.register_launches("tests.kernel", lambda: {"tests_kernel": 7})
    update.reset_launch_counts()
    launches = tm.snapshot()["launches"]
    assert launches["tests_kernel"] == 7
    assert launches["fp_substeps"] == 0
    assert set(flight.launch_counts()) < set(launches)


def test_span_lies_on_the_profiler_trace_clock(tmp_path):
    """A span put on the Unix clock by the anchor lies within 1 ms of its
    own record_function event (baseTimeNanoseconds + ts)."""
    from torch.profiler import ProfilerActivity, profile

    tm.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tm.span("step.probe"):
                torch.ones(1000).cumsum(0)
                time.sleep(0.003)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    marks = sorted((base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3)
                   for e in doc["traceEvents"]
                   if e.get("name") == "span:step.probe")
    mine = tm.snapshot()["spans"]["step.probe"]["intervals"]
    assert len(marks) == len(mine) == 3
    for (a, b), (c, d) in zip(marks, sorted(mine)):
        assert abs(a - c) < 1e6 and abs(b - d) < 1e6


def _exchange_rank(mesh, steps):
    from compton2d_tpu_torch import telemetry
    from compton2d_tpu_torch.examples import small_corona as sc

    sim = sc(mesh=mesh, **SMALL)
    sim.step()
    comm0 = mesh.comm_s
    telemetry.enable()
    for _ in range(steps):
        sim.step()
    snap = telemetry.snapshot()
    return {"spans": snap["spans"]["mesh.exchange"]["calls"],
            "reads": snap["reads"]["mesh.buffer"]["count"],
            "comm_calls": mesh.comm_calls, "comm_grew": mesh.comm_s > comm0}


def test_mesh_exchange_counted_on_two_gloo_ranks(tmp_path):
    res = run_ranks(_exchange_rank, 2, (2,), backend="gloo", device="cpu",
                    timeout_s=240.0, init_timeout_s=60.0, threads=1,
                    rendezvous_dir=str(tmp_path))
    for r in res:
        assert r["spans"] >= 2 and r["reads"] == r["spans"]
        assert r["comm_grew"]
