"""Whole runs of tiny cells on the CPU, the chip check skipped: the last
line's keys, the segment replay's repeatability, a cell and a metric
added as new files, and the check failing under each fault the cells can
have."""
import json
import time

import pytest
import torch

from conftest import run_cell

E2E_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_last_line_keys_and_a_correct_run(tiny_root):
    res = run_cell(tiny_root, "tiny_corona.evolve")
    assert E2E_KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "histories_per_s", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


def test_traced_run_reports_its_per_layer_metrics(tiny_root):
    res = run_cell(tiny_root, "tiny_blob.run", trace=1)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the idle share has nothing to read
    assert set(res["metrics"]) == {
        "fp_step_ms", "fp_roofline_pct", "volume_em_ms",
        "volume_em_roofline_pct", "transport_ms", "tracking_roofline_pct",
        "outputs_ms"}


def test_segment_replay_repeats_bitwise(tiny_root):
    """Two repetitions from the restored state and random stream give
    the same tallies and zones, bit for bit."""
    from harness.cell import Capture, CellRun

    cell = CellRun("tiny_corona.evolve", 12345, 0.0, "cpu", root=tiny_root)
    cell.setup()
    runs = []
    for _ in range(2):
        cap = Capture()
        cell.unit(capture=cap)
        runs.append(cap)
    a, b = runs
    for (_, ga, oa), (_, gb, ob) in zip(a.steps, b.steps):
        assert torch.equal(ga, gb)
        for x, y in zip(oa.tallies, ob.tallies):
            assert torch.equal(x, y)
    for x, y in zip(a.final.zones, b.final.zones):
        assert torch.equal(x, y)
    cell.close()


def test_new_cell_and_metric_as_new_files(tiny_root):
    """A cell and a per-layer metric added as files of their own run
    with no existing file edited."""
    before = {p: p.read_bytes() for p in tiny_root.rglob("*")
              if p.is_file()}
    w = json.loads((tiny_root / "workloads" /
                    "tiny_corona.evolve.json").read_text())
    w["nst"] = 2000
    (tiny_root / "workloads" / "tiny_corona.dummy.json").write_text(
        json.dumps(w))
    (tiny_root / "metrics" / "dummy_share_pct.py").write_text(
        "def read(m):\n    return 100.0 * m.steps / (m.steps + 1)\n")
    bench_path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "tiny_corona.dummy",
                               "config": "tiny_corona", "traffic": "dummy",
                               "chips": 1, "why": w["why"]})
    bench["per_layer"].append({"name": "dummy_share_pct", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "histories_per_s",
                               "workloads": ["tiny_corona.dummy"]})
    bench_path.write_text(json.dumps(bench))
    res = run_cell(tiny_root, "tiny_corona.dummy", trace=1)
    assert res["correct"] is True
    assert 0 < res["metrics"]["dummy_share_pct"]["value"] < 100
    for p, data in before.items():
        assert p.read_bytes() == data, p


# ---- faults: each breaks the timed path and must read as not correct --

def _unchanged_state(monkeypatch):
    from compton2d_tpu_torch import driver
    impl = driver._step_impl

    def stuck(state, *a, **k):
        _, out = impl(state, *a, **k)
        return state, out
    monkeypatch.setattr(driver, "_step_impl", stuck)


def _half_batch(monkeypatch):
    from compton2d_tpu_torch import driver
    track = driver.transport_step

    def half(photons, *a, **k):
        keep = torch.arange(photons.n_slots) % 2 == 0
        photons = photons._replace(
            alive=photons.alive & keep,
            w=torch.where(keep, 2.0 * photons.w, photons.w))
        return track(photons, *a, **k)
    monkeypatch.setattr(driver, "transport_step", half)


def _altered_answer(monkeypatch):
    from compton2d_tpu_torch import driver
    track = driver.transport_step

    def altered(*a, **k):
        ph, tl, ev = track(*a, **k)
        return ph, tl._replace(edep=tl.edep * 1.001), ev
    monkeypatch.setattr(driver, "transport_step", altered)


def _altered_record(monkeypatch):
    from compton2d_tpu_torch.io import events
    write = events.EventFileWriter.write

    def altered(self, ev):
        ev = ev._replace(data=ev.data * torch.tensor(
            [1.0, 1.001, 1.0, 1.0, 1.0, 1.0, 1.0]))
        return write(self, ev)
    monkeypatch.setattr(events.EventFileWriter, "write", altered)


@pytest.mark.parametrize("cell, fault", [
    ("tiny_corona.evolve", _unchanged_state),
    ("tiny_corona.evolve", _half_batch),
    ("tiny_corona.evolve", _altered_answer),
    ("tiny_blob.run", _unchanged_state),
    ("tiny_blob.run", _half_batch),
    ("tiny_blob.run", _altered_answer),
    ("tiny_blob.run", _altered_record)])
def test_fault_reads_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_cell(tiny_root, cell)
    assert res["correct"] is False, res["checks"]


def _initial_dt_off(monkeypatch):
    """The program's first time step 1% long: every later step follows
    from the program's own state, so only the reference's own run from
    t = 0 can see it."""
    from compton2d_tpu_torch import driver
    dt = driver.initial_dt
    monkeypatch.setattr(driver, "initial_dt",
                        lambda *a, **k: 1.01 * dt(*a, **k))


@pytest.mark.parametrize("cell", ["tiny_corona.evolve", "tiny_blob.run"])
def test_fault_only_the_free_run_sees(tiny_root, monkeypatch, cell):
    _initial_dt_off(monkeypatch)
    res = run_cell(tiny_root, cell)
    checks = res["checks"]
    assert checks["step_rel"]["value"] <= checks["step_rel"]["limit"]
    assert checks["free_rel"]["value"] > checks["free_rel"]["limit"]
    assert res["correct"] is False


def no_exchange():
    """Each rank keeps its own part of every summed exchange (the census
    energy, the tallies); the zone farm's gathers still run."""
    from compton2d_tpu_torch.parallel import mesh
    real = mesh.exchange

    def local(m, parts):
        out = real(m, parts)
        return [t if op == mesh.SUM else o for (t, op), o in zip(parts, out)]
    mesh.exchange = local


def test_ranks_correct_and_exchange_left_out_not(tiny_root):
    """Two gloo ranks on the CPU: correct as they are, and not correct
    when the exchange between them is left out."""
    res = run_cell(tiny_root, "tiny_corona.ranks2", trace=1)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 2
    assert "exchange_ms" in res["metrics"]
    res = run_cell(tiny_root, "tiny_corona.ranks2", before=no_exchange)
    assert res["correct"] is False, res["checks"]
    assert set(res["metrics"]) == {"ranks_step_ms", "histories_per_s",
                                   "setup_s"}


LATE_S = 0.5


def late_rank_one():
    """Rank 1 enters its traced stretch ``LATE_S`` late."""
    from harness import cell

    traced = cell.CellRun.traced

    def late(self, spans):
        if self.mesh.rank == 1:
            time.sleep(LATE_S)
        return traced(self, spans)
    cell.CellRun.traced = late


def test_ranks_lined_up_before_the_traced_stretch(tiny_root):
    """Two gloo ranks, rank 1 late to its traced stretch: rank 0's
    unprofiled stretch does not hold the wait, and the ``# ranks`` line
    gives both ranks' figures."""
    import run as entry

    args = entry.parser().parse_args([
        "--workload", "tiny_corona.ranks2", "--seed", str(2 ** 31 + 9),
        "--seconds", "0", "--trace", "1"])
    rec = entry.collect(args, "cpu", tiny_root, late_rank_one)
    res, out_lines, _ = entry.result(args, rec, tiny_root)
    assert res["correct"] is True, res["checks"]
    lines = [x for x in out_lines if x.startswith("# ranks ")]
    assert len(lines) == 1
    ranks = json.loads(lines[0][len("# ranks "):])
    assert len(ranks) == 2
    for r in ranks:
        assert {"busy_s", "window_s", "profiled_s", "comm_kernel_s",
                "align_s", "core", "run_window_s", "setup_s", "host",
                "memory_peak_bytes"} <= set(r)
    w0, w1 = ranks[0]["window_s"], ranks[1]["window_s"]
    assert w0 < w1 + LATE_S / 2, ranks
