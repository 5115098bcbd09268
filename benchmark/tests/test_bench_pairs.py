"""The pair corona's cell (``pair_corona.evolve``): its pair fields held
against the frozen reference, its set-up guarded against a pair runaway,
and the work model of ``pairs_roofline_pct``. On the CPU at a few
thousand photons; the replayed step at the cell's own size needs a CUDA
card and skips without one:

    python3 -m pytest benchmark/tests/test_bench_pairs.py
"""
import json
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH
from harness import peaks, specs

FIELDS = ("k_gg", "dn_pp", "dne_pa", "dnp_pa")     # SimState's, per zone
ZONE_FIELDS = ("n_pos", "f_pair")                  # ZoneState's


def tiny_pairs(root, nst=3000, slots=4096) -> str:
    """The cell at the configuration's widths with a few thousand photons
    (two set-up steps, segments of two), as a new workload file."""
    w = json.loads((root / "workloads" / "pair_corona.evolve.json")
                   .read_text())
    w.update(nst=nst, slots=slots, setup_steps=2, segment_steps=2,
             check_steps=2, streams=[11, 12])
    (root / "workloads" / "tiny_pairs.evolve.json").write_text(json.dumps(w))
    return "tiny_pairs.evolve"


def pair_gaps(cell, cap, i: int, tf32: bool) -> dict:
    """Each pair field's gap (sum |p - r| / sum |r|) between the program's
    step ``i`` of ``cap`` (or, with ``tf32``, the reference's under TF32)
    and the reference's replay of it, with the program's largest value
    of the field."""
    from harness import check

    ref = check._reference(cell)
    new, _ = check._replay(ref, cap, cell.device, i, False)
    if tf32:
        got, _ = check._replay(ref, cap, cell.device, i, True)
    else:
        got = check._after(cap, i)
    out = {}
    for f in FIELDS + ZONE_FIELDS:
        p, r = ((getattr(got.zones, f), getattr(new.zones, f))
                if f in ZONE_FIELDS else (getattr(got, f), getattr(new, f)))
        out[f] = (check._gap(p, r), float(torch.max(torch.abs(p))))
    return out


def test_pair_fields_match_the_reference_on_the_cpu(tiny_root):
    """Two steps of the program from the set-up state, each replayed by
    the reference from the program's pre-step state: on the CPU the
    program's plain path and the frozen copy run the same operations in
    the same order on the same inputs, so every pair field is equal bit
    for bit (tolerance 0). Each field is nonzero in some step, so no
    comparison is empty."""
    from harness.cell import Capture, CellRun

    cell = CellRun(tiny_pairs(tiny_root), 2 ** 31 + 7, 0.0, "cpu",
                   root=tiny_root)
    try:
        cell.setup()
        cap = Capture()
        cell.unit(capture=cap)
        assert len(cap.steps) == 2
        largest = dict.fromkeys(FIELDS + ZONE_FIELDS, 0.0)
        for i in range(2):
            for f, (gap, top) in pair_gaps(cell, cap, i, False).items():
                assert gap == 0.0, (i, f, gap)
                largest[f] = max(largest[f], top)
        assert all(v > 0 for v in largest.values()), largest
    finally:
        cell.close()


def _setup_fpair(scale: dict, seed: int) -> torch.Tensor:
    from compton2d_tpu_torch.driver import Simulation

    c = specs.load_config("pair_corona")
    c["grid"].update(scale.get("grid", {}))
    c["windows"][0].update(scale.get("windows", {}))
    c["zones"].update(scale.get("zones", {}))
    w = dict(specs.load_workload("pair_corona.evolve"), nst=3000,
             slots=4096)
    cfg, zi = specs.sim_config(c, w, seed)
    sim = Simulation(cfg, zi, device="cpu")
    most = torch.zeros(())
    for _ in range(w["setup_steps"]):
        sim.step()
        f = sim.state.zones.f_pair
        assert torch.isfinite(f).all() and (f >= 0).all()
        most = torch.maximum(most, f.max())
    return most


# small_corona's scale: a 1e15 cm corona over a 0.5 keV disk (l 5.5e9)
GATE_SCALE = {"grid": {"z_max": 1e15, "r_max": 1e15},
              "windows": {"tbb_lower": 0.5}, "zones": {"n_e": 1e10}}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_setup_keeps_the_pair_fraction_below_one(seed):
    """The configuration's set-up steps leave f_pair finite, at or above 0
    and below 1 in every zone (a few thousand photons, whose noisy field
    overstates pair production: the card's 3.2e6 read up to 2.5e-3); at
    small_corona's compactness the same steps run away past 1."""
    assert float(_setup_fpair({}, seed)) < 1.0
    assert float(_setup_fpair(GATE_SCALE, seed)) > 1.0


def _record(counts, device_ms=2.0, steps=2):
    spans = {"step.pairs": {"calls": steps, "intervals": [],
                            "host_ms": 3.0, "device_ms": device_ms}}
    return {"steps": steps, "snapshot": {"spans": spans, "reads": {},
                                         "counts": counts, "launches": {}}}


def _m(**kw):
    g = SimpleNamespace(nz=2, nr=3, num_nt=10, n_gg=4)
    cfg = SimpleNamespace(grid=g, run=SimpleNamespace(n_slots=1000))
    return SimpleNamespace(cfg=cfg, **kw)


def test_pairs_work_model():
    """Z 6, N 10, G 4, 1000 slots, 2 steps, 300 photons on the grid and 8
    zones fitted over the stretch, 2 ms of ``step.pairs``."""
    z, n, g = 6, 10, 4
    nbytes = 2 * (1000 * 17 + z * 22 * 4 + z * 4
                  + (n * 16 + 16 + n * n + n + g) * 4 + (3 * z * g
                                                         + 3 * z * n) * 4)
    flops = (300 * 6 + 8 * g * 11
             + 2 * (z * g * 3 + z * 4368 * g * 20 + 2 * z * g * g
                    + 2 * z * n * g * g + 2 * z * n * g + 4 * z * n * n
                    + 8 * z * n))
    want = 100 * max(flops / peaks.PEAK_F32_S,
                     nbytes / peaks.PEAK_BYTES_S) / 2e-3
    m = _m(program_trace=_record({"pairs.gg_photons": 300,
                                  "pairs.fit_zones": 8}))
    assert specs.load_metric("pairs_roofline_pct").read(m) == \
        pytest.approx(want, rel=1e-12)
    assert specs.load_metric("pairs_ms").read(m) == pytest.approx(1.0)


def test_pairs_metrics_find_nothing_to_read_where_there_is_none():
    """Without the counters (a program before them) the share is left
    out; without the span (a cell without pairs) both are."""
    m = _m(program_trace=_record({}))
    assert specs.load_metric("pairs_roofline_pct").read(m) is None
    assert specs.load_metric("pairs_ms").read(m) == pytest.approx(1.0)
    rec = _record({"pairs.gg_photons": 1, "pairs.fit_zones": 1})
    del rec["snapshot"]["spans"]["step.pairs"]
    m = _m(program_trace=rec)
    assert specs.load_metric("pairs_roofline_pct").read(m) is None
    assert specs.load_metric("pairs_ms").read(m) is None
    assert specs.load_metric("pairs_ms").read(_m(program_trace=None)) \
        is None


# The replayed step on the card. k_gg, dn_pp, dne_pa and dnp_pa come from
# the pre-step census and zones alone, by the same float32 operations on
# both sides (TF32 off): equal but for a contraction's order, 1e-6. n_pos
# and f_pair come out of the FP solve, the program's kernel against the
# reference's plain loop (read 1.1e-7 and 9.7e-8 on the card), 2e-6.
# TF32 moves every one of them by 4e-5 to 1.2e-4 (NVIDIA H100).
CARD_TOL = {"k_gg": 1e-6, "dn_pp": 1e-6, "dne_pa": 1e-6, "dnp_pa": 1e-6,
            "n_pos": 2e-6, "f_pair": 2e-6}


@pytest.mark.cuda
def test_pair_fields_on_the_card_and_the_control_breaks_them():
    """The cell at its own size from its set-up state: the last step of a
    segment of each of two streams, replayed by the reference, within
    ``CARD_TOL``; the reference under TF32 in the program's place
    exceeds it in at least one field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness.cell import Capture, CellRun

    cell = CellRun("pair_corona.evolve", 2 ** 31 + 11, 0.0,
                   torch.device("cuda", 0), root=BENCH)
    try:
        cell.setup()
        for stream in (0, 1):
            cap = Capture()
            cell.unit(stream, capture=cap)
            i = len(cap.steps) - 1
            sound = pair_gaps(cell, cap, i, False)
            control = pair_gaps(cell, cap, i, True)
            print("sound", stream, sound, "control", control)
            assert all(sound[f][0] <= t for f, t in CARD_TOL.items()), sound
            assert all(sound[f][1] > 0 for f in CARD_TOL), sound
            assert any(control[f][0] > t for f, t in CARD_TOL.items()), \
                control
    finally:
        cell.close()
