"""The port's bench-size gate (``compton2d_tpu_torch.e2e_gate``) against
``tools/pallas_e2e.py``: the same verdict dict on the same replicates,
the cells' configurations equal to the JAX package's and to the committed
reference JSON's, the JSON's floors recomputed from its replicates, and
the replicate channels extracted alike from the same tallies."""
import dataclasses
import importlib.util
import math
import os

import jax
import numpy as np
import pytest
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu_torch import convert, e2e_gate
from compton2d_tpu_torch import examples as pex

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = e2e_gate.K_SEEDS
NZ, NR, NMU, NE = 3, 2, 4, 30


def _pallas_e2e():
    spec = importlib.util.spec_from_file_location(
        "pallas_e2e", os.path.join(REPO, "tools", "pallas_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic(rng, k, scale=1.0, te_shift=0.0, stiff=()):
    """k replicates with run_gate's keys: noisy scalars, a noisy spectrum
    of float32 (as a tally), per-zone Te with some stiff zones."""
    shape = np.exp(-np.linspace(0.0, 4.0, NE))[None, :] * np.ones((NMU, 1))
    reps = []
    for _ in range(k):
        te = 100.0 + te_shift + rng.normal(0.0, 0.5, (NZ, NR))
        for z in stiff:
            te[z] += rng.normal(0.0, 20.0)
        reps.append({
            "finite": True,
            "escaped": scale * 4.6e55 * (1 + 0.02 * rng.normal()),
            "census": 4.3e56 * (1 + 0.01 * rng.normal()),
            "edep_total": 2.0e3 * (1 + 0.02 * rng.normal()),
            "scatter_gain": 1.0e55 * (1 + 0.02 * rng.normal()),
            "pair_abs": 1.0e52 * (1 + 0.05 * rng.normal()),
            "te_mean": float(te.mean()),
            "balance_worst": abs(1e-4 * rng.normal()),
            "fout": (scale * shape * (1 + 0.02 * rng.normal(size=shape.shape))
                     ).astype(np.float32),
            "te": te,
        })
    return reps


def _reference_cell(reps_x, steps, nst, pairs):
    """The reference JSON's layout of a cell, from replicates."""
    spec = e2e_gate.pooled_spectra(reps_x)
    return {
        "steps": steps,
        "config": {"source": {"nst": nst, "strat_split": False},
                   "physics": {"pair_switch": pairs}},
        "replicates": [{k: (v.tolist() if k == "te" else v)
                        for k, v in r.items() if k != "fout"}
                       for r in reps_x],
        "spectrum": {"dtype": str(spec["pooled"].dtype),
                     **{k: a.tolist() for k, a in spec.items()}},
    }


@pytest.mark.parametrize("case", ["passing", "failing"])
def test_gate_returns_run_gates_dict(case, monkeypatch):
    """run_gate (its _build and _run_seed replaced by synthetic
    replicates, its backend check by "tpu") and e2e_gate.gate on the same
    replicates give the same dict, key for key: a passing case, and one
    whose port side is biased on escaped energy, the spectrum and Te."""
    pe = _pallas_e2e()
    rng = np.random.default_rng(11)
    if case == "passing":
        reps_p = _synthetic(rng, K, stiff=((0, 0),))
    else:
        reps_p = _synthetic(rng, K, scale=1.3, te_shift=8.0, stiff=((0, 0),))
    reps_x = _synthetic(rng, K, stiff=((0, 0),))
    sims = {"on": type("Sim", (), {"state": None})(),
            "off": type("Sim", (), {"state": None})()}
    queues = {id(sims["on"]): list(reps_p), id(sims["off"]): list(reps_x)}
    monkeypatch.setattr(pe, "_build", lambda pallas, *a: sims[pallas])
    monkeypatch.setattr(pe, "_run_seed",
                        lambda sim, st0, seed, steps: queues[id(sim)].pop(0))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = pe.run_gate(steps=3, nst=200000, pairs=True, n_seeds=K)
    got = e2e_gate.gate(reps_p, _reference_cell(reps_x, 3, 200000, True))
    assert set(got) == set(want)
    for key in want:
        if key in ("rel_dev", "noise_floor"):
            assert set(got[key]) == set(want[key])
            for q in want[key]:
                assert got[key][q] == pytest.approx(want[key][q], abs=2e-5), q
        elif key in ("balance_pallas_worst", "balance_xla_worst"):
            assert got[key] == pytest.approx(want[key], rel=1e-12)
        else:
            assert got[key] == want[key], key
    assert want["passed"] is (case == "passing")
    if case == "failing":
        assert not want["checks"]["rel_escaped"]
        assert not want["checks"]["spectrum"]
        assert not want["checks"]["te_zones"]


@pytest.mark.parametrize("cell", sorted(e2e_gate.CELLS))
def test_cell_config_matches_jax_config_and_json(cell):
    """Each cell's port Simulation has the JAX package's configuration and
    zone initialisation under the JSON's statistic, field for field, and
    the JSON recorded exactly that; the pair corona is
    tools/pallas_e2e._build's configuration."""
    ref = e2e_gate.load_reference()[cell]
    stat = ref["statistic"]
    psim = e2e_gate.build_cell(cell, stat, "cpu")
    jsim = jex.small_corona(**e2e_gate.CELLS[cell])
    jsim = jsim.with_config(e2e_gate.cell_config(jsim.cfg, stat, cell))
    assert e2e_gate.config_record(psim) == e2e_gate.config_record(jsim)
    assert e2e_gate.check_config(psim, ref) == []
    if cell in ("pair_corona", "pair_corona_strat"):
        strat = cell == "pair_corona_strat"
        built = _pallas_e2e()._build("on", 200000, True, strat)
        assert (dataclasses.asdict(e2e_gate.cell_config(built.cfg, stat))
                == dataclasses.asdict(jsim.cfg))
        for sim in (psim, jsim, built):
            assert sim.cfg.source.strat_split is strat
        if strat:
            src = ref["config"]["source"]
            assert (src["strat_split"], src["strat_gamma_c"],
                    src["strat_p_max"]) == (True, 10.0, 0.5)
    # the check sees a changed field
    other = psim.with_config(dataclasses.replace(
        psim.cfg, source=dataclasses.replace(psim.cfg.source, nst=1)))
    assert e2e_gate.check_config(other, ref) == ["config.source.nst"]


def _check_recorded_cell(ref: dict, cell: str):
    assert len(ref["replicates"]) == len(ref["seeds"]) == K
    assert ref["statistic"] in e2e_gate.STATISTICS
    assert ref["mode"] == e2e_gate.CELL_MODE[cell]
    for key in ("jax_version", "commit", "cpu_seconds", "steps",
                "tally_from"):
        assert key in ref, key
    floors = e2e_gate.ref_floors(ref)
    assert set(floors) == set(ref["floors"])
    for q, v in floors.items():
        assert v == pytest.approx(ref["floors"][q], rel=1e-12, abs=1e-300), q
    assert all(r["finite"] for r in ref["replicates"])
    assert max(r["balance_worst"] for r in ref["replicates"]) < 5e-3


@pytest.mark.parametrize("cell", sorted(e2e_gate.CELLS))
def test_json_floors_recomputed_from_its_replicates(cell):
    """The committed JSON's floors are e2e_gate.ref_floors of its own
    replicates; it holds K seeds, the statistic and its provenance, and
    the statistic and steps are choose_statistic's pick of the runs whose
    floors it records."""
    ref = e2e_gate.load_reference()[cell]
    _check_recorded_cell(ref, cell)
    assert ref["gated"] is True
    assert ref["reference_repairs"] == [
        "chang_cooper_limit_below_w_-500", "no_pair_terms_in_end_bins"]
    runs = ref["floors_by_statistic"]
    assert {k: ref[k] for k in ("statistic", "steps", "floors")} in runs
    assert e2e_gate.choose_statistic(runs) == (ref["statistic"],
                                               ref["steps"])
    assert ref["tally_from"] == (0 if ref["statistic"] == "census_rr_off"
                                 else ref["steps"] - 1)


def test_unrepaired_witness_recorded():
    """The pair corona's reference without the two FP repairs stays in
    the JSON, not gated: the port's pair corona under the witness's
    statistic has its recorded configuration, and its seeds are the
    gated cell's."""
    data = e2e_gate.load_reference()
    wit, ref = data["pair_corona_unrepaired"], data["pair_corona"]
    _check_recorded_cell(wit, "pair_corona")
    assert wit["gated"] is False and wit["reference_repairs"] == []
    assert set(data) == set(e2e_gate.CELLS) | {"pair_corona_unrepaired"}
    assert wit["seeds"] == ref["seeds"]
    psim = e2e_gate.build_cell("pair_corona", wit["statistic"], "cpu")
    assert e2e_gate.check_config(psim, wit) == []


@pytest.mark.parametrize("case", ["rule", "one_step"])
def test_choose_statistic(case):
    """The roulette kept wins when all its scalar floors reach the target;
    else the most floors at or below it; one-step runs never count."""
    def run(stat, steps, worst, n_big=0):
        fl = {q: 1e-3 for q in e2e_gate.SCALARS}
        fl[e2e_gate.SCALARS[0]] = worst
        for q in e2e_gate.SCALARS[1:1 + n_big]:
            fl[q] = 0.5
        return {"statistic": stat, "steps": steps, "floors": fl}

    if case == "rule":
        runs = [run("census_rr_off", 4, 0.01), run("post_transient", 4, 0.04)]
        assert e2e_gate.choose_statistic(runs) == ("post_transient", 4)
        runs[1] = run("post_transient", 4, 0.06)
        assert e2e_gate.choose_statistic(runs) == ("census_rr_off", 4)
        runs = [run("census_rr_off", 3, 0.2, 2), run("census_rr_off", 2, 0.3, 1),
                run("post_transient", 4, 0.1, 2)]
        assert e2e_gate.choose_statistic(runs) == ("census_rr_off", 2)
    else:
        runs = [run("census_rr_off", 1, 0.001), run("census_rr_off", 2, 0.3)]
        assert e2e_gate.choose_statistic(runs) == ("census_rr_off", 2)
        with pytest.raises(ValueError):
            e2e_gate.choose_statistic(runs[:1])


def test_reference_json_is_small():
    assert os.path.getsize(e2e_gate.REFERENCE_JSON) < 1.2e6


def test_channels_match_run_seed_extraction():
    """At a tiny size: the reference's _run_seed on its Pallas path
    (interpret mode), then e2e_gate.channels on the same last step's
    tallies and zone state carried across by convert.py: every channel
    equal."""
    pe = _pallas_e2e()
    kw = dict(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40, n_vol=32,
              nphfield=32, t_const=False)
    jsim = jex.small_corona(**kw)
    jsim = jsim.with_config(e2e_gate.cell_config(jsim.cfg, "census_rr_off"))
    want = pe._run_seed(jsim, jsim.state, 5, 2)
    jout = jsim.last_outputs

    psim = pex.small_corona(**kw, device="cpu")
    psim = psim.with_config(e2e_gate.cell_config(psim.cfg, "census_rr_off"))
    st = convert.from_reference(
        convert.flatten(jsim.state), convert.flatten(jsim.tables),
        convert.flatten(jsim.grid), convert.flatten(jsim.src_static),
        device="cpu")[0]
    psim.state = st
    out = psim.step()
    # the reference's tallies; the port's own counters (n_window, ...) stay
    tallies = out.tallies._replace(**{
        f: torch.as_tensor(np.array(getattr(jout.tallies, f)))
        for f in out.tallies._fields if hasattr(jout.tallies, f)})
    psim.last_outputs = out._replace(
        tallies=tallies, bingo=torch.as_tensor(np.array(jout.bingo)))
    psim.state = st
    got = e2e_gate.channels(psim, want["fout"],
                            [1.0 + want["balance_worst"], 1.0])
    assert psim.scales.E == jsim.scales.E
    for q in ("finite", "escaped", "census", "edep_total", "scatter_gain",
              "pair_abs", "te_mean", "balance_worst"):
        assert got[q] == pytest.approx(want[q], rel=1e-6, abs=1e-300), q
    np.testing.assert_array_equal(got["te"], want["te"])
    np.testing.assert_array_equal(got["fout"], want["fout"])
    assert math.isfinite(got["escaped"]) and got["escaped"] > 0.0


def test_gate_zones_compare():
    """tests/gate_zones.py's side-by-side: the Fisher exact test's known
    values, and per-zone z-tests and two-mode counts on synthetic seeds."""
    spec = importlib.util.spec_from_file_location(
        "gate_zones", os.path.join(REPO, "tests", "gate_zones.py"))
    gz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gz)
    assert gz.fisher_two_sided(3, 10, 1, 10) == pytest.approx(0.5820433, 1e-6)
    assert gz.fisher_two_sided(5, 10, 5, 10) == pytest.approx(1.0)
    assert gz.fisher_two_sided(0, 12, 10, 12) < 1e-3
    rng = np.random.default_rng(0)

    def side(hot):
        te = 67.5 + 0.01 * rng.standard_normal((12, 2, 3))
        te[:hot, 1, 0] = 130.6
        npcen = rng.poisson(50.0, (12, 2, 3)).astype(float)
        npcen[:hot, 1, 0] = 0.0
        edep = 1e3 + rng.standard_normal((12, 2, 3))
        return {"replicates": [
            {"te": te[k].tolist(), "edep": edep[k].tolist(),
             "npcen": npcen[k].tolist()} for k in range(12)]}

    rows = {tuple(r["zone"]): r for r in gz.compare(side(2), side(11), 2)}
    assert set(rows) == {(j, i) for j in range(2) for i in range(3)}
    assert rows[(1, 0)]["no_census"]["port"] == [11, 12]
    assert rows[(1, 0)]["upper_te"]["ref"] == [2, 12]
    assert rows[(1, 0)]["upper_te"]["fisher_p"] < 1e-3
    assert not rows[(1, 0)]["te"]["pass"]
    assert rows[(0, 1)]["edep"]["pass"] and rows[(0, 1)]["te"]["pass"]


def _strat_replicate(seed: int, calls: list) -> dict:
    """A replicate of the strat pair cell's configuration at a small size
    on the CPU: 2 steps, the spectrum of the last."""
    sim = pex.small_corona(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40,
                           n_vol=32, nphfield=32, t_const=False, seed=0,
                           pair_switch=True, amxwl=0.5, gmin=3.0, gmax=20.0,
                           p_nth=2.5, device="cpu")
    sim = sim.with_config(e2e_gate.cell_config(
        sim.cfg, "post_transient", "pair_corona_strat"))
    assert sim.cfg.source.strat_split
    n0 = len(calls)
    rep = e2e_gate.replicate_channels(sim, sim.state, seed, 2, 1)
    assert len(calls) > n0   # the strat path's scatter pass ran
    return rep


def test_strat_replicates_reseed_their_streams(monkeypatch):
    """The strat copies draw from per-round generators seeded from the
    step's generator: a replicate of the strat pair cell repeats bitwise
    under one seed and differs under another."""
    from compton2d_tpu_torch.transport import tracking

    calls, apply_scatter = [], tracking.apply_scatter

    def counted(*a, **k):
        calls.append(1)
        return apply_scatter(*a, **k)

    monkeypatch.setattr(tracking, "apply_scatter", counted)
    a, b, c = (_strat_replicate(s, calls) for s in (5, 5, 6))
    keys = ("escaped", "census", "edep_total", "scatter_gain", "pair_abs",
            "te_mean", "balance_worst")
    assert all(a[q] == b[q] for q in keys)
    np.testing.assert_array_equal(a["te"], b["te"])
    np.testing.assert_array_equal(a["fout"], b["fout"])
    assert a["finite"] and c["finite"]
    assert [a[q] for q in keys[:4]] != [c[q] for q in keys[:4]]
    assert not np.array_equal(a["fout"], c["fout"])
