"""The slice as a whole: the two reference-format decks (the port's
``decks``: an accreting corona above a reflecting disk with a flare and
adaptive dt, and an external-Compton blazar blob lit by a diskgen file),
written once, loaded by each package's legacy importer and run on the
CPU, the port against the JAX package's Pallas path (interpret mode).

Step-level z-tests over K = 3 seeds a side after 2 steps: the leak
tallies, ed_ref, the escaped energy and the mean Te, with a noise floor
of 1e-3 of the reference's mean on every channel's standard error (float32
rounding; it matters only for Te, whose seed spread is tiny). The
reflection-corrected audit of every step, and bitwise repeatability."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from compton2d_tpu.driver import Simulation as JSim
from compton2d_tpu.io import legacy as jleg
from compton2d_tpu_torch import decks
from compton2d_tpu_torch.driver import Simulation as PSim

torch.set_num_threads(2)

SEEDS, STEPS = (0, 1, 2), 2
SHAPE = dict(nz=3, nr=2, nst=3000)
RUN = dict(n_slots=4096, event_capacity=4096)
# the disk deck at narrow widths; the blazar blob at small_corona's
# default widths: at 50 gamma and 64 energy bins its thin zones' total
# synchrotron emission is a float32 subnormal, which XLA flushes (the
# reference then emits every volume photon in the first energy bin)
WIDTHS = {
    "disk_deck": dict(num_nt=50, n_vol=64, nphfield=64, n_gg=32, n_ref=100),
    "ec_deck": dict(num_nt=100, n_vol=128, nphfield=128, n_gg=32,
                    n_ref=100),
}
CHANNELS = ("erlk_lower", "erlk_upper", "erlk_outer", "ed_ref", "escaped",
            "mean Te")


def _avail(a):
    return a["input"] - a["src_lost"] + a["scatter_gain"] - a["rr"]


def _observe(sim, tea):
    t, scale = sim.last_outputs.tallies, sim.scales.E

    def tot(x):
        return float(np.sum(np.asarray(x))) * scale

    return np.array([tot(t.erlk_lower), tot(t.erlk_upper),
                     tot(t.erlk_outer), tot(t.ed_ref),
                     sim.energy_audit()["escaped"], float(np.mean(tea))])


def _check_audit(sim, tol):
    """|balance - (1 + sum(ed_ref) E / avail)| < tol: a reflected photon's
    pre-reflection weight is in erlk_lower and its reflected weight flies
    on, so the audit counts ed_ref twice (the reference's own audit)."""
    a = sim.energy_audit()
    ed_ref = float(np.sum(np.asarray(sim.last_outputs.tallies.ed_ref)))
    extra = ed_ref * sim.scales.E / _avail(a)
    assert abs(a["balance"] - (1.0 + extra)) < tol, (a, extra)
    return extra


@pytest.fixture(scope="module", params=["disk_deck", "ec_deck"])
def runs(request, tmp_path_factory):
    """(name, reference observables, port observables) over SEEDS."""
    name = request.param
    d = str(tmp_path_factory.mktemp(name))
    lc = decks.load_deck(name, d, grid=WIDTHS[name], **SHAPE, **RUN)
    port = []
    for s in SEEDS:
        cfg = lc.cfg.replace(run=dataclasses.replace(lc.cfg.run, seed=s))
        sim = PSim(cfg, lc.zones, device="cpu")
        for _ in range(STEPS):
            sim.step()
            extra = _check_audit(sim, 2e-3)
            if name == "disk_deck":
                assert extra > 0.0
            else:
                assert extra == 0.0
        port.append(_observe(sim, sim.state.zones.tea.numpy()))
    # the reference at the port's energy unit: its own estimate takes the
    # ec deck's file sentinel (tbb = -1) as a 1 keV blackbody, and its
    # census roulette underflows at the weights that unit gives
    jlc = jleg.load_legacy_config(
        d, pallas_tracking="on", energy_scale=sim.scales.E,
        adaptive_dt=(name == "disk_deck"), **RUN)
    jcfg = jlc.cfg.replace(grid=dataclasses.replace(jlc.cfg.grid,
                                                    **WIDTHS[name]))
    jsim = JSim(jcfg, jlc.zones)
    init = jsim.state
    ref = []
    for s in SEEDS:
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        for _ in range(STEPS):
            jsim.step()
            _check_audit(jsim, 2e-3)
        ref.append(_observe(jsim, np.asarray(jsim.state.zones.tea)))
    return name, np.array(ref), np.array(port)


def test_deck_matches_reference_statistically(runs):
    """z < 4 on every channel; a channel zero in every run of both codes
    (ed_ref of the blazar blob, which has no reflection) must be zero in
    both."""
    name, ref, port = runs
    k = len(SEEDS)
    se = np.sqrt(ref.var(0, ddof=1) / k + port.var(0, ddof=1) / k)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    both_zero = (np.abs(ref).max(0) == 0.0) & (np.abs(port).max(0) == 0.0)
    z = np.abs(port.mean(0) - ref.mean(0)) / np.where(both_zero, 1.0, se)
    print(name, dict(zip(CHANNELS, np.round(z, 3))))
    assert np.all(z < 4.0), (dict(zip(CHANNELS, z)), port.mean(0),
                             ref.mean(0))
    live = ~both_zero
    if name == "disk_deck":
        assert live.all()
    else:
        assert list(np.array(CHANNELS)[~live]) == ["ed_ref"]


def test_disk_deck_repeatable_with_reflection_and_flare(tmp_path):
    """Two runs of the disk deck from one seed give bitwise-equal tallies
    over 2 steps, with lower and outer-disk reflections counted, and dt
    moved by the FP ladder after the first step."""
    lc = decks.load_deck("disk_deck", str(tmp_path),
                         grid=WIDTHS["disk_deck"], **SHAPE, **RUN)
    sims = [PSim(lc.cfg, lc.zones, device="cpu") for _ in range(2)]
    dt0 = float(sims[0].state.dt)
    for _ in range(2):
        o1, o2 = sims[0].step(), sims[1].step()
        for f in o1.tallies._fields:
            assert torch.equal(getattr(o1.tallies, f),
                               getattr(o2.tallies, f)), f
    assert int(o1.tallies.n_reflect_lower) > 0
    assert int(o1.tallies.n_reflect_disk) > 0
    assert float(sims[0].state.dt) != dt0
