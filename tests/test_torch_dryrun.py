"""The port's dry run (``compton2d_tpu_torch.dryrun``) against the
repository's ``__graft_entry__.py``: the same configurations, the step
function of ``entry()``, and ``dryrun_multichip`` on 2 gloo ranks on the
CPU at the tiny shapes with every check live."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from compton2d_tpu_torch import dryrun, e2e_gate
from compton2d_tpu_torch.driver import Simulation

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(cfg, zi) -> dict:
    return e2e_gate._plain({"config": dataclasses.asdict(cfg),
                            "zone_init": dataclasses.asdict(zi)})


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "bench"])
def test_configs_match_graft_entry(tiny):
    """dryrun_multichip's configuration on 2 ranks (global slots, pairs,
    Coulomb, the event capacity and roulette thresholds, the zones) and
    the z-test's and entry()'s tiny corona are __graft_entry__'s, field
    for field (the JAX side built without its Coulomb tables)."""
    ge = _graft_entry()
    from compton2d_tpu.config import ZoneInit as JZoneInit

    jsim = ge._make_sim(n_devices=2, tiny=tiny, pair_switch=1)
    jcfg = dataclasses.replace(
        jsim.cfg,
        physics=dataclasses.replace(jsim.cfg.physics, fp_include_coulomb=True),
        run=dataclasses.replace(jsim.cfg.run, event_capacity=64,
                                census_rr_hi=0.05, census_rr_lo=0.03))
    jzi = JZoneInit.uniform(jcfg.grid, tea=100.0, tna=100.0, n_e=1e10,
                            B_field=10.0)
    assert _record(*dryrun.dryrun_config(2, tiny)) == _record(jcfg, jzi)
    if tiny:
        # the z-test's replicates and entry()
        assert (_record(*dryrun._config(2, True, pair_switch=1))
                == _record(jsim.cfg, jsim.zone_init))
        one = ge._make_sim()
        assert (_record(*dryrun._config(1, True))
                == _record(one.cfg, one.zone_init))
    assert dryrun.z_seeds("n") == [7 + 31 * i for i in range(5)]
    assert dryrun.z_seeds("1") == [1000 + 31 * i for i in range(5)]


def test_entry_step_is_simulation_step():
    """entry()'s function runs one step on the CPU, the same step as
    Simulation.step from the same seed, tally for tally."""
    fn, args = dryrun.entry("cpu")
    state, out = fn(*args)
    assert int(state.ncycle) == 1
    assert torch.all(torch.isfinite(state.zones.tea))
    sim = Simulation(*dryrun._config(1, tiny=True), device="cpu")
    want = sim.step()
    for f in out.tallies._fields:
        assert torch.equal(getattr(out.tallies, f),
                           getattr(want.tallies, f)), f
    assert torch.equal(out.bingo, want.bingo)
    assert float(out.bingo) > 0


def test_dryrun_multichip_two_gloo_ranks(tmp_path):
    """dryrun_multichip(2) on 2 gloo ranks on the CPU at the tiny shapes:
    every check passes (the first-step budget to rtol 1e-6, the roulette
    fired on both sides, the audits, the census ratio, one event count a
    rank with its dropped records counted, the z-test), and the readings
    are those of the run: the one-rank run overflows its 64-record
    buffer, and its dropped records are the counts past it."""
    dr = dryrun.dryrun_multichip(2, device="cpu", tiny=True, threads=1,
                                 rendezvous_dir=str(tmp_path))
    assert dr["world"] == 2 and dr["shapes"]["slots_per_rank"] == 1024
    assert dr["trackers"] == ["kernel"] * 3   # both ranks and the one rank
    assert dr["bingo"] == pytest.approx(dr["bingo_one_rank"], rel=1e-6)
    assert dr["n_rr"] > 0 and dr["n_rr_one_rank"] > 0
    assert all(abs(b - 1.0) < 5e-3
               for b in dr["balances"] + dr["balances_one_rank"])
    assert len(dr["event_counts"]) == 2
    for counts, dropped in zip(dr["event_counts"], dr["events_dropped"]):
        assert dropped == sum(max(c - 64, 0) for c in counts)
    assert dr["events_dropped_one_rank"] == sum(
        max(c - 64, 0) for c in dr["event_counts_one_rank"]) > 0
    assert set(dr["z"]) == {"census", "escaped", "edep"}
    assert all(np.isfinite(z) and z < 4.0 for z in dr["z"].values())
