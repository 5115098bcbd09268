"""The port's main path as a whole: the energy audit per step, statistical
agreement with the JAX reference running its Pallas kernel in interpret
mode, repeatability, the options outside the slice, and that the port
loads neither jax nor the JAX package."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.driver import Simulation

torch.set_num_threads(2)

CFG = dict(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50, n_vol=64,
           nphfield=64, t_const=False)
SEEDS = (0, 1, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_audit_balances_every_step():
    """Three steps with the FP solve on: |balance - 1| < 2e-3 (the JAX
    tests' bound) at every step."""
    sim = pex.small_corona(**CFG, seed=4, device="cpu")
    for _ in range(3):
        sim.step()
        a = sim.energy_audit()
        assert abs(a["balance"] - 1.0) < 2e-3, a
        assert a["escaped"] > 0.0
    assert np.all(np.isfinite(sim.state.zones.tea.numpy()))


def _observables(audit, tea):
    return np.array([audit["escaped"], audit["census"], float(np.mean(tea))])


def test_matches_reference_statistically():
    """After 2 steps, escaped and census energy and mean Te agree with the
    reference's Pallas path (interpret mode) within z < 4, over 3 seeds a
    side. The standard error has a 0.1% floor for float32 rounding, which
    matters only for Te where the seed spread is tiny."""
    jsim = jex.small_corona(**CFG, seed=0)
    jsim = jsim.with_config(dataclasses.replace(
        jsim.cfg, run=dataclasses.replace(jsim.cfg.run,
                                          pallas_tracking="on")))
    init = jsim.state
    ref, port = [], []
    for s in SEEDS:
        # one compiled step serves every seed: only the key differs
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        jsim.run(2)
        ref.append(_observables(jsim.energy_audit(),
                                np.asarray(jsim.state.zones.tea)))
        psim = pex.small_corona(**CFG, seed=s, device="cpu")
        psim.run(2)
        port.append(_observables(psim.energy_audit(),
                                 psim.state.zones.tea.numpy()))
    ref, port = np.array(ref), np.array(port)
    k = len(SEEDS)
    se = np.sqrt(ref.var(0, ddof=1) / k + port.var(0, ddof=1) / k)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    z = np.abs(port.mean(0) - ref.mean(0)) / se
    assert np.all(z < 4.0), (z, port.mean(0), ref.mean(0))


def test_same_seed_bitwise_repeatable():
    s1 = pex.small_corona(**CFG, seed=7, device="cpu")
    s2 = pex.small_corona(**CFG, seed=7, device="cpu")
    for _ in range(2):
        o1, o2 = s1.step(), s2.step()
    for name in o1.tallies._fields:
        assert torch.equal(getattr(o1.tallies, name),
                           getattr(o2.tallies, name)), name
    assert torch.equal(s1.state.photons.w, s2.state.photons.w)


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter runs one step of the port, and one with pair
    physics on (which loads physics/pairs.py), then imports every module
    of the port (the gate, the observation check, the native library and
    the measurement tools among them) and chip_smoke.py; neither jax nor
    any compton2d_tpu module is loaded. The reference's config / constants /
    units modules stay jax-free as well."""
    code = (
        "import sys\n"
        "from compton2d_tpu_torch.examples import small_corona\n"
        "small_corona(nz=2, nr=2, nst=300, n_slots=1024, num_nt=30, "
        "n_vol=32, nphfield=32, device='cpu').step()\n"
        "small_corona(nz=2, nr=2, nst=300, n_slots=1024, num_nt=30, "
        "n_vol=32, nphfield=32, pair_switch=1, device='cpu').step()\n"
        "assert 'compton2d_tpu_torch.physics.pairs' in sys.modules\n"
        "import importlib, pkgutil, compton2d_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('e2e_gate', 'obs_compare', 'roofline', 'collectives',\n"
        "          'weak_scaling', 'strat_fom', 'profile_sourcing',\n"
        "          'io.native'):\n"
        "    assert 'compton2d_tpu_torch.' + m in sys.modules, m\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'compton2d_tpu']\n"
        "import compton2d_tpu.config, compton2d_tpu.constants\n"
        "import compton2d_tpu.units\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _window(nz, nr, tbb=0.5, lower_spectra=()):
    return pcfg.TimeWindow(t0=0.0, t1=1e30, tbb_lower=(tbb,) * nr,
                           tbb_upper=(0.0,) * nr, tbb_inner=(0.0,) * nz,
                           tbb_outer=(0.0,) * nz,
                           lower_spectra=lower_spectra)


def _config(change, lower_spectra=()):
    grid = pcfg.GridConfig(**{"nz": 3, "nr": 2, "num_nt": 40, "n_vol": 32,
                              "nphfield": 32, "n_gg": 16, "n_ref": 50,
                              **change.get("grid", {})})
    return pcfg.SimConfig(
        grid=grid,
        physics=pcfg.PhysicsConfig(**change.get("physics", {})),
        source=pcfg.SourceConfig(nst=300, **change.get("source", {})),
        run=pcfg.RunConfig(n_slots=1024, event_capacity=1024,
                           **change.get("run", {})),
        windows=(_window(grid.nz, grid.nr, change.get("tbb", 0.5),
                         lower_spectra),),
    )


@pytest.mark.parametrize("change", [
    dict(grid=dict(nz=2, nr=128), run=dict(pallas_tracking="on")),
    dict(grid=dict(nz=128, nr=2), run=dict(pallas_tracking="on")),
])
def test_options_outside_the_slice_raise(change):
    """Grid edges above 127 zones on the flight kernel (meshes run since
    the multi-process slice: tests/test_torch_parallel.py; such grids run
    on the lock-step loop under "auto" or "off" since the loop's slice:
    tests/test_torch_loop.py)."""
    with pytest.raises(NotImplementedError):
        Simulation(_config(change), device="cpu")


@pytest.mark.parametrize("change", [
    dict(physics=dict(cr_sent=1)),
    dict(physics=dict(cr_sent=2)),
    dict(tbb=-1.0),
    dict(run=dict(adaptive_dt=True)),
    dict(physics=dict(flare=pcfg.FlareConfig(
        enabled=True, r_flare=5e14, z_flare=5e14, sigma_r=5e14,
        sigma_z=5e14, sigma_t=1e4, amplitude=1.0))),
    dict(physics=dict(fp_include_coulomb=True)),
])
def test_options_of_the_slice_run(change, tmp_path):
    """The options the port ran outside its slice before boundary
    reflection, file-spectrum boundaries (here a diskgen file on every
    lower ring), adaptive dt, flares and the Coulomb FP drift were ported:
    each builds a CPU Simulation that takes a step with finite results."""
    from compton2d_tpu_torch.io import diskgen

    files = ()
    if change.get("tbb", 0.5) < 0.0:
        path = str(tmp_path / "bb.in")
        diskgen.write_spectrum_file(path, gamma_bulk=10.0)
        files = (path, path)
        # tests/test_external_source.py's external radiation fields
        change = dict(change, source=dict(
            external=pcfg.ExternalRadiationConfig(
                R_blr=1e17, fr_blr=0.1, R_ir=1e18, fr_ir=0.3, R_disk=1e15,
                d_jet=1e17, g_bulk=10.0)))
    sim = Simulation(_config(change, files), device="cpu")
    out = sim.step()
    a = sim.energy_audit()
    assert np.isfinite(a["balance"]) and float(out.bingo) > 0.0
    assert bool(torch.all(torch.isfinite(sim.state.zones.tea)))
    if files:
        assert float(torch.sum(sim.src_static.flux_lower)) > 0.0
