"""The port's diagnostics against the JAX reference: each dump writer's
text byte for byte on the same arrays, ``write_diagnostics`` on a step's
state carried over from a reference Simulation (every file byte-equal,
the extras and the pair dumps included), the copy of
``emissivity_extras``, and ``photon_fill`` on the same inputs (rtol 1e-5)
with the checks of the JAX package's own test."""
import filecmp
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import driver as jdrv
from compton2d_tpu import examples as jex
from compton2d_tpu.fp import update as jupd
from compton2d_tpu.io import outputs as jout
from compton2d_tpu.physics import emissivity_extras as jextra
from compton2d_tpu.physics.emissivity import volume_em as j_volume_em
from compton2d_tpu_torch import convert
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.driver import write_diagnostics
from compton2d_tpu_torch.fp import update as pupd
from compton2d_tpu_torch.io import outputs as pout
from compton2d_tpu_torch.physics import emissivity_extras as pextra

torch.set_num_threads(2)


def test_emissivity_extras_copy_is_the_reference_source():
    """Every function of the copy is the reference's source text (only
    the module docstring differs)."""
    names = [n for n, v in vars(jextra).items()
             if inspect.isfunction(v) and v.__module__ == jextra.__name__]
    assert len(names) >= 8
    for name in names:
        assert inspect.getsource(getattr(pextra, name)) == \
            inspect.getsource(getattr(jextra, name)), name
    assert pextra.N_HARMONICS == jextra.N_HARMONICS


def _arrays(seed=0, nz=16, nr=6, num_nt=40, nph=24, ngg=12):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        gnt=(0.2 * 1.1 ** (np.arange(num_nt) - 1.0)).astype(f32),
        e_field=np.geomspace(1e-5, 1e4, nph).astype(f32),
        f_ic=rng.uniform(0.0, 1e-3, (num_nt, nph)).astype(f32),
        f_nt=(rng.uniform(0.0, 1.0, (nz, nr, num_nt))
              * (rng.uniform(size=(nz, nr, num_nt)) > 0.3)).astype(f32),
        n_pos=rng.uniform(0.0, 1e6, (nz, nr, num_nt)).astype(f32),
        n_field=rng.uniform(0.0, 1e3, (nz, nr, nph)).astype(f32),
        e_ic=rng.normal(0.0, 1e2, num_nt).astype(f32),
        n_esp=rng.uniform(0.0, 1e4, num_nt).astype(f32),
        e_gg=np.geomspace(1.0, 1e5, ngg).astype(f32),
        nph=rng.uniform(0.0, 1e-3, (nz, nr, ngg)).astype(f32),
    )


WRITES = {
    "icloss": lambda m, a, d: m.write_icloss(
        os.path.join(d, "icloss.dat"), a["gnt"], a["e_field"], a["f_ic"]),
    "seb": lambda m, a, d: m.write_seb(
        os.path.join(d, "seb.dat"), a["gnt"], a["f_nt"], a["n_pos"]),
    "seb_no_positrons": lambda m, a, d: m.write_seb(
        os.path.join(d, "seb.dat"), a["gnt"], a["f_nt"]),
    "snapshots": lambda m, a, d: m.write_electron_snapshots(
        d, a["gnt"], a["f_nt"], a["n_pos"], 7),
    "nfield": lambda m, a, d: m.write_nfield(
        os.path.join(d, "nfield.dat"), a["e_field"], a["n_field"], 3.7e44),
    "eic": lambda m, a, d: m.write_eic(
        os.path.join(d, "eic.dat"), a["gnt"], a["e_ic"], 3.7e44),
    "esp": lambda m, a, d: m.write_esp(
        os.path.join(d, "esp.dat"), a["gnt"], a["n_esp"]),
    "nph": lambda m, a, d: m.write_nph(
        os.path.join(d, "n_ph1.dat"), a["e_gg"], a["nph"]),
}


def _same_dirs(a, b):
    names = sorted(os.listdir(b))
    assert names and sorted(os.listdir(a)) == names
    for nm in names:
        assert filecmp.cmp(os.path.join(a, nm), os.path.join(b, nm),
                           shallow=False), nm
    return names


@pytest.mark.parametrize("writer", sorted(WRITES))
def test_writer_text_equals_reference(writer, tmp_path):
    """The port's writer on tensors, the reference's on jax arrays of the
    same values: the same files, byte for byte (16x6 zones, so the
    snapshots' zone striding writes several)."""
    arrays = _arrays()
    jd, pd = tmp_path / "j", tmp_path / "p"
    jd.mkdir()
    pd.mkdir()
    WRITES[writer](jout, {k: jnp.asarray(v) for k, v in arrays.items()},
                   str(jd))
    WRITES[writer](pout, {k: torch.as_tensor(v) for k, v in arrays.items()},
                   str(pd))
    names = _same_dirs(pd, jd)
    if writer == "snapshots":
        assert len(names) == 4


@pytest.fixture(scope="module")
def pair_step():
    """One step of the reference's pair corona on one zone (its
    write_diagnostics with extras runs on one zone only), and a port
    Simulation of the same config holding that step's state, tables and
    tallies."""
    kw = dict(nz=1, nr=1, nst=400, n_slots=2048, num_nt=40, n_vol=32,
              nphfield=32, pair_switch=1, amxwl=0.5, gmin=3.0, gmax=20.0,
              seed=1)
    jsim = jex.small_corona(**kw)
    jsim.step()
    jsim.step()
    psim = pex.small_corona(**kw, device="cpu")
    out = psim.step()
    state, tables, _, _, _ = convert.from_reference(
        convert.flatten(jsim.state), convert.flatten(jsim.tables),
        convert.flatten(jsim.grid), convert.flatten(jsim.src_static),
        device="cpu")
    jo = jsim.last_outputs
    psim.state, psim.tables = state, tables
    psim.last_outputs = out._replace(
        tallies=out.tallies._replace(**{
            f: torch.as_tensor(np.array(getattr(jo.tallies, f)))
            for f in ("n_field", "e_ic", "n_esp")}),
        nph_raw=torch.as_tensor(np.array(jo.nph_raw)),
        nph_fit=torch.as_tensor(np.array(jo.nph_fit)))
    return jsim, psim


@pytest.mark.parametrize("extras", [False, True])
def test_write_diagnostics_equals_reference(pair_step, tmp_path, extras):
    """Every file the reference's write_diagnostics writes, the pair
    dumps n_ph1/n_ph2 and (extras) eloss_cy, j_cy and j_pa included, byte
    for byte on the same state, tables and tallies."""
    jsim, psim = pair_step
    jdrv.write_diagnostics(jsim, str(tmp_path / "j"), extras=extras)
    write_diagnostics(psim, str(tmp_path / "p"), extras=extras)
    names = _same_dirs(tmp_path / "p", tmp_path / "j")
    want = {"icloss.dat", "seb.dat", "nfield.dat", "eic.dat", "esp.dat",
            "n_ph1.dat", "n_ph2.dat"}
    if extras:
        want |= {"eloss_cy.dat", "j_cy.dat", "j_pa.dat"}
    assert want <= set(names)
    assert float(np.abs(np.loadtxt(tmp_path / "p" / "n_ph1.dat")[:, 1]).max()
                 ) > 0.0


def test_write_diagnostics_extras_on_a_grid(tmp_path):
    """On 3x2 zones (where the reference's cyclotron raises: it
    accumulates every zone into one row) the port's j_cy.dat holds each
    zone's row of the reference's cyclotron, eloss_cy.dat its tally per
    zone, in the reference's format."""
    sim = pex.small_corona(nz=3, nr=2, nst=1500, n_slots=4096, num_nt=40,
                           n_vol=32, nphfield=32, device="cpu")
    sim.step()
    write_diagnostics(sim, str(tmp_path), extras=True)
    z = sim.state.zones
    e_ph = sim.tables.e_ph.numpy()
    args = [x.numpy() for x in (z.tea, z.n_e, z.B_field)]
    with pytest.raises(ValueError):
        jextra.cyclotron(e_ph, *args)
    rows = np.stack([jextra.cyclotron(e_ph, *(a.ravel()[i] for a in args))
                     [0][0] for i in range(6)])
    ref = tmp_path / "ref"
    ref.mkdir()
    np.savetxt(ref / "j_cy.dat", rows, fmt="%14.6e")
    np.savetxt(ref / "eloss_cy.dat",
               jextra.eloss_cy(e_ph, rows).reshape(3, 2), fmt="%14.6e")
    for nm in ("j_cy.dat", "eloss_cy.dat"):
        assert filecmp.cmp(tmp_path / nm, ref / nm, shallow=False), nm
    assert not os.path.exists(tmp_path / "j_pa.dat")


@pytest.fixture(scope="module")
def carried():
    """A reference Simulation after one step, its state carried over to
    the port, and the reference's emissivities over dt_prev."""
    jsim = jex.small_corona(nz=3, nr=2, nst=2000, n_slots=4096, seed=3)
    jsim.step()
    js, jt, jg = jsim.state, jsim.tables, jsim.grid
    state, tables, grid, _, _ = convert.from_reference(
        convert.flatten(js), convert.flatten(jt), convert.flatten(jg),
        convert.flatten(jsim.src_static), device="cpu")
    z = js.zones
    l_min = jnp.minimum(jg.dz, jg.dr) * jnp.ones_like(jg.vol)
    ve = j_volume_em(jt.e_ph, jt.gnt, z.f_nt, z.tea, z.n_e, z.B_field,
                     z.amxwl, jg.vol, jg.zone_surf, l_min, js.dt_prev,
                     jt.sync, jsim.scales, f_pair=z.f_pair)
    n_field = np.array(jsim.last_outputs.tallies.n_field)
    return jsim, state, tables, grid, n_field, ve


def test_photon_fill_matches_reference(carried):
    """photon_fill on the same zones, field and emissivities: every rate
    rtol 1e-5."""
    jsim, state, tables, grid, n_field, ve = carried
    js = jsim.state
    rj = jupd.photon_fill(js.zones, jnp.asarray(n_field), jsim.tables,
                          jsim.grid.vol, js.dt_prev, ve.eloss_sy,
                          ve.eloss_br, jsim.cfg.physics, jsim.scales)
    rp = pupd.photon_fill(state.zones, torch.as_tensor(n_field), tables,
                          grid.vol, state.dt_prev,
                          torch.as_tensor(np.array(ve.eloss_sy)),
                          torch.as_tensor(np.array(ve.eloss_br)),
                          jsim.cfg.physics, jsim.scales)
    for name in rj._fields:
        ref = np.asarray(getattr(rj, name))
        np.testing.assert_allclose(getattr(rp, name).numpy(), ref,
                                   rtol=1e-5, err_msg=name)
    assert float(np.abs(np.asarray(rj.dT_c)).min()) > 0.0


def test_photon_fill_diagnostic_first_cycle_rates():
    """tests/test_fp.py::test_photon_fill_first_cycle_rates on the port:
    after one step every rate finite, dT_c nonzero in every zone,
    dT_sy <= 0, d_t_opt > 0 and the total cooling somewhere."""
    sim = pex.small_corona(nz=3, nr=2, nst=2000, n_slots=4096, seed=3,
                           device="cpu")
    with pytest.raises(RuntimeError):
        sim.photon_fill_diagnostic()
    sim.step()
    r = sim.photon_fill_diagnostic()
    for name, arr in r._asdict().items():
        assert bool(torch.all(torch.isfinite(arr))), name
    assert bool(torch.all(torch.abs(r.dT_c) > 0.0))
    assert bool(torch.all(r.dT_sy <= 0.0))
    assert bool(torch.all(r.d_t_opt > 0.0))
    assert float(r.dT_total.min()) < 0.0
