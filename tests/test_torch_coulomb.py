"""The port's Coulomb FP drift against the JAX reference: the host
integrals (rtol 1e-12), the tables (within 1 float32 ulp, the full
default build once a session for both sides), the table lookup and the
table-free drift (rtol 1e-6), ``fp_step`` with the Coulomb terms on state
carried over from a reference Simulation (within 1e-5 of each array's
largest value), and the Coulomb slice z-tested against the reference's
Pallas path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu.fp import update as jupd
from compton2d_tpu.physics import coulomb as jcl
from compton2d_tpu.physics.emissivity import volume_em as j_volume_em
from compton2d_tpu_torch import convert
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.fp import update as pupd
from compton2d_tpu_torch.physics import coulomb as pcl
from compton2d_tpu_torch.physics.electron_dist import gnt_grid

torch.set_num_threads(2)

NUM_NT = 50          # every Simulation here: one table build a side
CFG = dict(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=NUM_NT, n_vol=64,
           nphfield=64, t_const=False, fp_include_coulomb=True)
SEEDS = (0, 1, 2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64))))


@pytest.fixture(scope="session")
def default_tables():
    """The default tables at the tests' gamma grid, built once by each
    side; the JAX package's builder answers later calls with the same
    arguments (its Simulation's) from a cache for the session."""
    gnt = np.asarray(gnt_grid(NUM_NT), np.float32)
    build = jcl.build_coulomb_tables
    cache = {}

    def cached(g, te_grid=None, tp_grid=None, lnL=20.0, gamma_cp_max=3.0):
        key = (np.asarray(g).tobytes(), None if te_grid is None else
               np.asarray(te_grid).tobytes(), None if tp_grid is None
               else np.asarray(tp_grid).tobytes(), lnL, gamma_cp_max)
        if key not in cache:
            cache[key] = build(g, te_grid, tp_grid, lnL, gamma_cp_max)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "build_coulomb_tables", cached)
        jt = jcl.build_coulomb_tables(gnt)
        yield jt, pcl.build_coulomb_tables(gnt)


GB = np.array([1.02, 1.3, 2.5, 8.0])


@pytest.mark.parametrize("name", ["ch_f", "z_f", "dg_mo", "disp_mo",
                                  "intdgcp", "_inteta", "intd2cp"])
def test_integrals_match_reference(name):
    """Each host integral at a few (gamma, theta, kTp): rtol 1e-12 (all but
    intd2cp are the reference's arithmetic; intd2cp sums its blocks of
    proton Lorentz factors in the reference's order)."""
    beta = np.sqrt(1.0 - 1.0 / GB**2)
    x = np.array([0.5, 1.0, 1.000000011, 1.7, 40.0])
    cases = {
        "ch_f": [(x,)],
        "z_f": [(1.3, 2.0, x), (4.0, 1.2, x)],
        "dg_mo": [(GB, beta, th) for th in (0.01, 0.2, 1.5)],
        "disp_mo": [(GB, beta, th) for th in (0.01, 0.2, 1.5)],
        "intdgcp": [(g, b, kt) for g, b in zip(GB[:3], beta)
                    for kt in (5.0, 300.0, 1e5)],
        "_inteta": [(1.01, 1.3, p, 2.5, 4.0) for p in (0.0, 1.0, 2.0)]
        + [(1.3, 1.01, 1.0, 2.5, 4.0), (1.0, 50.0, 2.0, 30.0, 10.0)],
        "intd2cp": [(np.float32(g), np.float32(b), kt, 20.0)
                    for g, b in zip(GB[:2], beta) for kt in (5.0, 1e5)]
        + [(np.float32(2.5), np.float32(beta[2]), 300.0, 15.0)],
    }[name]
    for args in cases:
        ref = getattr(jcl, name)(*args)
        got = getattr(pcl, name)(*args)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0,
                                   err_msg=f"{name}{args[1:]}")
        assert np.all(np.isfinite(got))


def test_small_grid_tables_within_one_ulp():
    """Three Te and two Tp points, another lnL and gamma_cp_max: every
    table within 1 float32 ulp of the reference's."""
    gnt = np.asarray(gnt_grid(NUM_NT), np.float32)
    kw = dict(te_grid=np.array([8.0, 90.0, 700.0]),
              tp_grid=np.array([20.0, 3.0e4]), lnL=15.0, gamma_cp_max=2.0)
    jt = jcl.build_coulomb_tables(gnt, **kw)
    pt = pcl.build_coulomb_tables(gnt, **kw)
    for name in jcl.CoulombTables._fields:
        assert _ulps(_np(getattr(pt, name)), getattr(jt, name)) <= 1, name
    assert float(np.abs(_np(pt.disp_cp)).max()) > 0.0


def test_default_tables_within_one_ulp(default_tables):
    """The default (24 Te x 8 Tp) tables within 1 ulp; a second build is
    the memoised one, equal and in tensors of its own."""
    jt, pt = default_tables
    for name in jcl.CoulombTables._fields:
        assert _ulps(_np(getattr(pt, name)), getattr(jt, name)) <= 1, name
        assert np.all(np.isfinite(_np(getattr(pt, name))))
    again = pcl.build_coulomb_tables(np.asarray(gnt_grid(NUM_NT),
                                                np.float32))
    for a, b in zip(again, pt):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    conv = convert.coulomb_tables(convert.flatten(jt), device="cpu")
    for name in jcl.CoulombTables._fields:
        np.testing.assert_array_equal(_np(getattr(conv, name)),
                                      np.asarray(getattr(jt, name)))


def test_lookup_matches_reference(default_tables):
    """Rows below, inside, on and above both temperature grids (5 and 1000
    keV are the Te grid's ends, 5 and 1e5 keV the Tp grid's): rtol 1e-6."""
    jt, pt = default_tables
    te = np.array([2.0, 5.0, 17.3, 100.0, 412.9, 1000.0, 1500.0], np.float32)
    tp = np.array([1.0, 5.0, 60.0, 2.2e3, 5.5e4, 1.0e5, 1.0e6], np.float32)
    ref = jt.lookup(None, jnp.asarray(te), jnp.asarray(tp))
    got = (pt.electron_rows(torch.as_tensor(te))
           + pt.proton_rows(torch.as_tensor(tp)))
    for name, g, r in zip(("dg_ce", "disp_ce", "dg_cp", "disp_cp"), got,
                          ref):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r, rtol=1e-6,
                                   atol=1e-6 * np.abs(r).max(), err_msg=name)


def test_coulomb_drift_matches_reference():
    rng = np.random.default_rng(11)
    gamma = (np.asarray(gnt_grid(NUM_NT), np.float32) + 1.0)
    tna = rng.uniform(1.0, 3e3, 6).astype(np.float32)
    n_p = rng.uniform(1e8, 1e12, 6).astype(np.float32)
    ref = jupd._coulomb_drift(jnp.asarray(gamma), jnp.asarray(tna),
                              jnp.asarray(n_p), 20.0)
    got = pupd._coulomb_drift(*map(torch.as_tensor, (gamma, tna, n_p)),
                              20.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-6)


@pytest.fixture(scope="module")
def carried():
    """A reference Simulation's initial state carried over to the port,
    a radiation field from one port step, and the reference's synchrotron
    loss on that state (tests/test_torch_fp.py's inputs at NUM_NT)."""
    kw = dict(nz=3, nr=2, nst=2000, n_slots=4096, num_nt=NUM_NT, n_vol=48,
              nphfield=48, t_const=False, seed=3)
    jsim = jex.small_corona(**kw)
    psim = pex.small_corona(**kw, device="cpu")
    psim.step()
    n_field = psim.last_outputs.tallies.n_field.numpy()
    js, jt, jg = jsim.state, jsim.tables, jsim.grid
    state, tables, grid, _, _ = convert.from_reference(
        convert.flatten(js), convert.flatten(jt), convert.flatten(jg),
        convert.flatten(jsim.src_static), device="cpu")
    l_min = jnp.minimum(jg.dz, jg.dr) * jnp.ones_like(jg.vol)
    z = js.zones
    ve = j_volume_em(jt.e_ph, jt.gnt, z.f_nt, z.tea, z.n_e, z.B_field,
                     z.amxwl, jg.vol, jg.zone_surf, l_min, js.dt, jt.sync,
                     jsim.scales, f_pair=z.f_pair)
    return jsim, psim, state, tables, grid, n_field, np.array(ve.eloss_sy)


def _fp_pair(carried, coulomb_on: bool, jtab, ptab):
    jsim, psim, state, tables, grid, n_field, eloss_sy = carried
    js, jt, jg = jsim.state, jsim.tables, jsim.grid
    jphys = dataclasses.replace(jsim.cfg.physics,
                                fp_include_coulomb=coulomb_on)
    pphys = dataclasses.replace(psim.cfg.physics,
                                fp_include_coulomb=coulomb_on)
    rj = jupd.fp_step(js.zones, jnp.asarray(n_field), jt, jg.vol,
                      float(jsim.cfg.grid.z_max), jg.dz, js.dt, js.time,
                      jnp.asarray(eloss_sy), jphys, jsim.scales,
                      coulomb=jtab)
    rp = pupd.fp_step(state.zones, torch.as_tensor(n_field), tables,
                      grid.vol, float(psim.cfg.grid.z_max), grid.dz,
                      state.dt, state.time, torch.as_tensor(eloss_sy),
                      pphys, psim.scales, pupd.fp_constants(
                          tables.gnt, float(psim.cfg.grid.z_max), pphys),
                      coulomb=ptab)
    return rj, rp


FP_FIELDS = ("tea", "n_e", "f_nt", "cdf_nt", "amxwl")


@pytest.mark.parametrize("with_tables", [True, False])
def test_fp_step_with_coulomb_matches_reference(carried, default_tables,
                                                with_tables):
    """fp_step with the Coulomb terms (the tables, or without them the
    Spitzer-like drift): substeps exact, every zone field within 1e-5 of
    its largest value; the same inputs without the Coulomb terms differ
    from the reference's Coulomb step by more than that."""
    jt, pt = default_tables if with_tables else (None, None)
    rj, rp = _fp_pair(carried, True, jt, pt)
    assert int(rp.substeps) == int(rj.substeps) > 1
    assert int(rp.incomplete) == int(rj.incomplete)
    for name in ("e_el_old", "e_el_new", "dT_max"):
        np.testing.assert_allclose(_np(getattr(rp, name)),
                                   _np(getattr(rj, name)), rtol=1e-5,
                                   err_msg=name)
    for name in FP_FIELDS:
        ref = _np(getattr(rj.zones, name))
        np.testing.assert_allclose(_np(getattr(rp.zones, name)), ref,
                                   rtol=0.0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    _, rp_off = _fp_pair(carried, False, None, None)
    gaps = [np.abs(_np(getattr(rp_off.zones, n))
                   - _np(getattr(rj.zones, n))).max()
            / np.abs(_np(getattr(rj.zones, n))).max() for n in FP_FIELDS]
    assert max(gaps) > 1e-4, gaps


def _observables(audit, tea):
    return np.array([audit["escaped"], audit["census"], float(np.mean(tea))])


def test_coulomb_slice_matches_reference_statistically(default_tables):
    """small_corona with fp_include_coulomb after 2 steps: escaped and
    census energy and mean Te agree with the reference's Pallas path
    (interpret mode) within z < 4 over 3 seeds a side, as
    tests/test_torch_slice.py's main path (0.1% floor on the standard
    error)."""
    jsim = jex.small_corona(**CFG, seed=0)
    jsim = jsim.with_config(dataclasses.replace(
        jsim.cfg, run=dataclasses.replace(jsim.cfg.run,
                                          pallas_tracking="on")))
    assert jsim.coulomb_tables is not None
    init = jsim.state
    ref, port = [], []
    for s in SEEDS:
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        jsim.run(2)
        ref.append(_observables(jsim.energy_audit(),
                                np.asarray(jsim.state.zones.tea)))
        psim = pex.small_corona(**CFG, seed=s, device="cpu")
        assert psim.coulomb_tables is not None
        psim.run(2)
        a = psim.energy_audit()
        assert abs(a["balance"] - 1.0) < 2e-3, a
        port.append(_observables(a, psim.state.zones.tea.numpy()))
    ref, port = np.array(ref), np.array(port)
    k = len(SEEDS)
    se = np.sqrt(ref.var(0, ddof=1) / k + port.var(0, ddof=1) / k)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    z = np.abs(port.mean(0) - ref.mean(0)) / se
    assert np.all(z < 4.0), (z, port.mean(0), ref.mean(0))

