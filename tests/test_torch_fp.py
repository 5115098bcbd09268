"""The port's Fokker-Planck update against the JAX reference: the
Chang-Cooper coefficients, the PCR solve (and the Thomas oracle), and
``fp_step`` from zone state carried over from a reference Simulation
(``compton2d_tpu_torch.convert``) with the same radiation field, rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu.fp import chang_cooper as jcc
from compton2d_tpu.fp.update import fp_step as j_fp_step
from compton2d_tpu.physics.emissivity import volume_em as j_volume_em
from compton2d_tpu_torch import convert
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.fp import chang_cooper as pcc
from compton2d_tpu_torch.fp.update import fp_constants
from compton2d_tpu_torch.fp.update import fp_step as p_fp_step

torch.set_num_threads(2)

RTOL = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cc_inputs(seed=0, Z=4, N=50):
    rng = np.random.default_rng(seed)
    gnt = (0.2 * 1.1 ** (np.arange(N) - 1.0)).astype(np.float32)
    g = gnt + 1.0
    dgdt = (-rng.uniform(1e-6, 1e-4, (Z, 1)) * (g * g - 1.0)
            + rng.uniform(1e-7, 1e-5, (Z, 1)) * g).astype(np.float32)
    disp = (rng.uniform(1e-7, 1e-5, (Z, 1)) * g * g / 2.0).astype(np.float32)
    d_t = rng.uniform(10.0, 1e3, Z).astype(np.float32)
    return gnt, dgdt, disp, d_t


def test_chang_cooper_coeffs_match():
    gnt, dgdt, disp, d_t = _cc_inputs()
    tj = 3.0e4
    a_p = pcc.chang_cooper_coeffs(*map(torch.as_tensor, (gnt, dgdt, disp,
                                                          d_t)), tj)
    a_j = jcc.chang_cooper_coeffs(*map(jnp.asarray, (gnt, dgdt, disp, d_t)),
                                  tj)
    for x, y in zip(a_p, a_j):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-5,
                                   atol=1e-7 * np.abs(_np(y)).max())


def test_pcr_and_thomas_match_reference():
    gnt, dgdt, disp, d_t = _cc_inputs(1)
    a, b, c = jcc.chang_cooper_coeffs(
        *map(jnp.asarray, (gnt, dgdt, disp, d_t)), 3.0e4)
    d = np.random.default_rng(2).uniform(0.0, 1.0, a.shape).astype(
        np.float32)
    abcd_t = [torch.as_tensor(np.array(x)) for x in (a, b, c, d)]
    ref = np.asarray(jcc.pcr_solve(a, b, c, jnp.asarray(d)))
    got = _np(pcc.pcr_solve(*abcd_t))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)
    # the Thomas oracle agrees with the reference's and with PCR
    th_ref = np.asarray(jcc.thomas_solve(a, b, c, jnp.asarray(d)))
    th = _np(pcc.thomas_solve(*abcd_t))
    np.testing.assert_allclose(th, th_ref, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got, th, rtol=RTOL, atol=1e-7)


def test_chang_cooper_under_strong_heating():
    """A heating drift so strong against the dispersion that the
    Chang-Cooper argument w = dg B / C falls below -500 in the first two
    rows (a hard photon field heating cold electrons). There the port
    takes the weights' limits (w / (e^w - 1) -> -w, w / (1 - e^-w) -> 0):
    its rows stay an M-matrix (a, c <= 0, b >= 1) and the PCR solve is
    finite and equals the Thomas oracle, rtol 1e-4. The reference clips w
    at -500, which makes c positive there. Rows whose |w| stays within 500
    match the reference's coefficients as in test_chang_cooper_coeffs_match.
    """
    gnt, dgdt, disp, d_t = _cc_inputs(4)
    g = gnt + 1.0
    dgdt[:2] = (1e-2 * g).astype(np.float32)
    disp[:2] = (1e-9 * g * g / 2.0).astype(np.float32)
    tj = 3.0e4
    a_p, b_p, c_p = (_np(x) for x in pcc.chang_cooper_coeffs(
        *map(torch.as_tensor, (gnt, dgdt, disp, d_t)), tj))
    a_j, b_j, c_j = (_np(x) for x in jcc.chang_cooper_coeffs(
        *map(jnp.asarray, (gnt, dgdt, disp, d_t)), tj))
    assert np.any(c_j[:2] > 0.0)          # the reference's sign fault
    assert np.all(a_p <= 0.0) and np.all(c_p <= 0.0) and np.all(b_p >= 1.0)
    for x, y in ((a_p, a_j), (b_p, b_j), (c_p, c_j)):
        np.testing.assert_allclose(x[2:], y[2:], rtol=1e-5,
                                   atol=1e-7 * np.abs(y[2:]).max())
    d = np.random.default_rng(5).uniform(0.0, 1.0, a_p.shape).astype(
        np.float32)
    abcd = [torch.as_tensor(x) for x in (a_p, b_p, c_p, d)]
    got = _np(pcc.pcr_solve(*abcd))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, _np(pcc.thomas_solve(*abcd)), rtol=RTOL,
                               atol=1e-7)


@pytest.fixture(scope="module")
def carried():
    """A reference Simulation's initial state carried over to the port,
    plus a radiation field from one port step and the reference's
    synchrotron loss on that state."""
    kw = dict(nz=3, nr=2, nst=2000, n_slots=4096, num_nt=50, n_vol=48,
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


def test_convert_carries_state_exactly(carried):
    jsim, _, state, tables, grid, _, _ = carried
    for name, val in convert.flatten(jsim.state).items():
        if name == "key":
            continue
        obj = state
        for part in name.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(_np(obj), val, err_msg=name)
    np.testing.assert_array_equal(_np(tables.sync.val),
                                  np.asarray(jsim.tables.sync.val))
    np.testing.assert_array_equal(_np(grid.vol), np.asarray(jsim.grid.vol))


def test_fp_step_matches_reference(carried):
    """Substep count and incompleteness exact; zone fields rtol 1e-4;
    p_nth to one step of the refit's 0.05 candidate grid (an argmin over
    near-equal misfits may pick a neighbour)."""
    jsim, psim, state, tables, grid, n_field, eloss_sy = carried
    phys, scales = jsim.cfg.physics, jsim.scales
    js, jt, jg = jsim.state, jsim.tables, jsim.grid
    rj = j_fp_step(js.zones, jnp.asarray(n_field), jt, jg.vol,
                   float(jsim.cfg.grid.z_max), jg.dz, js.dt, js.time,
                   jnp.asarray(eloss_sy), phys, scales)
    rp = p_fp_step(state.zones, torch.as_tensor(n_field), tables, grid.vol,
                   float(psim.cfg.grid.z_max), grid.dz, state.dt,
                   state.time, torch.as_tensor(eloss_sy),
                   psim.cfg.physics, psim.scales, fp_constants(
                       tables.gnt, float(psim.cfg.grid.z_max),
                       psim.cfg.physics))
    assert int(rp.substeps) == int(rj.substeps)
    assert int(rp.incomplete) == int(rj.incomplete)
    assert int(rj.substeps) > 1                  # the substep loop ran
    assert float(rj.dT_max) > 1e-3               # the zones evolved
    for name in ("dt_new", "dT_max", "e_el_old", "e_el_new"):
        np.testing.assert_allclose(_np(getattr(rp, name)),
                                   _np(getattr(rj, name)), rtol=RTOL,
                                   err_msg=name)
    for name in ("tea", "n_e", "f_nt", "cdf_nt", "gmin", "gmax", "amxwl"):
        ref = _np(getattr(rj.zones, name))
        np.testing.assert_allclose(
            _np(getattr(rp.zones, name)), ref, rtol=RTOL,
            atol=RTOL * 1e-3 * np.abs(ref).max(), err_msg=name)
    np.testing.assert_allclose(_np(rp.zones.p_nth), _np(rj.zones.p_nth),
                               atol=0.051)


def test_float64_zones_hand_the_loop_float64_rows(monkeypatch):
    """fp_step on float64 zones (the precision check) hands the substep
    loop float64 rows, the injection profile among them (the Gaussian
    evaluated in float64, its last bin 0), and the escape time both as
    the kernel's float and as a tensor on the zones' device."""
    from compton2d_tpu_torch.fp import update

    sim = pex.small_corona(nz=2, nr=2, nst=200, n_slots=1024, num_nt=40,
                           n_vol=32, nphfield=32, device="cpu")
    seen = []

    def stop(lp):
        seen.append(lp)
        raise RuntimeError("stop")

    monkeypatch.setattr(update, "substep_loop", stop)
    z = sim.state.zones
    z64 = z._replace(**{f: getattr(z, f).double() for f in z._fields
                        if getattr(z, f).is_floating_point()})
    cfg, f64 = sim.cfg, torch.float64
    with pytest.raises(RuntimeError, match="stop"):
        update.fp_step(z64, torch.zeros(2, 2, 32, dtype=f64), sim.tables,
                       sim.grid.vol, float(cfg.grid.z_max), sim.grid.dz,
                       sim.state.dt, sim.state.time,
                       torch.zeros(2, 2, dtype=f64), cfg.physics,
                       sim.scales, sim.consts.fp)
    (lp,) = seen
    gamma = sim.tables.gnt.to(f64) + 1.0
    inj = cfg.physics.injection
    prof = torch.exp(-((gamma - inj.gauss_g) * (gamma - inj.gauss_g))
                     / (2.0 * inj.gauss_sigma**2))
    prof[-1] = 0.0
    assert lp.f.dtype == lp.gauss_prof.dtype == f64
    assert torch.equal(lp.gauss_prof, prof)
    assert lp.t_esc_dev.device == z64.f_nt.device
    assert float(lp.t_esc_dev) == lp.t_esc > 0.0
