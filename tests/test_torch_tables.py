"""Grid, static tables and initial zone state of the port against the JAX
reference: host float64 builders bitwise, float32 arrays allclose."""
import dataclasses

import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu import constants as jcn
from compton2d_tpu import grid as jgrid
from compton2d_tpu import tables as jtables
from compton2d_tpu import units as junits
from compton2d_tpu.physics import compton as jcompton
from compton2d_tpu.physics import electron_dist as jed
from compton2d_tpu.physics import emissivity as jem
from compton2d_tpu.physics import icloss as jicloss
from compton2d_tpu.physics import reflection as jrefl
from compton2d_tpu.state import init_zone_state as j_init_zone_state
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import constants as pcn
from compton2d_tpu_torch import grid as pgrid
from compton2d_tpu_torch import tables as ptables
from compton2d_tpu_torch import units as punits
from compton2d_tpu_torch.physics import compton as pcompton
from compton2d_tpu_torch.physics import electron_dist as ped
from compton2d_tpu_torch.physics import emissivity as pem
from compton2d_tpu_torch.physics import icloss as picloss
from compton2d_tpu_torch.physics import reflection as prefl
from compton2d_tpu_torch.state import init_zone_state as p_init_zone_state

torch.set_num_threads(2)

GRID = dict(
    nz=3, nr=2, z_max=1.0e15, r_max=2.0e15, num_nt=50, n_vol=64,
    nphfield=64, n_gg=32, n_ref=100, nmu=4,
    spectral_regions=((1e-4, 1e-1, 20), (1e-1, 1e4, 40)),
    lc_bands=((2.0, 10.0), (10.0, 50.0)),
)
L = 2.0e15


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tuple_equal(port, ref, exact=True, rtol=1e-5):
    for name in ref._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if hasattr(b, "_fields"):
            _assert_tuple_equal(a, b, exact, rtol)
        elif exact:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=rtol,
                                       atol=1e-30, err_msg=name)


def test_host_f64_builders_bitwise():
    gnt = jed.gnt_grid(200)
    np.testing.assert_array_equal(ped.gnt_grid(200), gnt)
    e = jtables.e_field_grid(400).astype(np.float32)
    np.testing.assert_array_equal(ptables.e_field_grid(400),
                                  jtables.e_field_grid(400))
    np.testing.assert_array_equal(ptables.e_gg_grid(32), jtables.e_gg_grid(32))
    g32 = gnt.astype(np.float32)
    np.testing.assert_array_equal(pcompton.sigma_e_table(e, g32),
                                  jcompton.sigma_e_table(e, g32))
    theta = np.geomspace(1e-4, 30.0, 97)
    np.testing.assert_array_equal(ped.gamma_bar_np(theta),
                                  jed.gamma_bar_np(theta))
    t = np.geomspace(1e-12, 2e4, 301)
    for name in ("expk13", "expk43", "sync_kernel"):
        np.testing.assert_array_equal(getattr(pem, name)(t),
                                      getattr(jem, name)(t), err_msg=name)
    ef = jtables.e_field_grid(64).astype(np.float32)
    np.testing.assert_array_equal(picloss.fic_table(g32[:50], ef),
                                  jicloss.fic_table(g32[:50], ef))
    np.testing.assert_array_equal(prefl.pref_matrix(100),
                                  jrefl.pref_matrix(100))
    np.testing.assert_array_equal(prefl.wabs_matrix(100),
                                  jrefl.wabs_matrix(100))


def test_copied_config_modules_match():
    """The port's copies of config / constants / units agree with the
    reference's field for field."""
    for name in dir(jcn):
        if name.isupper():
            assert getattr(pcn, name) == getattr(jcn, name), name
    for cls in ("GridConfig", "PhysicsConfig", "SourceConfig", "RunConfig"):
        assert dataclasses.asdict(getattr(pcfg, cls)()) == \
            dataclasses.asdict(getattr(jcfg, cls)()), cls
    gp, gj = pcfg.GridConfig(**GRID), jcfg.GridConfig(**GRID)
    np.testing.assert_array_equal(gp.spectral_edges(), gj.spectral_edges())
    np.testing.assert_array_equal(gp.mu_edges(), gj.mu_edges())
    sp, sj = punits.make_scales(1e15, 2e15, 3e48), junits.make_scales(
        1e15, 2e15, 3e48)
    for prop in ("L2", "L3", "c", "inv_c", "sigma_sb", "mec2_vol",
                 "nfield_to_dgic"):
        assert getattr(sp, prop) == getattr(sj, prop), prop


def test_grid_and_initial_dt_match():
    gp = pgrid.make_grid(pcfg.GridConfig(**GRID), L)
    gj = jgrid.make_grid(jcfg.GridConfig(**GRID), L)
    _assert_tuple_equal(gp, gj)
    assert pgrid.initial_dt(gp, 0.3, 3e10, L) == jgrid.initial_dt(
        gj, 0.3, 3e10, L)


def test_build_tables_match():
    tp = ptables.build_tables(pcfg.GridConfig(**GRID), L)
    tj = jtables.build_tables(jcfg.GridConfig(**GRID), L)
    _assert_tuple_equal(tp, tj)


@pytest.mark.parametrize("amxwl", [1.0, 0.3])
def test_init_zone_state_matches(amxwl):
    """Thermal and hybrid thermal + power-law zones, rtol 1e-5 (the
    distributions use exp / pow in float32 on both sides)."""
    zi = dict(tea=np.array([[50.0, 80.0], [120.0, 200.0], [30.0, 10.0]]),
              tna=np.full((3, 2), 90.0), n_e=np.full((3, 2), 1e10),
              B_field=np.full((3, 2), 10.0), amxwl=np.full((3, 2), amxwl),
              gmin=np.full((3, 2), 20.0), gmax=np.full((3, 2), 1e4),
              p_nth=np.full((3, 2), 2.4), q_turb=np.full((3, 2), 1.6667),
              turb_lev=np.zeros((3, 2)), ep_switch=np.zeros((3, 2), np.int32))
    cp = pcfg.SimConfig(grid=pcfg.GridConfig(**GRID))
    cj = jcfg.SimConfig(grid=jcfg.GridConfig(**GRID))
    zp = p_init_zone_state(cp, pcfg.ZoneInit(**zi),
                           ptables.build_tables(cp.grid, L))
    zj = j_init_zone_state(cj, jcfg.ZoneInit(**zi),
                           jtables.build_tables(cj.grid, L))
    for name in zj._fields:
        a, b = _np(getattr(zp, name)), _np(getattr(zj, name))
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max() + 1e-30,
                                   err_msg=name)


def test_copied_io_modules_and_mrk421_constants_match():
    """The port's copies of the numpy-only io code are the reference's
    source text, and its Mrk 421 and blazar configurations, constants and
    initial zones equal the reference's."""
    import inspect

    from compton2d_tpu import examples as jex
    from compton2d_tpu.io import checkpoint as jckpt
    from compton2d_tpu.io import outputs as jout
    from compton2d_tpu.io import postprocess as jpp
    from compton2d_tpu_torch import examples as pex
    from compton2d_tpu_torch.io import checkpoint as pckpt
    from compton2d_tpu_torch.io import outputs as pout
    from compton2d_tpu_torch.io import postprocess as ppp

    for ref, port, names in (
            (jpp, ppp, ("doppler_transform", "LightCurves", "light_curves",
                        "SED", "sed")),
            (jout, pout, ("OutputAccumulator",)),
            (jckpt, pckpt, ("WalltimeGuard",))):
        for name in names:
            assert inspect.getsource(getattr(port, name)) == \
                inspect.getsource(getattr(ref, name)), name
    assert (ppp.C_INV, pout.KEV_TO_HZ) == (jpp.C_INV, jout.KEV_TO_HZ)
    for name in ("MRK421_GAMMA", "MRK421_MU_RANGE", "MRK421_DT_S",
                 "MRK421_BANDS"):
        assert getattr(pex, name) == getattr(jex, name), name
    kw = dict(nz=3, nr=2, nst=500, n_slots=2048)
    for ctor in ("mrk421", "blazar_jet"):
        js = getattr(jex, ctor)(**kw)
        ps = getattr(pex, ctor)(**kw, device="cpu")
        assert dataclasses.asdict(ps.cfg) == dataclasses.asdict(js.cfg), ctor
        for f in dataclasses.fields(js.zone_init):
            np.testing.assert_array_equal(
                np.asarray(getattr(ps.zone_init, f.name)),
                np.asarray(getattr(js.zone_init, f.name)), err_msg=f.name)


def test_zone_pass_on_converted_mrk421_state():
    """A reference mrk421 state carried over with convert.from_reference:
    the B field, volume emission and Compton opacity of the port match the
    reference's on it, allclose 1e-5, with float32 denormals flushed as
    XLA flushes them. At the radio end of the Mrk 421 grid the terms of the
    synchrotron self-absorption integral are subnormal: the reference's
    kappa is 0 there, and the port, which keeps denormals (on the CPU and
    on the card), finds a positive kappa that differs nowhere else."""
    import jax.numpy as jnp

    from compton2d_tpu import examples as jex
    from compton2d_tpu_torch import convert

    jsim = jex.mrk421(nz=4, nr=2, nst=1500, n_slots=8192, num_nt=160,
                      n_vol=64, nphfield=64)
    js, jt, jg = jsim.state, jsim.tables, jsim.grid
    state, tabs, grid, _, _ = convert.from_reference(
        convert.flatten(js), convert.flatten(jt), convert.flatten(jg),
        convert.flatten(jsim.src_static), device="cpu")
    zj, zp = js.zones, state.zones

    def close(a, b, name):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-8 * np.abs(b).max() + 1e-37,
                                   err_msg=name)

    bj = jem.equipartition_b(zj.ep_switch, zj.tea, zj.tna, zj.n_e, zj.f_pair,
                             zj.B_field, jt.gamma_bar.forward)
    bp = pem.equipartition_b(zp.ep_switch, zp.tea, zp.tna, zp.n_e, zp.f_pair,
                             zp.B_field, tabs.gamma_bar.forward)
    close(bp, bj, "B")
    lj = jnp.minimum(jg.dz, jg.dr) * jnp.ones_like(jg.vol)
    lp = torch.minimum(grid.dz, grid.dr) * torch.ones_like(grid.vol)
    vj = jem.volume_em(jt.e_ph, jt.gnt, zj.f_nt, zj.tea, zj.n_e, bj,
                       zj.amxwl, jg.vol, jg.zone_surf, lj, js.dt, jt.sync,
                       jsim.scales, f_pair=zj.f_pair)
    scales = punits.make_scales(jsim.cfg.grid.z_max, jsim.cfg.grid.r_max,
                                jsim.scales.E)

    def port_volume_em():
        return pem.volume_em(tabs.e_ph, tabs.gnt, zp.f_nt, zp.tea, zp.n_e,
                             torch.as_tensor(np.array(bj)), zp.amxwl,
                             grid.vol, grid.zone_surf, lp, state.dt, scales,
                             f_pair=zp.f_pair)

    assert torch.set_flush_denormal(True)
    try:
        vp = port_volume_em()
    finally:
        torch.set_flush_denormal(False)
    for name in vj._fields:
        close(getattr(vp, name), getattr(vj, name), name)
    kap_j = np.asarray(vj.kappa_tot)
    kap_p = port_volume_em().kappa_tot.numpy()
    differ = kap_p != kap_j
    assert np.all(kap_j[differ] == 0.0) and np.all(kap_p[differ] > 0.0)
    e_low = np.asarray(jt.e_ph)[np.any(differ, axis=(0, 1))]
    assert e_low.size and e_low.max() < 3e-2
    close(pcompton.zone_sigma_table(tabs.sigma_e, zp.f_nt, tabs.gnt, zp.n_e),
          jcompton.zone_sigma_table(jt.sigma_e, zj.f_nt, jt.gnt, zj.n_e),
          "sigma_zone")
