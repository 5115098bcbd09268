"""File-spectrum boundaries (tbb < 0) of the port against the JAX package:
the spectrum bank and the windows' on/off variants, per-ring banks,
emit's file branch with the reference's own uniforms (energies by an exact
inverse CDF, where the reference lerps a 4096-knot quantile table), the
beamed upward direction, and the energy scale of a file-lit deck. After
tests/test_windows.py and tests/test_external_source.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu import examples as jex
from compton2d_tpu.driver import Simulation as JSim
from compton2d_tpu.driver import _estimate_energy_scale as j_scale
from compton2d_tpu.io import diskgen
from compton2d_tpu.state import PhotonArray as JPhotons
from compton2d_tpu.transport import sourcing as jsrc
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.driver import Simulation as PSim
from compton2d_tpu_torch.driver import _estimate_energy_scale as p_scale
from compton2d_tpu_torch.io import legacy as pleg
from compton2d_tpu_torch.physics import planck
from compton2d_tpu_torch.physics.emissivity import normalized_cdf
from compton2d_tpu_torch.state import PhotonArray as PPhotons
from compton2d_tpu_torch.transport import sourcing as psrc

torch.set_num_threads(2)

NZ, NR, N = 2, 2, 4096
EXT = dict(R_blr=1e17, fr_blr=0.1, R_ir=1e18, fr_ir=0.3, R_disk=1e15,
           d_jet=1e17, g_bulk=10.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _configs(files, t0=0.0):
    """Both packages' configs of tests/test_windows.py's grid with the lower
    rings lit by ``files`` (one per ring) from ``t0``."""
    out = []
    for cfg in (jcfg, pcfg):
        grid = cfg.GridConfig(
            nz=NZ, nr=NR, z_max=1e15, r_max=1e15, num_nt=40, n_vol=32,
            nphfield=32, n_gg=16, n_ref=50, nmu=4,
            spectral_regions=((1e-4, 1e-1, 10), (1e-1, 1e4, 20)),
            lc_bands=((2.0, 10.0),))
        win = cfg.TimeWindow(
            t0=t0, t1=1e30, tbb_lower=(-1.0,) * NR,
            tbb_upper=(0.0,) * NR, tbb_inner=(0.0,) * NZ,
            tbb_outer=(0.0,) * NZ, lower_spectra=tuple(files))
        out.append(cfg.SimConfig(
            grid=grid, physics=cfg.PhysicsConfig(t_const=True),
            source=cfg.SourceConfig(
                nst=3000, external=cfg.ExternalRadiationConfig(**EXT)),
            run=cfg.RunConfig(seed=0, n_slots=N, event_capacity=N,
                              energy_scale=1e40),
            windows=(win,)))
    return out


@pytest.fixture(scope="module")
def bank_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spec") / "bb.in")
    diskgen.write_spectrum_file(path, gamma_bulk=10.0)
    return path


@pytest.fixture(scope="module")
def sims(bank_file):
    cj, cp = _configs((bank_file,) * NR)
    zj = jcfg.ZoneInit.uniform(cj.grid, tea=10.0, n_e=1.0, B_field=1e-6)
    zp = pcfg.ZoneInit.uniform(cp.grid, tea=10.0, n_e=1.0, B_field=1e-6)
    return JSim(cj, zj), PSim(cp, zp, device="cpu")


def _assert_source_equal(sp, sj):
    """Every field of the port's SourceStatic equals the reference's (the
    bank bit for bit; the reference's quantile table has no counterpart,
    and the port's Planck CDF is the reference's module constant)."""
    assert set(sp._fields) - {"planck_cdf"} == set(sj._fields) - {"spec_inv"}
    np.testing.assert_array_equal(_np(sp.planck_cdf),
                                  np.float32(planck.CDF_M))
    for name in sorted(set(sp._fields) - {"planck_cdf"}):
        np.testing.assert_array_equal(_np(getattr(sp, name)),
                                      np.asarray(getattr(sj, name)),
                                      err_msg=name)


def test_bank_and_off_variant_and_t0(bank_file):
    """The bank (row 0 the dummy, one row per distinct file), the flux of
    each ring, and the window pick: the off variant (no file flux) until
    time + dt/2 reaches t0, at the same host times as the reference."""
    dt = 100.0
    cj, cp = _configs((bank_file,) * NR, t0=2.49 * dt)
    zj = jcfg.ZoneInit.uniform(cj.grid)
    zp = pcfg.ZoneInit.uniform(cp.grid)
    wj, wp = JSim(cj, zj).window_sources, PSim(cp, zp,
                                                device="cpu").window_sources
    np.testing.assert_array_equal(wp.t0, wj.t0)
    np.testing.assert_array_equal(wp.t1, wj.t1)
    for a, b in zip(wp.on + wp.off, wj.on + wj.off):
        _assert_source_equal(a, b)
    assert wp.on[0].spec_e.shape[0] == 2
    assert float(wp.on[0].flux_lower[0]) > 0.0
    assert float(torch.sum(wp.off[0].flux_lower)) == 0.0
    for step in range(5):
        time = step * dt
        on_p = wp.select(time, dt, step) is wp.on[0]
        on_j = wj.select(time, dt, step) is wj.on[0]
        assert on_p == on_j == (time + 0.5 * dt >= 2.49 * dt), step


def test_per_ring_banks(tmp_path):
    """Two files on two rings: distinct bank rows with distinct CDFs, equal
    to the reference's; the off variant of a window without file flux is
    the window itself."""
    p1, p2 = str(tmp_path / "bb1.in"), str(tmp_path / "bb2.in")
    diskgen.write_spectrum_file(p1, gamma_bulk=5.0)
    diskgen.write_spectrum_file(p2, gamma_bulk=20.0)
    cj, cp = _configs((p1, p2))
    sj = JSim(cj, jcfg.ZoneInit.uniform(cj.grid)).src_static
    sp = PSim(cp, pcfg.ZoneInit.uniform(cp.grid), device="cpu").src_static
    _assert_source_equal(sp, sj)
    r1, r2 = int(sp.spec_lower[0]), int(sp.spec_lower[1])
    assert {r1, r2} == {1, 2}
    assert float(torch.max(torch.abs(sp.spec_cdf[r1] - sp.spec_cdf[r2]))) \
        > 1e-3
    thermal = dataclasses.replace(cp.windows[0], tbb_lower=(0.5,) * NR)
    wp = PSim(cp.replace(windows=(thermal,)), pcfg.ZoneInit.uniform(cp.grid),
              device="cpu").window_sources
    assert wp.off[0] is wp.on[0]


def _exact_log_e(u, cdf, e):
    """The exact inverse of a CDF ``cdf`` on energies ``e`` with log e
    linear in u inside each bin, in float64."""
    j = np.clip(np.searchsorted(cdf, u, side="left"), 1, len(e) - 1)
    p0, p1 = cdf[j - 1], cdf[j]
    fr = np.clip((u - p0) / np.maximum(p1 - p0, 1e-300), 0.0, 1.0)
    le = np.log(e)
    return le[j - 1] + fr * (le[j] - le[j - 1])


def test_emit_file_branch_with_reference_uniforms(sims):
    """emit on the same census with the reference's uniforms: integer
    fields and the alive mask exact, positions and directions rtol 1e-5;
    every file photon beamed upward with the reference's mu; every other
    photon's energy rtol 1e-5, and every file photon's log energy within
    the reference quantile table's knot spacing of the reference's (both
    invert the same CDF; the table lerps between its knots)."""
    jsim, psim = sims
    sj, sp = jsim.src_static, psim.src_static
    jg, dt = jsim.grid, jsim.state.dt
    bj = jsrc.compute_budget(
        sj, jnp.full((NZ, NR), 1e-3), jnp.zeros((NZ, NR)), jnp.zeros(NR),
        jg.area_lower, jg.area_upper, jg.area_inner, jg.area_outer, dt, dt,
        3000, 10.0, jsim.scales.sigma_sb)
    rng = np.random.default_rng(1)
    d = dict(e=rng.uniform(0.1, 10.0, N), w=rng.gamma(0.5, 1.0, N),
             w0=np.ones(N), r=rng.uniform(0, 1, N), z=rng.uniform(0, 1, N),
             mu=rng.uniform(-1, 1, N), cphi=np.ones(N), sphi=np.zeros(N),
             dcen=rng.uniform(0, 0.1, N))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["jz"] = rng.integers(0, NZ, N).astype(np.int32)
    d["kr"] = rng.integers(0, NR, N).astype(np.int32)
    d["alive"] = rng.uniform(size=N) < 0.2
    eps = np.cumsum(rng.uniform(0, 1, (2, NZ, NR, 32)), axis=-1)
    eps = (eps / eps[..., -1:]).astype(np.float32)
    eloss = np.ones((NZ, NR), np.float32)
    key = jax.random.PRNGKey(7)
    phj, lost_j = jsrc.emit(
        JPhotons(**{k: jnp.asarray(v) for k, v in d.items()}), key, bj, sj,
        jg.r_edges, jg.z_edges, jg.zone_surf, jnp.asarray(eps[0]),
        jnp.asarray(eps[1]), jnp.asarray(0.5 * eloss), jnp.asarray(eloss),
        jsim.tables.e_ph, dt, NZ, NR, c_scaled=jsim.scales.c)
    keys = jax.random.split(key, 12)
    u = [jax.random.uniform(k, (N,), jnp.float32, 1e-7, 1.0) for k in keys]
    k1, k2 = jax.random.split(keys[9])
    draws = psrc.EmitUniforms(
        u=_t(np.stack([np.asarray(x) for x in u])),
        planck_u4=_t(jax.random.uniform(k1, (N, 4), jnp.float32, 1e-12,
                                        1.0)),
        planck_rn=_t(jax.random.uniform(k2, (N,), jnp.float32)))
    bp = psrc.SourceBudget(**{k: _t(getattr(bj, k)) for k in bj._fields})
    g = psim.grid
    php, lost_p = psrc.emit(
        PPhotons(**{k: _t(v) for k, v in d.items()}), draws, bp, sp,
        g.r_edges, g.z_edges, g.zone_surf, _t(eps[0]), _t(eps[1]),
        _t(0.5 * eloss), _t(eloss), psim.tables.e_ph,
        torch.as_tensor(np.float32(dt)), NZ, NR, c_scaled=psim.scales.c)
    new = np.asarray(phj.alive) & ~d["alive"]
    file = new & (np.asarray(phj.z) == 0.0) & (np.asarray(phj.jz) == 0)
    assert file.sum() > 1000 and (new & ~file).sum() > 100
    for name in ("jz", "kr", "alive"):
        np.testing.assert_array_equal(_np(getattr(php, name)),
                                      _np(getattr(phj, name)), err_msg=name)
    for name in ("w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen"):
        np.testing.assert_allclose(_np(getattr(php, name)),
                                   _np(getattr(phj, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # beam_mu, clipped to 0.99999999, which float32 holds as 1
    np.testing.assert_array_equal(_np(php.mu)[file],
                                  np.float32(0.99999999))
    e_p, e_j = _np(php.e), _np(phj.e)
    np.testing.assert_allclose(e_p[~file], e_j[~file], rtol=1e-5)
    inv = np.asarray(sj.spec_inv, np.float64)[1]
    m = inv.shape[0]
    j = np.clip((np.asarray(u[10])[file] * (m - 1)).astype(np.int64), 0,
                m - 2)
    spacing = inv[j + 1] - inv[j]
    gap = np.abs(np.log(e_p[file]) - np.log(e_j[file]))
    assert np.all(gap <= spacing + 1e-5), (gap - spacing).max()
    # against the exact inverse in float64: float32 rounding only
    cdf = np.asarray(sj.spec_cdf, np.float64)[1]
    e_grid = np.asarray(sj.spec_e, np.float64)[1]
    exact = _exact_log_e(np.asarray(u[10], np.float64)[file], cdf, e_grid)
    np.testing.assert_allclose(np.log(e_p[file]), exact, rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(lost_p), float(lost_j), rtol=1e-5)


def test_quantile_table_smear_is_bounded(sims):
    """The flux that the reference's quantile table moves against the exact
    CDF: the largest probability displacement over 2^20 uniforms is at
    most one knot, 1/4095 = 2.442e-4 (its top knot lerps across the CDF's
    plateau at 1 up to the grid's last energy), while the port's sampler
    follows the CDF to float32 rounding."""
    jsim, psim = sims
    sj, sp = jsim.src_static, psim.src_static
    inv = np.asarray(sj.spec_inv, np.float64)[1]
    m = inv.shape[0]
    u = (np.arange(1 << 20) + 0.5) / (1 << 20)
    x = u * (m - 1)
    j = np.clip(x.astype(np.int64), 0, m - 2)
    le_bank = inv[j] + (x - j) * (inv[j + 1] - inv[j])
    cdf = np.asarray(sj.spec_cdf, np.float64)[1]
    le = np.log(np.asarray(sj.spec_e, np.float64)[1])
    last = int(np.argmax(cdf >= 1.0))        # the plateau's first knot
    p_bank = np.interp(le_bank, le[:last + 1], cdf[:last + 1])
    shift_bank = np.max(np.abs(p_bank - u))
    e_port = psrc.sample_file_spectrum(
        torch.as_tensor(u, dtype=torch.float32),
        torch.ones(u.shape[0], dtype=torch.int64), sp.spec_e, sp.spec_cdf)
    p_port = np.interp(np.log(e_port.numpy().astype(np.float64)),
                       le[:last + 1], cdf[:last + 1])
    shift_port = np.max(np.abs(p_port - u))
    print(f"largest CDF displacement: quantile table {shift_bank:.4e}, "
          f"exact sampler {shift_port:.4e}")
    assert shift_bank <= 1.0 / (m - 1) + 1e-9
    assert shift_port < 1e-5
    # the table's top knot reaches the grid's last energy
    assert np.exp(inv[-1]) == pytest.approx(float(sp.spec_e[1, -1]))


def test_energy_scale_counts_the_file_flux(bank_file):
    """A file ring counts with its file's flux (the reference takes the
    sentinel tbb = -1 as a 1 keV blackbody, 1e12 times the flux here);
    configurations without file rings keep the reference's scale."""
    cj, cp = _configs((bank_file,) * NR)
    cp = cp.replace(run=dataclasses.replace(cp.run, energy_scale=None))
    zp = pcfg.ZoneInit.uniform(cp.grid, n_e=1.0, B_field=1e-6)
    flux = pleg.external_spectrum(bank_file,
                                  cp.source.external)[3]
    g = cp.grid
    dt0 = cp.run.mcdt * min(g.r_max / g.nr, g.z_max / g.nz) / 2.99792458e10
    file_in = flux * np.pi * g.r_max ** 2 * dt0
    assert p_scale(cp, zp) == pytest.approx(file_in / 1e6, rel=1e-3)
    for ctor, kw in (("small_corona", dict(nz=3, nr=2)),
                     ("blazar_jet", dict(nz=3, nr=2))):
        js = getattr(jex, ctor)(nst=500, n_slots=2048, **kw)
        ps = getattr(pex, ctor)(nst=500, n_slots=2048, **kw, device="cpu")
        assert p_scale(ps.cfg, ps.zone_init) == j_scale(js.cfg,
                                                        js.zone_init), ctor


def test_subnormal_emission_total_normalizes():
    """Emission CDF rows: a subnormal total (a thin zone's synchrotron
    emission at coarse widths) still ends at exactly 1 and keeps its
    shape; a zero row is the step at bin 0."""
    w = torch.tensor([[1.0, 3.0, 0.0, 4.0]]) * 1e-42
    p = torch.cumsum(torch.cat([w, torch.tensor([[1.0, 1.0, 1.0, 1.0]]),
                                torch.zeros(1, 4)]), dim=1)
    eps = normalized_cdf(p)
    assert torch.equal(eps[:, -1], torch.ones(3))
    np.testing.assert_allclose(eps[0].numpy(), [0.125, 0.5, 0.5, 1.0],
                               rtol=0.05)
    np.testing.assert_array_equal(eps[1].numpy(), [0.25, 0.5, 0.75, 1.0])
    np.testing.assert_array_equal(eps[2].numpy(), [1.0] * 4)
