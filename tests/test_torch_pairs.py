"""The port's pair physics against the JAX reference: the host-built
tables (bit for bit), the per-step contractions, the Wien-tail fit of the
census field, the FP solve with pair sources and positrons (on made-up
inputs and on the pair corona's own, against the reference with the
port's two repairs patched in), the driver's section 1b, and a small
pair-producing corona step by step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compton2d_tpu.fp.chang_cooper as jcc
from compton2d_tpu import examples as jex
from compton2d_tpu import tables as jtab
from compton2d_tpu.fp.update import fp_step as j_fp_step
from compton2d_tpu.physics import pairs as jpairs
from compton2d_tpu.physics.electron_dist import gnt_grid as j_gnt_grid
from compton2d_tpu.physics.emissivity import volume_em as j_volume_em
from compton2d_tpu.transport import tracking as jtrk
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import convert, driver
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch import tables as ptab
from compton2d_tpu_torch.fp.update import fp_constants
from compton2d_tpu_torch.fp.update import fp_step as p_fp_step
from compton2d_tpu_torch.physics import pairs as ppairs
from compare_pairs import fp_args, port_cc_limit, reference_fp

torch.set_num_threads(2)

PAIR_CFG = dict(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40, n_vol=32,
                nphfield=32, t_const=False, pair_switch=1, amxwl=0.5,
                gmin=3.0, gmax=20.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fc(psim, tables):
    """The port's FP constants of ``psim``'s configuration on ``tables``."""
    return fp_constants(tables.gnt, float(psim.cfg.grid.z_max),
                        psim.cfg.physics)


def _close_to_max(got, ref, rtol=1e-5):
    """allclose with the absolute part relative to the array's max."""
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("builder", ["kgg", "pairprod", "vsigma"])
def test_host_builders_equal_reference(builder):
    """The float64 numpy builders are copies: equal bit for bit."""
    e_gg = jtab.e_gg_grid(32)
    gnt = j_gnt_grid(60)
    if builder == "kgg":
        got = ppairs.kgg_matrix(e_gg, 1.0e15)
        ref = jpairs.kgg_matrix(e_gg, 1.0e15)
    elif builder == "pairprod":
        got = ppairs.pairprod_tensor(gnt, e_gg)
        ref = jpairs.pairprod_tensor(gnt, e_gg)
    else:
        got = ppairs.vsigma_matrix(gnt)
        ref = jpairs.vsigma_matrix(gnt)
    assert np.any(ref != 0.0)
    np.testing.assert_array_equal(got, ref)


def test_build_pair_tables_bitwise():
    """kgg_mat (scaled by the length unit), pp_tensor and vsigma as the
    reference stores them in float32, bit for bit."""
    grid = pcfg.GridConfig(nz=2, nr=2, num_nt=50, n_gg=32)
    got = ptab.build_pair_tables(grid, 1.0e15)
    ref = jtab.build_pair_tables(grid, 1.0e15)
    for name in got._fields:
        g, r = _np(getattr(got, name)), _np(getattr(ref, name))
        assert g.dtype == np.float32 and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


# ---------------------------------------------------------------------------
# per-step functions
# ---------------------------------------------------------------------------
def _field(rng, Z, e_gg, scale=1e18, noise=0.3, e0=300.0):
    """A census-like field: a power law with a cutoff, lognormal noise."""
    e = np.asarray(e_gg, np.float64)
    a = rng.uniform(0.8, 2.0, (Z, 1))
    f = scale * (e[None, :] / e[2]) ** -a * np.exp(-e[None, :] / e0)
    return (f * rng.lognormal(0.0, noise, f.shape)).astype(np.float32)


def test_dn_pp_pa_rates_and_k_gg_match():
    """dn_pp (two f32 contractions), the annihilation sinks and the
    opacity k_gg = nph @ kgg_mat.T agree with the reference to rtol 1e-5
    of each array's max."""
    rng = np.random.default_rng(0)
    grid = pcfg.GridConfig(nz=2, nr=3, num_nt=50, n_gg=32)
    pt = ptab.build_pair_tables(grid, 1.0e15)
    jt = jtab.build_pair_tables(grid, 1.0e15)
    Z = 6
    e_gg = jtab.e_gg_grid(32).astype(np.float32)
    nph = _field(rng, Z, e_gg, e0=2000.0)
    got = ppairs.dn_pp_from_field(torch.as_tensor(nph), pt.pp_tensor)
    ref = jpairs.dn_pp_from_field(jnp.asarray(nph), jt.pp_tensor)
    assert float(np.max(ref)) > 0.0
    _close_to_max(got, ref)
    _close_to_max(torch.as_tensor(nph) @ pt.kgg_mat.T,
                  jnp.asarray(nph) @ jt.kgg_mat.T)

    gnt = j_gnt_grid(50).astype(np.float32)
    f_nt = rng.uniform(0.0, 1.0, (Z, 50)).astype(np.float32)
    n_pos = (1e8 * rng.uniform(0.0, 1.0, (Z, 50))).astype(np.float32)
    n_e = rng.uniform(1e9, 1e10, Z).astype(np.float32)
    dne, dnp = ppairs.pa_rates(*map(torch.as_tensor, (f_nt, n_pos, n_e)),
                               pt.vsigma, torch.as_tensor(gnt))
    dne_j, dnp_j = jpairs.pa_rates(*map(jnp.asarray, (f_nt, n_pos, n_e)),
                                   jt.vsigma, jnp.asarray(gnt))
    assert float(np.min(dne_j)) < 0.0 and float(np.min(dnp_j)) < 0.0
    _close_to_max(dne, dne_j)
    _close_to_max(dnp, dnp_j)


def _chi2(nph, fit):
    """The fit's chi^2 in float64 over the bins the reference counts."""
    nph, fit = np.asarray(nph, np.float64), np.asarray(fit, np.float64)
    use = (fit > 1.0) & (nph > 1.0)
    return np.sum(np.where(use, (nph - fit) ** 2 / np.maximum(fit, 1e-30),
                           0.0), axis=-1)


def _check_smooth(nph, e_gg, te):
    """The port's fit equals the reference's (rtol 1e-5), or, where
    last-bit differences in the chi^2 sums picked another candidate of a
    near-tie, both fits have chi^2 within 1e-4 of each other."""
    got = _np(ppairs.nph_smooth(*map(torch.as_tensor, (nph, e_gg, te))))
    ref = np.asarray(jpairs.nph_smooth(*map(jnp.asarray, (nph, e_gg, te))))
    same = np.all(np.isclose(got, ref, rtol=1e-5, atol=0.0), axis=-1)
    c_got, c_ref = _chi2(nph, got), _chi2(nph, ref)
    near = np.abs(c_got - c_ref) <= 1e-4 * np.maximum(c_ref, 1e-30)
    assert np.all(same | near), (same, c_got, c_ref)
    return got, ref, same


def test_nph_smooth_fits_synthetic_field_as_reference():
    """The synthetic field of tests/test_pairs.py: 1e4 (E/E3)^-1.5
    exp(-E/300) with 20% lognormal noise, on 60 e_gg bins."""
    e_gg = jtab.e_gg_grid(60).astype(np.float32)
    rng = np.random.default_rng(0)
    e3 = float(e_gg[2])
    truth = 1e4 * (e_gg.astype(np.float64) / e3) ** -1.5 * np.exp(
        -e_gg.astype(np.float64) / 300.0)
    noisy = (truth * rng.lognormal(0, 0.2, truth.shape)).astype(np.float32)
    got, _, same = _check_smooth(noisy[None, :], e_gg,
                                 np.asarray([300.0], np.float32))
    assert same.all()
    sel = truth > 100.0
    np.testing.assert_allclose(got[0][sel], truth[sel], rtol=0.5)


def test_nph_smooth_noisy_census_field_as_reference():
    """Twelve census-like zones with 30% noise, two of them below the
    signal threshold (left raw), and one of exact ties: only bins 2 and 10
    hold more than one photon, so every candidate at or below 1 there has
    chi^2 = 0, and the reference keeps the LAST of them (not the first,
    which torch.argmin alone would give)."""
    e_gg = jtab.e_gg_grid(32).astype(np.float32)
    rng = np.random.default_rng(1)
    nph = _field(rng, 12, e_gg, scale=1e5, e0=400.0)
    nph[3, :] = 0.0                       # no signal: stays raw
    nph[4, 9] = 0.5                       # bin 10 below 1: stays raw
    nph[5, :] = 0.5                       # exact ties at chi^2 = 0
    nph[5, 1] = nph[5, 9] = 2.0
    te = rng.uniform(50.0, 300.0, 12).astype(np.float32)
    got, ref, same = _check_smooth(nph, e_gg, te)
    np.testing.assert_array_equal(got[3], nph[3])
    np.testing.assert_array_equal(got[4], nph[4])
    assert same[5] and _chi2(nph[5], got[5]) == 0.0
    assert same.mean() >= 0.75


# ---------------------------------------------------------------------------
# FP solve with pairs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def carried_pairs():
    """A reference pair corona's initial state carried over to the port,
    with a radiation field, pair sources and a positron population made
    by numpy from a seed. The pair terms are zero in the two end bins,
    where the port drops them (test_pair_terms_skip_the_end_bins)."""
    kw = dict(nz=3, nr=2, nst=2000, n_slots=4096, num_nt=50, n_vol=48,
              nphfield=48, t_const=False, seed=3, pair_switch=1,
              amxwl=0.5, gmin=3.0, gmax=20.0)
    jsim = jex.small_corona(**kw)
    psim = pex.small_corona(**kw, device="cpu")
    psim.step()
    n_field = psim.last_outputs.tallies.n_field.numpy()
    rng = np.random.default_rng(7)
    gnt = np.asarray(jsim.tables.gnt)
    shape = (3, 2, 50)
    dg = np.concatenate([np.diff(gnt), [0.0]])
    inner = np.ones(50, np.float32)
    inner[0] = inner[-1] = 0.0
    n_pos = (1e7 * np.exp(-gnt / 2.0) * rng.uniform(0.5, 1.5, shape)
             * inner).astype(np.float32)
    js = jsim.state._replace(
        zones=jsim.state.zones._replace(
            n_pos=jnp.asarray(n_pos),
            f_pair=jnp.asarray((n_pos * dg).sum(-1) / 1e10, jnp.float32)),
        dn_pp=jnp.asarray((1e2 * np.exp(-gnt / 3.0) * inner
                           * rng.uniform(0.5, 1.5, shape)).astype(np.float32)),
    )
    jg = jsim.grid
    dne, dnp = jpairs.pa_rates(
        js.zones.f_nt.reshape(6, -1), js.zones.n_pos.reshape(6, -1),
        js.zones.n_e.reshape(-1), jsim.pair_tables.vsigma, jsim.tables.gnt)
    js = js._replace(dne_pa=dne.reshape(shape) * inner,
                     dnp_pa=dnp.reshape(shape) * inner)
    state, tables, grid, _, pair_tables = convert.from_reference(
        convert.flatten(js), convert.flatten(jsim.tables), convert.flatten(jg),
        convert.flatten(jsim.src_static), device="cpu",
        pair_tables=convert.flatten(jsim.pair_tables))
    z = js.zones
    l_min = jnp.minimum(jg.dz, jg.dr) * jnp.ones_like(jg.vol)
    ve = j_volume_em(jsim.tables.e_ph, jsim.tables.gnt, z.f_nt, z.tea, z.n_e,
                     z.B_field, z.amxwl, jg.vol, jg.zone_surf, l_min, js.dt,
                     jsim.tables.sync, jsim.scales, f_pair=z.f_pair)
    return (jsim, psim, js, state, tables, grid, pair_tables, n_field,
            np.array(ve.eloss_sy))


def test_convert_carries_pair_tables_exactly(carried_pairs):
    jsim, _, _, _, _, _, pair_tables, _, _ = carried_pairs
    for name in pair_tables._fields:
        np.testing.assert_array_equal(_np(getattr(pair_tables, name)),
                                      np.asarray(getattr(jsim.pair_tables,
                                                         name)))


def test_fp_step_with_pairs_matches_reference(carried_pairs):
    """The pair sources on f and the positrons, the positron solve through
    the same Chang-Cooper operator and the pair fraction: substeps exact,
    f_nt, n_pos, f_pair and tea rtol 1e-5 (of each array's max), as the
    electron-only comparison of tests/test_torch_fp.py."""
    jsim, psim, js, state, tables, grid, _, n_field, eloss_sy = carried_pairs
    phys, scales = jsim.cfg.physics, jsim.scales
    jt, jg = jsim.tables, jsim.grid
    rj = j_fp_step(js.zones, jnp.asarray(n_field), jt, jg.vol,
                   float(jsim.cfg.grid.z_max), jg.dz, js.dt, js.time,
                   jnp.asarray(eloss_sy), phys, scales, dn_pp=js.dn_pp,
                   dne_pa=js.dne_pa, dnp_pa=js.dnp_pa)
    rp = p_fp_step(state.zones, torch.as_tensor(n_field), tables, grid.vol,
                   float(psim.cfg.grid.z_max), grid.dz, state.dt,
                   state.time, torch.as_tensor(eloss_sy), psim.cfg.physics,
                   psim.scales, _fc(psim, tables), dn_pp=state.dn_pp,
                   dne_pa=state.dne_pa, dnp_pa=state.dnp_pa)
    assert int(rp.substeps) == int(rj.substeps) > 1
    assert float(np.max(rj.zones.f_pair)) > 0.0
    for name in ("f_nt", "n_pos", "f_pair", "tea", "n_e"):
        _close_to_max(getattr(rp.zones, name), getattr(rj.zones, name))
    for name in ("e_el_old", "e_el_new", "dT_max"):
        np.testing.assert_allclose(_np(getattr(rp, name)),
                                   _np(getattr(rj, name)), rtol=1e-5)


def test_fp_step_needs_the_pair_terms_under_pair_switch(carried_pairs):
    """Under pair_switch a call without dn_pp, dne_pa or dnp_pa raises
    instead of solving without the pair terms."""
    _, psim, _, state, tables, grid, _, n_field, eloss_sy = carried_pairs
    pair = dict(dn_pp=state.dn_pp, dne_pa=state.dne_pa, dnp_pa=state.dnp_pa)
    for missing in pair:
        with pytest.raises(ValueError, match="pair_switch"):
            p_fp_step(state.zones, torch.as_tensor(n_field), tables,
                      grid.vol, float(psim.cfg.grid.z_max), grid.dz,
                      state.dt, state.time, torch.as_tensor(eloss_sy),
                      psim.cfg.physics, psim.scales, _fc(psim, tables),
                      **{k: v for k, v in pair.items() if k != missing})


def test_pair_terms_skip_the_end_bins(carried_pairs):
    """The end bins are the solve's boundary rows (x = d, zeroed after
    each substep). The reference adds the pair terms there too, and the
    drift coefficient then feeds them into the neighbouring bin without
    bound (under the strong heating of a pair-loaded corona this overflowed
    the positron density in float32 within a step). The port drops them:
    a source spike in both end bins leaves its result bitwise unchanged,
    while it moves the reference's."""
    jsim, psim, js, state, tables, grid, _, n_field, eloss_sy = carried_pairs
    spike = np.zeros((3, 2, 50), np.float32)
    spike[..., 0] = spike[..., -1] = 1e6

    def port(extra):
        return p_fp_step(
            state.zones, torch.as_tensor(n_field), tables, grid.vol,
            float(psim.cfg.grid.z_max), grid.dz, state.dt, state.time,
            torch.as_tensor(eloss_sy), psim.cfg.physics, psim.scales,
            _fc(psim, tables), dn_pp=state.dn_pp + torch.as_tensor(extra),
            dne_pa=state.dne_pa, dnp_pa=state.dnp_pa).zones

    def ref(extra):
        return j_fp_step(
            js.zones, jnp.asarray(n_field), jsim.tables, jsim.grid.vol,
            float(jsim.cfg.grid.z_max), jsim.grid.dz, js.dt, js.time,
            jnp.asarray(eloss_sy), jsim.cfg.physics, jsim.scales,
            dn_pp=js.dn_pp + extra, dne_pa=js.dne_pa,
            dnp_pa=js.dnp_pa).zones

    p0, p1 = port(0.0 * spike), port(spike)
    for name in ("f_nt", "n_pos", "f_pair", "tea"):
        assert torch.equal(getattr(p0, name), getattr(p1, name)), name
    r0, r1 = ref(0.0 * spike), ref(spike)
    assert not np.allclose(np.asarray(r0.n_pos), np.asarray(r1.n_pos),
                           rtol=1e-3)


# ---------------------------------------------------------------------------
# the FP solve on the pair corona's own inputs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def path_fp_inputs():
    """The reference's small pair corona (for its tables) and the
    arguments of the port's fp_step at steps 0-2 of the same corona
    (seed 0). Step 1 has pair sources in the end bins, step 2 has
    positrons and annihilation as well."""
    return jex.small_corona(**PAIR_CFG), fp_args(PAIR_CFG, 3)


@pytest.mark.parametrize("step", [1, 2])
def test_fp_step_on_the_path_matches_repaired_reference(
        step, path_fp_inputs, monkeypatch):
    """The port's fp_step on its own pair corona inputs against the
    reference's fp_step with the port's two repairs patched in by this
    test: the Chang-Cooper weight's limit below w = -500
    (tests/test_torch_fp.py::test_chang_cooper_under_strong_heating), and
    no pair terms in the end bins (zeroed in the reference's inputs).
    Substeps exact; f_nt, n_pos, f_pair, tea and n_e rtol 1e-5 of each
    array's max."""
    jsim, seen = path_fp_inputs
    args, kw = seen[step]
    if step == 1:
        assert float(kw["dn_pp"][..., 0].max()) > 0.0
    else:
        assert float(args[0].f_pair.max()) > 0.0
        assert float(kw["dnp_pa"].min()) < 0.0
    monkeypatch.setattr(jcc, "_w_over_expm1", port_cc_limit)
    rj = reference_fp(jsim, args, kw, end_bins=False)
    rp = p_fp_step(*args, **kw)
    assert int(rp.substeps) == int(rj.substeps)
    assert float(np.max(rj.zones.f_pair)) > 0.0
    for name in ("f_nt", "n_pos", "f_pair", "tea", "n_e"):
        _close_to_max(getattr(rp.zones, name), getattr(rj.zones, name))


def test_reference_end_bin_pair_terms_create_positrons(path_fp_inputs,
                                                       monkeypatch, capsys):
    """What the end-bin repair takes away, on step 1's inputs (the
    Chang-Cooper limit does not act there). The reference keeps the end
    bins' pair source as the boundary value of its solve and zeroes it
    after each substep, so the source flows into the neighbouring bins
    without ever leaving the end bin: the positrons it adds to the other
    bins outnumber those its end-bin source held over the step. The
    measured gain, f_pair and Te with and without the end-bin terms are
    printed."""
    jsim, seen = path_fp_inputs
    args, kw = seen[1]
    monkeypatch.setattr(jcc, "_w_over_expm1", port_cc_limit)
    kept = reference_fp(jsim, args, kw, end_bins=True).zones
    dropped = reference_fp(jsim, args, kw, end_bins=False).zones
    gnt = np.asarray(jsim.tables.gnt, np.float32)
    dg = np.diff(gnt)
    wdg = np.concatenate([dg, [0.0]])
    dn_pp = kw["dn_pp"].numpy().astype(np.float64)
    held = float(args[6]) * (dn_pp[..., 0] * dg[0]
                             + dn_pp[..., -1] * dg[-1])
    added = np.sum((np.asarray(kept.n_pos, np.float64)
                    - np.asarray(dropped.n_pos, np.float64)) * wdg, axis=-1)
    z = int(np.argmax(held))
    gain = added.ravel()[z] / held.ravel()[z]
    with capsys.disabled():
        print(f"\nzone {z}: end-bin source {held.ravel()[z]:.4e}, positrons "
              f"added {added.ravel()[z]:.4e}, gain {gain:.4f}; f_pair "
              f"{float(np.ravel(kept.f_pair)[z]):.4e} with the end-bin "
              f"terms, {float(np.ravel(dropped.f_pair)[z]):.4e} without; Te "
              f"{float(np.ravel(kept.tea)[z]):.4f} and "
              f"{float(np.ravel(dropped.tea)[z]):.4f} keV")
    assert gain > 1.0


# ---------------------------------------------------------------------------
# driver section 1b
# ---------------------------------------------------------------------------
def test_pair_fields_match_reference_on_the_same_census():
    """Section 1b fed the same census photons and zones: the reference's
    computation (driver.py:911-991, assembled here from its functions)
    against ``driver.pair_fields``: nph_raw and k_gg rtol 1e-5 of their
    max; the fit, dn_pp and the annihilation sinks likewise, since the
    census field's fit picks the same candidates here."""
    psim = pex.small_corona(**{**PAIR_CFG, "nst": 3000, "n_slots": 4096},
                            seed=2, device="cpu")
    for _ in range(2):
        psim.step()
    ph, zones = psim.state.photons, psim.state.zones
    pf = driver.pair_fields(ph, zones, psim.tables, psim.pair_tables,
                            psim.grid, psim.scales, 2, 2)

    # the reference's section 1b on the same photons, zones and tables
    jt = jtab.build_tables(psim.cfg.grid, psim.scales.L)
    pt = jtab.build_pair_tables(psim.cfg.grid, psim.scales.L)
    e, w = jnp.asarray(ph.e.numpy()), jnp.asarray(ph.w.numpy())
    alive = jnp.asarray(ph.alive.numpy())
    egg32 = jt.e_gg.astype(jnp.float32)
    gbin, in_gg = jtrk.loggrid_bin(e, jnp.log(jt.e_gg[0]),
                                   jnp.log(jt.e_gg[1] / jt.e_gg[0]), 32)
    cnts = jnp.where(alive & in_gg, w / jnp.maximum(e, 1e-30), 0.0)
    zid = jnp.asarray((ph.jz.clamp(0, 1) * 2 + ph.kr.clamp(0, 1)).numpy())
    nph_scaled = jtrk.hist2d_accum(cnts, zid, 4, gbin, 32)
    de_gg = jnp.concatenate([jnp.diff(egg32), jnp.ones((1,), jnp.float32)])
    nph_phys = (nph_scaled * jnp.float32(psim.scales.nfield_to_dgic)
                / jnp.asarray(psim.grid.vol.numpy()).reshape(-1, 1)
                / de_gg[None, :])
    nph_sm = jpairs.nph_smooth(nph_phys, egg32,
                               jnp.asarray(zones.tea.numpy()).reshape(-1))
    dne, dnp = jpairs.pa_rates(
        jnp.asarray(zones.f_nt.numpy()).reshape(4, -1),
        jnp.asarray(zones.n_pos.numpy()).reshape(4, -1),
        jnp.asarray(zones.n_e.numpy()).reshape(-1), pt.vsigma,
        jt.gnt.astype(jnp.float32))

    assert float(jnp.max(nph_phys)) > 0.0
    _close_to_max(pf.nph_raw.reshape(4, -1), nph_phys)
    _close_to_max(pf.nph_fit.reshape(4, -1), nph_sm)
    _close_to_max(pf.k_gg.reshape(4, -1), nph_sm @ pt.kgg_mat.T)
    _close_to_max(pf.dn_pp.reshape(4, -1),
                  jpairs.dn_pp_from_field(nph_sm, pt.pp_tensor))
    _close_to_max(pf.dne_pa.reshape(4, -1), dne)
    _close_to_max(pf.dnp_pa.reshape(4, -1), dnp)


# ---------------------------------------------------------------------------
# the pair corona step by step
# ---------------------------------------------------------------------------
def _pair_observables(sim):
    a = sim.energy_audit()
    z = sim.state.zones
    return a, {
        "escaped": a["escaped"], "census": a["census"],
        "pair_abs": a["pair_abs"], "te_mean": float(np.mean(_np(z.tea))),
    }


def test_pair_corona_audit_and_pair_fraction():
    """Three steps of the small pair corona: |balance - 1| < 5e-3 (the
    bound of tools/pallas_e2e.py) at every step, gamma-gamma absorption
    tallied, f_pair finite and >= 0."""
    sim = pex.small_corona(**PAIR_CFG, seed=0, device="cpu")
    pair_abs = 0.0
    for _ in range(3):
        sim.step()
        a, _ = _pair_observables(sim)
        assert abs(a["balance"] - 1.0) < 5e-3, a
        pair_abs += a["pair_abs"]
        fp = _np(sim.state.zones.f_pair)
        assert np.all(np.isfinite(fp)) and np.all(fp >= 0.0)
    assert pair_abs > 0.0
    assert float(sim.state.k_gg.max()) > 0.0


def test_pair_corona_matches_reference_statistically(capsys):
    """After 3 steps, the channels that are nonzero at this size (escaped,
    census and gamma-gamma absorbed energy, mean Te) agree with the
    reference's Pallas path (interpret mode, pair_switch on) within z < 4
    over 3 seeds a side; the standard error has a 0.1% floor for float32
    rounding. Each channel's noise floor (the standard error relative to
    the mean) is printed."""
    jsim = jex.small_corona(**PAIR_CFG, seed=0)
    jsim = jsim.with_config(dataclasses.replace(
        jsim.cfg, run=dataclasses.replace(jsim.cfg.run,
                                          pallas_tracking="on")))
    init = jsim.state
    ref, port = [], []
    for s in (0, 1, 2):
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        jsim.run(3)
        ref.append(_pair_observables(jsim)[1])
        psim = pex.small_corona(**PAIR_CFG, seed=s, device="cpu")
        psim.run(3)
        port.append(_pair_observables(psim)[1])
    for q in ref[0]:
        r = np.array([x[q] for x in ref])
        p = np.array([x[q] for x in port])
        se = np.sqrt(r.var(ddof=1) / 3 + p.var(ddof=1) / 3)
        se = max(se, 1e-3 * abs(r.mean()))
        z = abs(p.mean() - r.mean()) / se
        with capsys.disabled():
            print(f"\n{q}: port {p.mean():.4e} reference {r.mean():.4e} "
                  f"noise floor {se / abs(r.mean()):.4f} z {z:.2f}")
        assert r.mean() != 0.0, q
        assert z < 4.0, (q, z, p, r)
