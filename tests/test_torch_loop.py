"""The port's lock-step flight loop (``tracking.loop_iteration``, the
rejection sampler ``scatter.scatter``, the tracker selection) against the
JAX package's XLA loop (``tracking._flight_phase``).

- The rejection sampler fed the reference's own uniforms (its per-try key
  chain replayed by ``jax_scatter_draws.rejection_draws``): on the lanes
  that accept a candidate, 99.9% of the energies and weights and 99.5% of
  the directions to 1e-5 (ROADMAP §C), the electron bin exact.
- The reference's exhaustion fault at 1e-10 keV (its sampler returns
  about 0.51 keV at 5e9 times the weight) and the port's kernel rule.
- One loop iteration fed the reference iteration's uniforms, with
  pair_switch 0 and 1 and cr_sent 0 and 3, the reference's sampler given
  the kernel's exhaustion rule: integers exact, floats rtol 1e-5 (the
  scattered lanes by the sampler rule), tallies to 1e-5 of their scale,
  prdep to 1e-5 of c x edep (a signed sum that cancels).
- Whole steps of the port's loop against the reference's XLA loop with
  the kernel's exhaustion rule patched in, on the tiny bounded-tail
  corona (tests/compare_pairs.py's TINY) and under stratified splitting:
  z < 4 on the mean Te and the audit channels.
- The tracker selection, and a 2-rank gloo run of the loop on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu import examples as jex
from compton2d_tpu import tables as jtables
from compton2d_tpu.physics import electron_dist as jed
from compton2d_tpu.state import EventBuffer as JEvents
from compton2d_tpu.state import PhotonArray as JPhotons
from compton2d_tpu.state import Tallies as JTallies
from compton2d_tpu.transport import scatter as jsc
from compton2d_tpu.transport import tracking as jtr
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import convert, driver
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.state import EventBuffer as PEvents
from compton2d_tpu_torch.state import PhotonArray as PPhotons
from compton2d_tpu_torch.state import Tallies as PTallies
from compton2d_tpu_torch.transport import scatter as psc
from compton2d_tpu_torch.transport import flight
from compton2d_tpu_torch.transport import tracking as ptr

from jax_scatter_draws import (
    apply_scatter_draw,
    assert_mostly_close,
    assert_new_direction,
    kernel_exhaustion_rule,
    rejection_draws,
    to_draws,
)

torch.set_num_threads(2)
MAX_TRIES = 64
C_LIGHT = float(np.float32(2.9979245620e10))


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cdf_table(n_zones, num_nt, seed):
    """Hybrid thermal + power-law electron CDFs, one row a zone, one row
    non-monotone in its last bits (as a parallel cumsum can leave it)."""
    rng = np.random.default_rng(seed)
    gnt = jed.gnt_grid(num_nt).astype(np.float32)
    rows = []
    for _ in range(n_zones):
        tea = 10.0 ** rng.uniform(0.5, 2.7)
        pdf = (np.exp(-gnt / (tea / 511.0)) * gnt * gnt
               + 10.0 ** rng.uniform(-5, -2)
               * np.where(gnt > 20.0, gnt ** -2.4, 0.0))
        c = np.cumsum(pdf)
        rows.append(c / c[-1])
    cdf = np.asarray(rows, np.float32)
    k = num_nt // 2
    cdf[0, k:k + 4] = cdf[0, k] + np.float32(1e-7) * np.array([0, -1, 1, -2])
    return gnt, cdf


# ---- the rejection sampler ----------------------------------------------
def _lanes(n, seed, e_range=(-3.0, 3.0)):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, n)
    f = np.float32
    return dict(e=(10.0 ** rng.uniform(*e_range, n)).astype(f),
                mu=rng.uniform(-1, 1, n).astype(f),
                cphi=np.cos(phi).astype(f), sphi=np.sin(phi).astype(f))


def _accepted(d, rows, gnt, draws):
    """The lanes with a candidate the port's sampler accepts."""
    znu = _t(d["e"]) / psc.EMASS_KEV
    _, _, _, zn, _ = psc._candidates(znu, _t(rows), _t(gnt), draws)
    ok = (zn >= 1e-10) & (draws.u_acc <= psc._kn_ratio_f32(zn))
    return torch.any(ok, dim=0).numpy()


def test_rejection_sampler_matches_reference_with_its_uniforms():
    """On the lanes that accept a candidate before max_tries: the electron
    bin exact, e and wscale as in assert_mostly_close (99.9% to 1e-5),
    the direction as in assert_new_direction (99.5% to 1e-5)."""
    n = 4096
    gnt, cdf = _cdf_table(5, 80, seed=0)
    rng = np.random.default_rng(1)
    rows = cdf[rng.integers(0, 5, n)]
    d = _lanes(n, seed=2)
    need = rng.uniform(size=n) < 0.9
    key = jax.random.PRNGKey(3)
    draws = to_draws(rejection_draws(key, n, MAX_TRIES))
    rp = psc.scatter(*(_t(d[k]) for k in ("e", "mu", "cphi", "sphi")),
                     _t(rows), _t(gnt), draws, _t(need))
    rj = jsc.scatter(key, *(jnp.asarray(d[k])
                            for k in ("e", "mu", "cphi", "sphi")),
                     jnp.asarray(rows), jnp.asarray(gnt),
                     max_tries=MAX_TRIES, need=jnp.asarray(need))
    mask = need & _accepted(d, rows, gnt, draws)
    assert mask.sum() > 0.85 * n
    np.testing.assert_array_equal(rp.i_gam.numpy()[mask],
                                  np.asarray(rj.i_gam)[mask])
    for name in ("e", "wscale"):
        assert_mostly_close(getattr(rp, name).numpy()[mask],
                            np.asarray(getattr(rj, name))[mask], 1e-5, name)
    assert_new_direction(rp, rj, d["mu"], d["cphi"], d["sphi"], mask)


def test_exhaustion_fault_of_reference_and_kernel_rule_of_port():
    """8 photons of 1e-10 keV on 40 bins of gamma - 1 from 1e-2 to 20: no
    candidate reaches zn >= 1e-10, so the reference's sampler keeps its
    loop's initial electron (gamma 1, znue 1e-3) and returns 0.510-0.511
    keV photons with wscale about 5.1e9. The port takes the last
    candidate with znue = max(zn, 1e-10), as the flight kernel does: the
    reference's sampler with that rule patched in, fed the same uniforms,
    gives the port's output (rtol 1e-5), six decades below 0.51 keV."""
    n = 8
    gnt = np.geomspace(1e-2, 20.0, 40).astype(np.float32)
    cdf = (np.arange(1, 41) / 40.0).astype(np.float32)
    rows = np.broadcast_to(cdf, (n, 40)).copy()
    d = _lanes(n, seed=4, e_range=(-10.0, -10.0))
    key = jax.random.PRNGKey(5)
    args = [jnp.asarray(d[k]) for k in ("e", "mu", "cphi", "sphi")]
    rj = jsc.scatter(key, *args, jnp.asarray(rows), jnp.asarray(gnt),
                     max_tries=MAX_TRIES)
    e_j, ws_j = np.asarray(rj.e), np.asarray(rj.wscale)
    assert np.all((e_j > 0.509) & (e_j < 0.512)), e_j
    assert np.all((ws_j > 5.0e9) & (ws_j < 5.2e9)), ws_j

    draws = to_draws(rejection_draws(key, n, MAX_TRIES))
    assert not _accepted(d, rows, gnt, draws).any()
    rp = psc.scatter(*(_t(d[k]) for k in ("e", "mu", "cphi", "sphi")),
                     _t(rows), _t(gnt), draws, torch.ones(n, dtype=bool))
    with kernel_exhaustion_rule():
        rk = jsc.scatter(key, *args, jnp.asarray(rows), jnp.asarray(gnt),
                         max_tries=MAX_TRIES)
    np.testing.assert_array_equal(rp.i_gam.numpy(), np.asarray(rk.i_gam))
    for name in ("e", "wscale", "mu"):
        np.testing.assert_allclose(getattr(rp, name).numpy(),
                                   np.asarray(getattr(rk, name)), rtol=1e-5,
                                   err_msg=name)
    assert np.all(rp.e.numpy() < 1e-6 * e_j)


# ---- one iteration ------------------------------------------------------
NZ, NR, N, N_VOL, NUM_NT, N_GG = 3, 2, 4096, 64, 50, 32
GRID = dict(nz=NZ, nr=NR, num_nt=NUM_NT, n_vol=N_VOL, nphfield=64,
            n_gg=N_GG, n_ref=100, nmu=4,
            spectral_regions=((1e-4, 1e-1, 20), (1e-1, 1e4, 40)),
            lc_bands=((2.0, 10.0), (10.0, 50.0)))


@pytest.fixture(scope="module")
def contexts():
    """The reference's and the port's TrackContext on one 3x2 grid with
    zone opacities made by numpy: sigma 0.5-6, kappa from 300 at the
    lowest energies (weight-floor kills) down to 1e-3, the gamma-gamma
    opacity above the e_gg grid's start, hybrid electron CDFs."""
    rng = np.random.default_rng(7)
    tj = jtables.build_tables(jcfg.GridConfig(**GRID), 1.0)
    nzr = NZ * NR
    x = np.linspace(0.0, 1.0, N_VOL)
    sig = rng.uniform(0.5, 6.0, (nzr, 1)) * (1.0 + 0.5 * np.sin(6 * x))
    kap = rng.uniform(0.5, 2.0, (nzr, 1)) * 300.0 * 10.0 ** (-5.5 * x)
    opac = np.stack([sig, kap], axis=-1).astype(np.float32)
    kgg = rng.uniform(0.0, 3.0, (nzr, N_GG)).astype(np.float32)
    gnt, cdf = _cdf_table(nzr, NUM_NT, seed=8)
    tbbl = np.array([True, False])   # ring 0 samples, ring 1 mirrors
    jctx = jtr.TrackContext(
        r_edges=jnp.linspace(0.0, 1.0, NR + 1),
        z_edges=jnp.linspace(0.0, 1.5, NZ + 1),
        opac_zone=jnp.asarray(opac), kgg_zone=jnp.asarray(kgg),
        cdf_nt=jnp.asarray(cdf), gnt=jnp.asarray(gnt),
        e_ph_log0=tj.e_ph_log0, e_ph_dlog=tj.e_ph_dlog,
        e_gg_log0=tj.e_gg_log0, e_gg_dlog=tj.e_gg_dlog,
        e_field_log0=jnp.log(tj.e_field[0]),
        e_field_dlog=jnp.log(tj.e_field[1] / tj.e_field[0]),
        hu=tj.hu, mu_edges=tj.mu_edges, lc_lo=tj.lc_lo, lc_hi=tj.lc_hi,
        e_ref=tj.e_ref, p_ref_t=tj.p_ref.T, w_abs_t=tj.w_abs.T,
        tbbl_pos=jnp.asarray(tbbl), inv_nsigt=jnp.ones(nzr),
        time=jnp.float32(1.5e4), dt=jnp.float32(3.3e3),
        inv_c=jnp.float32(1e15 / 2.998e10),
    )
    e_ref, p_ref_t, w_abs_t = convert.track_reflection(
        convert.flatten(jctx), device="cpu")
    pctx = ptr.TrackContext(
        r_edges=_t(jctx.r_edges), z_edges=_t(jctx.z_edges),
        opac_zone=_t(opac), cdf_nt=_t(cdf), gnt=_t(gnt),
        e_ph_log0=float(jctx.e_ph_log0), e_ph_dlog=float(jctx.e_ph_dlog),
        e_gg_log0=_t(jctx.e_gg_log0), e_gg_dlog=_t(jctx.e_gg_dlog),
        e_field_log0=_t(jctx.e_field_log0),
        e_field_dlog=_t(jctx.e_field_dlog), hu=_t(tj.hu),
        mu_edges=_t(tj.mu_edges), lc_lo=_t(tj.lc_lo), lc_hi=_t(tj.lc_hi),
        tbbl_pos=_t(tbbl), time=_t(jctx.time), dt=_t(jctx.dt),
        inv_c=float(jctx.inv_c), kgg_zone=_t(kgg), e_ref=e_ref,
        p_ref_t=p_ref_t, w_abs_t=w_abs_t,
        guide_u=torch.as_tensor(flight.guide_u_edges()),
        e_gg_host=(float(jctx.e_gg_log0), float(jctx.e_gg_dlog)),
        strat_frac=ptr.strat_fractions(1),
    )
    return jctx, pctx


def _photons(seed):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, N)
    d = dict(
        e=10.0 ** rng.uniform(-3.0, 3.0, N), w=rng.gamma(0.5, 1.0, N),
        r=rng.uniform(0, 1, N), z=rng.uniform(0, 1.5, N),
        mu=rng.uniform(-1, 1, N), cphi=np.cos(phi), sphi=np.sin(phi),
        dcen=rng.uniform(0, 0.6, N),
    )
    d["e"][64:320] = 10.0 ** rng.uniform(-9.0, -7.0, 256)  # opaque: kills
    d["w0"] = d["w"] * 10.0 ** rng.uniform(0, 2, N)
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["r"][:32] = 0.0                       # on the axis
    d["z"][32:64] = 1e-4                    # at the lower boundary
    d["mu"][32:64] = -np.abs(d["mu"][32:64])
    d["jz"] = np.clip((d["z"] / 0.5).astype(np.int32), 0, NZ - 1)
    d["kr"] = np.clip((d["r"] / 0.5).astype(np.int32), 0, NR - 1)
    d["alive"] = rng.uniform(size=N) < 0.9
    return d


def _close_floats(php, phj, scattered):
    """Floats rtol 1e-5 off the scattered lanes; on them energies and
    weights by assert_mostly_close (the directions: _close_directions)."""
    for name in ("e", "w", "w0", "r", "z", "dcen", "mu", "cphi", "sphi"):
        a, b = _np(getattr(php, name)), _np(getattr(phj, name))
        np.testing.assert_allclose(a[~scattered], b[~scattered], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        if name in ("e", "w"):
            assert_mostly_close(a[scattered], b[scattered], 1e-5, name)


def _direction(ph):
    mu = _np(ph.mu).astype(np.float64)
    s = np.sqrt(np.maximum(1.0 - mu * mu, 0.0))
    return np.stack([s * _np(ph.cphi), s * _np(ph.sphi), mu], axis=-1)


def _close_directions(php, phj, scattered, radio):
    """The new directions of the scattered lanes as unit 3-vectors: 99%
    within 1e-5, all within 1e-3. The sampler alone holds 99.5% of its
    components (test_rejection_sampler_matches_reference_with_its_
    uniforms); here its inputs are the move's outputs, whose azimuths
    already differ in their last bits, and the rotation amplifies those
    near the poles of the new direction (|mu'| near 1) and at small
    deflections (0.47-0.92% of the lanes above 1e-5, at most 2.46e-4, on
    these inputs). The ``radio`` lanes (below 1e-6 keV, where no
    candidate is accepted and the kernel's rule deflects them by about
    2e-4) are held to 1e-3 only: their deflection's azimuth rests on the
    last bits."""
    dev = np.linalg.norm(_direction(php) - _direction(phj), axis=-1)
    keep = scattered & ~radio
    assert np.mean(dev[keep] <= 1e-5) >= 0.99, np.sort(dev[keep])[-20:]
    assert np.all(dev <= 1e-3), dev.max()


def _close_tallies(tlp, tlj, e_scale):
    edep_j = _np(tlj.edep)
    np.testing.assert_allclose(_np(tlp.edep), edep_j, rtol=1e-5,
                               atol=1e-5 * np.abs(edep_j).max())
    err = np.abs(_np(tlp.prdep) - _np(tlj.prdep))
    assert np.all(err <= 1e-5 * (C_LIGHT * np.abs(edep_j)
                                 + np.abs(_np(tlj.prdep))))
    for name in ("e_killed", "e_scatter", "e_pair_abs"):
        np.testing.assert_allclose(float(getattr(tlp, name)),
                                   float(getattr(tlj, name)), rtol=1e-5,
                                   atol=1e-5 * e_scale, err_msg=name)
    np.testing.assert_array_equal(_np(tlp.n_esp), _np(tlj.n_esp))
    for name in ("e_ic", "erlk_inner", "erlk_outer", "erlk_upper",
                 "erlk_lower", "ed_in", "ed_ref", "fout", "edout"):
        ref = _np(getattr(tlj, name))
        np.testing.assert_allclose(_np(getattr(tlp, name)), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("pair_switch,cr_sent", [(0, 0), (1, 0), (0, 3),
                                                 (1, 3)])
def test_one_iteration_matches_reference(contexts, pair_switch, cr_sent):
    """One iteration (the reference's ``_flight_phase`` with max_iters 1)
    from the same photons with the reference iteration's uniforms
    (fold_in(key, 0) split five ways): alive, zones and the event count
    exact; photon floats, tallies and event records as in the module
    docstring."""
    jctx, pctx = contexts
    d = _photons(10 + pair_switch + cr_sent)
    key = jax.random.PRNGKey(20 + 2 * pair_switch + cr_sent)
    st_j = jtr.TrackStatics(nz=NZ, nr=NR, cr_sent=cr_sent,
                            pair_switch=pair_switch,
                            max_scatter_tries=MAX_TRIES)
    st_p = ptr.TrackStatics(nz=NZ, nr=NR, cr_sent=cr_sent,
                            pair_switch=bool(pair_switch),
                            max_scatter_tries=MAX_TRIES, tracker="loop")
    args = (NZ, NR, NUM_NT, 64, N_GG, 4, 60, 2)
    jph = JPhotons(**{k: jnp.asarray(v) for k, v in d.items()})
    with kernel_exhaustion_rule():
        phj, tlj, evj, it = jtr._flight_phase(
            jph, JTallies.zeros(*args), JEvents.empty(8192), key, jctx,
            st_j, 1, jnp.int32(0))
    assert int(it) == 1

    kit = jax.random.fold_in(key, 0)
    k_tau, k_absp, k_scat, k1, k2 = jax.random.split(kit, 5)
    f = jax.random.fold_in
    leak = ptr.LeakDraws(*(_t(jax.random.uniform(k, (N,), jnp.float32))
                           for k in (k1, k2, f(k1, 1), f(k2, 1), f(k1, 2))))
    draws = ptr.LoopDraws(
        u_tau=_t(jax.random.uniform(k_tau, (N,), jnp.float32, 1e-12, 1.0)),
        u_abs=_t(jax.random.uniform(k_absp, (N,), jnp.float32, 1e-7, 1.0)),
        leak=lambda: leak,
        scatter=apply_scatter_draw(k_scat, N, MAX_TRIES, rejection=True))
    pph = PPhotons(**{k: _t(v) for k, v in d.items()})
    php, tlp, evp = ptr.loop_iteration(pph, PTallies.zeros(*args),
                                       PEvents.empty(8192), pctx, st_p,
                                       draws)

    for name in ("alive", "jz", "kr"):
        np.testing.assert_array_equal(_np(getattr(php, name)),
                                      _np(getattr(phj, name)), err_msg=name)
    # lanes whose energy changed: scattered, or reflected off the disk
    scattered = _np(php.e) != d["e"]
    moved = _np(php.alive) & (_np(php.jz) != d["jz"])
    assert np.sum(_np(tlp.n_esp)) > 100 and moved.sum() > 100
    _close_floats(php, phj, scattered)
    _close_directions(php, phj, scattered, d["e"] < 1e-6)
    _close_tallies(tlp, tlj, float(np.sum(d["w"])))
    assert float(tlp.e_killed) > 0.0
    assert (float(tlp.e_pair_abs) > 0.0) == bool(pair_switch)
    assert int(evp.count[0]) == int(evj.count[0]) > 50
    # the record time time + dt - inv_c dcen cancels: its error is a few
    # float32 ulp of time + dt
    t_end = float(jctx.time) + float(jctx.dt)
    np.testing.assert_allclose(_np(evp.data)[:, 0], _np(evj.data)[:, 0],
                               rtol=1e-5, atol=4.0 * np.spacing(
                                   np.float32(t_end)))
    np.testing.assert_allclose(_np(evp.data)[:, 1:], _np(evj.data)[:, 1:],
                               rtol=1e-5, atol=1e-6)


# ---- whole steps against the reference's XLA loop -----------------------
# tests/compare_pairs.py's TINY: the bounded-tail corona where the
# reference's exhaustion fault cools the upper row from step 2 on
TINY = dict(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40, n_vol=32,
            nphfield=32, t_const=False, amxwl=0.5, gmin=3.0, gmax=20.0)
STEPS, SEEDS = 3, (0, 1, 2, 3)
STRAT = dict(strat_split=True, strat_gamma_c=10.0, strat_p_max=0.5)


def _loop_config(cfg, source):
    return dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, pallas_tracking="off"),
        source=dataclasses.replace(cfg.source, **source))


def _channels(sim):
    a = sim.energy_audit()
    return [float(np.mean(_np(sim.state.zones.tea))), a["escaped"],
            a["census"], a["absorbed"], a["scatter_gain"]]


def _z_against_reference(source):
    """Mean Te and the audit's escaped, census, absorbed and scatter_gain
    after STEPS steps of the port's loop and of the reference's XLA loop
    with the kernel's exhaustion rule, over SEEDS a side; every port
    step's audit within 2e-3. Returns (z, port means, reference means)."""
    ref, port = [], []
    with kernel_exhaustion_rule():
        jsim = jex.small_corona(**TINY, seed=0)
        jsim = jsim.with_config(_loop_config(jsim.cfg, source))
        init = jsim.state
        for s in SEEDS:
            jsim.state = init._replace(key=jax.random.PRNGKey(s))
            jsim.run(STEPS)
            ref.append(_channels(jsim))
    for s in SEEDS:
        psim = pex.small_corona(**TINY, seed=s, device="cpu")
        psim = psim.with_config(_loop_config(psim.cfg, source))
        assert psim.tracker == "loop"
        for _ in range(STEPS):
            psim.step()
            assert abs(psim.energy_audit()["balance"] - 1.0) < 2e-3
        port.append(_channels(psim))
    ref, port = np.array(ref), np.array(port)
    k = len(SEEDS)
    se = np.sqrt(ref.var(0, ddof=1) / k + port.var(0, ddof=1) / k)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    return np.abs(port.mean(0) - ref.mean(0)) / se, port.mean(0), \
        ref.mean(0)


def test_loop_steps_match_reference_loop_statistically():
    """pallas_tracking "off" on both sides: z < 4 on every channel (the
    standard error with a 0.1% floor for float32 rounding); the mean Te
    after 3 steps near 225 keV, where the unrepaired reference's loop
    gives 67.5-68.2 keV (tests/compare_pairs.py te)."""
    z, port, ref = _z_against_reference({})
    assert np.all(z < 4.0), (z, port, ref)
    assert port[0] > 150.0, port


def test_strat_loop_steps_match_reference_loop_statistically():
    """The same under stratified splitting (gamma_c 10, p_max 0.5, inside
    the corona's gamma 3-20 tail): the loop's collisions go through the
    stratified branch of apply_scatter on both sides."""
    z, port, ref = _z_against_reference(STRAT)
    assert np.all(z < 4.0), (z, port, ref)


# ---- the tracker selection ----------------------------------------------
def _cfg(nz=3, nr=2, n_slots=4096, mode="auto"):
    cfg, _ = pex.corona_config(nz=nz, nr=nr, nst=300, n_slots=n_slots,
                               num_nt=40, n_vol=32, nphfield=32)
    return dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, pallas_tracking=mode))


@pytest.mark.parametrize("mode,nz,nr,n_slots,world,want", [
    ("auto", 8, 4, 131072, 1, "kernel"),
    ("auto", 127, 127, 524288, 1, "kernel"),
    ("auto", 128, 4, 131072, 1, "loop"),
    ("auto", 4, 128, 131072, 1, "loop"),
    ("auto", 8, 4, 130000, 1, "loop"),
    ("auto", 8, 4, 4096, 2, "kernel"),
    ("auto", 8, 4, 3072, 2, "loop"),
    ("on", 128, 128, 130000, 1, "kernel"),
    ("off", 8, 4, 131072, 1, "loop"),
])
def test_select_tracker(mode, nz, nr, n_slots, world, want):
    """The JAX driver's rule with the card in the TPU's place: the rule
    reads the grid, the slots a rank and pallas_tracking, not the device,
    so "auto" picks the kernel (its plain version) on the CPU too, where
    the JAX package takes its loop."""
    assert driver.select_tracker(_cfg(nz, nr, n_slots, mode), world) == want


def test_tracker_selection_in_the_simulation():
    """Simulation.tracker and summary() name the tracker; "on" refuses a
    128-zone edge (NotImplementedError) and slots off the tile
    (ValueError); the loop takes both; slots that do not split over the
    ranks are refused on either tracker; an unknown mode is refused."""
    sim = driver.Simulation(_cfg(), device="cpu")
    assert sim.tracker == "kernel"
    sim.step()
    assert sim.summary().endswith("tracker=kernel")
    with pytest.raises(NotImplementedError):
        driver.Simulation(_cfg(nz=128, mode="on"), device="cpu")
    with pytest.raises(ValueError):
        driver.Simulation(_cfg(n_slots=4000, mode="on"), device="cpu")
    for cfg in (_cfg(nz=128), _cfg(n_slots=4000), _cfg(mode="off")):
        assert driver.Simulation(cfg, device="cpu").tracker == "loop"
    driver.check_slice(_cfg(n_slots=4002), 2, "loop")
    with pytest.raises(ValueError):
        driver.check_slice(_cfg(n_slots=4001), 2, "loop")
    with pytest.raises(ValueError):
        driver.select_tracker(_cfg(mode="maybe"))


def test_loop_on_two_gloo_ranks(tmp_path):
    """2 ranks of 1500 slots each (off the 1024 tile: "auto" takes the
    loop) with the FP solve on, 3 steps: every step's audit within 1e-4
    on both ranks, and both ranks hold the same tallies and zones."""
    import test_torch_ranks
    from compton2d_tpu_torch.parallel.distributed import run_ranks

    res = run_ranks(test_torch_ranks.loop_steps, 2, (3000, 3),
                    backend="gloo", device="cpu", timeout_s=240.0,
                    init_timeout_s=60.0, threads=1,
                    rendezvous_dir=str(tmp_path))
    for r in res:
        assert r["tracker"] == "loop" and r["slots"] == 1500
        assert all(abs(b - 1.0) < 1e-4 for b in r["balance"]), r["balance"]
        for step, t in enumerate(r["tallies"]):
            assert not test_torch_ranks.differing(t, res[0]["tallies"][step])
        assert not test_torch_ranks.differing(r["zones"], res[0]["zones"])
    assert res[0]["tallies"][-1]["trk_rounds"] > 0


def test_tracker_gate_on_the_cpu():
    """``e2e_gate.tracker_gate`` (the tracker_main cell's comparison) at a
    small grid: 3x2 zones, 4096 slots, nst 3000, 6 seeds of 2 steps a
    side. The kernel's plain version passes run_gate's test against the
    loop; each side ran the tracker it names; the statistic is the one
    ``choose_statistic`` keeps from the loop side's floors."""
    from compton2d_tpu_torch import e2e_gate

    res = e2e_gate.tracker_gate(
        "cpu", dict(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50,
                    n_vol=64, nphfield=64, t_const=False,
                    max_flight_iters=256, seed=0), k=6, steps=2)
    assert res["gate"]["passed"], res["gate"]
    assert res["trackers"] == {"kernel": "kernel", "loop": "loop"}
    assert res["statistic"] == (e2e_gate.TRACKER_STATISTIC, 2)
    assert res["gate"]["n_seeds"] == 6 and res["gate"]["steps"] == 2
