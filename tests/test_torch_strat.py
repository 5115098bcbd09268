"""Stratified tail splitting in the port: ``tracking.apply_scatter``'s
strat branch against the JAX reference's on the same photons with the
reference's sampler uniforms fed in, the two end-to-end checks of
tests/test_stratified.py run on the port, and a port-vs-reference z-test
of a small Mrk 421 run with splitting on."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu.state import PhotonArray as JPhotons
from compton2d_tpu.state import Tallies as JTallies
from compton2d_tpu.transport import tracking as jtr
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.driver import Simulation
from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.state import PhotonArray as PPhotons
from compton2d_tpu_torch.state import Tallies as PTallies
from compton2d_tpu_torch.transport import tracking as ptr

from jax_scatter_draws import (
    apply_scatter_draw,
    assert_mostly_close,
    assert_new_direction,
)

torch.set_num_threads(2)

NZ, NR, N, NUM_NT, N_VOL, M = 3, 2, 2048, 80, 48, 4


def _t(x):
    return torch.as_tensor(np.array(x))


def _zone_tables(seed=0):
    """Six zones: thermal cores with power-law tails above gamma ~ 150 of
    weight 1e-4 .. 0.1 (four zones in the stratified range), one without a
    tail, and one whose tail weighs more than strat_p_max."""
    rng = np.random.default_rng(seed)
    gnt = gnt_grid(NUM_NT).astype(np.float32)
    icut = int(np.searchsorted(gnt, 150.0 - 1.0))
    rows = []
    for frac in (1e-4, 3e-3, 0.1, 0.0, 0.8, 0.02):
        th = np.exp(-gnt / 0.1) * gnt * gnt
        th /= th.sum()
        tail = np.where(gnt >= gnt[icut], gnt ** -2.4, 0.0)
        tail = tail / tail.sum() if frac else tail
        pdf = (1.0 - frac) * th + frac * tail
        c = np.cumsum(pdf)
        rows.append(c / c[-1])
    cdf = np.asarray(rows, np.float32)
    sig = rng.uniform(0.5, 3.0, (NZ * NR, 1)) * np.ones((1, N_VOL))
    opac = np.stack([sig, 0.1 * sig], axis=-1).astype(np.float32)
    inv_nsigt = rng.uniform(0.2, 2.0, NZ * NR).astype(np.float32)
    return gnt, icut, cdf, opac, inv_nsigt


def _photons(seed=1):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, N)
    d = dict(
        e=10.0 ** rng.uniform(-2.0, 2.0, N), w=rng.gamma(0.5, 1.0, N),
        w0=np.ones(N), r=rng.uniform(0, 1, N), z=rng.uniform(0, 1, N),
        mu=rng.uniform(-1, 1, N), cphi=np.cos(phi), sphi=np.sin(phi),
        dcen=rng.uniform(0, 0.1, N),
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["jz"] = rng.integers(0, NZ, N).astype(np.int32)
    d["kr"] = rng.integers(0, NR, N).astype(np.int32)
    # ~100 free slots: room for about 25 of the ~60 stratified scatters,
    # so the all-or-nothing placement cuts off in slot order
    d["alive"] = rng.uniform(size=N) < 0.95
    sct = d["alive"] & (rng.uniform(size=N) < 0.1)
    return d, sct


def test_apply_scatter_strat_matches_reference():
    """Same photons, zone tables and sampler uniforms: the placement
    (which slots take copies, alive, and the copies' position, clock and
    zone) is exact; energies, weights (w0 included), directions and the
    tallies edep / e_ic / e_scatter allclose 1e-5 (sampler outputs as in
    assert_mostly_close and assert_new_direction), n_esp exact."""
    gnt, icut, cdf, opac, inv_nsigt = _zone_tables()
    d, sct = _photons()
    log0, dlog = float(np.log(np.float32(1e-3))), float(np.float32(0.25))
    zid = (d["jz"] * NR + d["kr"]).astype(np.int32)
    k_scat = jax.random.PRNGKey(11)

    z0 = jnp.zeros(1)
    jctx = jtr.TrackContext(
        r_edges=z0, z_edges=z0, opac_zone=jnp.asarray(opac),
        kgg_zone=z0, cdf_nt=jnp.asarray(cdf), gnt=jnp.asarray(gnt),
        e_ph_log0=jnp.float32(log0), e_ph_dlog=jnp.float32(dlog),
        e_gg_log0=z0, e_gg_dlog=z0, e_field_log0=z0, e_field_dlog=z0,
        hu=z0, mu_edges=z0, lc_lo=z0, lc_hi=z0, e_ref=z0, p_ref_t=z0,
        w_abs_t=z0, tbbl_pos=z0, inv_nsigt=jnp.asarray(inv_nsigt),
        time=jnp.float32(0.0), dt=jnp.float32(1.0), inv_c=jnp.float32(1.0),
    )
    st_j = jtr.TrackStatics(nz=NZ, nr=NR, strat_split=True, strat_icut=icut,
                            strat_copies=M)
    jph = JPhotons(**{k: jnp.asarray(v) for k, v in d.items()})
    sig_s = jnp.maximum(jtr._loggrid_interp(
        jctx.opac_zone, jnp.asarray(zid), jph.e, jctx.e_ph_log0,
        jctx.e_ph_dlog)[:, 0], 1e-30)
    args = (NZ, NR, NUM_NT, 8, 4, 4, 10, 2)
    phj, tlj = jtr.apply_scatter(jph, JTallies.zeros(*args),
                                 jnp.asarray(sct), jnp.asarray(zid), sig_s,
                                 k_scat, jctx, st_j)

    e0 = torch.zeros(1)
    pctx = ptr.TrackContext(
        r_edges=e0, z_edges=e0, opac_zone=_t(opac), cdf_nt=_t(cdf),
        gnt=_t(gnt), e_ph_log0=log0, e_ph_dlog=dlog, e_gg_log0=e0,
        e_gg_dlog=e0, e_field_log0=e0, e_field_dlog=e0, hu=e0, mu_edges=e0,
        lc_lo=e0, lc_hi=e0, tbbl_pos=e0, time=e0, dt=e0, inv_c=1.0,
        inv_nsigt=_t(inv_nsigt), guide_u=e0, e_gg_host=(0.0, 1.0),
        strat_frac=ptr.strat_fractions(M),
    )
    st_p = ptr.TrackStatics(nz=NZ, nr=NR, strat_split=True, strat_icut=icut,
                            strat_copies=M)
    pph = PPhotons(**{k: _t(v) for k, v in d.items()})
    php, tlp = ptr.apply_scatter(
        pph, PTallies.zeros(*args), _t(sct), _t(zid),
        apply_scatter_draw(k_scat, N, st_p.max_scatter_tries), pctx, st_p)

    # the sigma lookup both sides use
    np.testing.assert_allclose(
        ptr.loggrid_interp(pctx.opac_zone, _t(zid), pph.e, log0,
                           dlog)[:, 0].numpy(),
        np.asarray(jtr._loggrid_interp(jctx.opac_zone, jnp.asarray(zid),
                                       jph.e, jctx.e_ph_log0,
                                       jctx.e_ph_dlog)[:, 0]), rtol=1e-6)

    alive_p, alive_j = php.alive.numpy(), np.asarray(phj.alive)
    np.testing.assert_array_equal(alive_p, alive_j)
    copies = alive_j & ~d["alive"]
    n_free = int((~d["alive"]).sum())
    assert 0 < copies.sum() <= n_free and copies.sum() % M == 0
    assert copies.sum() + M > n_free     # the slots ran out: a cut-off
    for name in ("r", "z", "dcen", "jz", "kr"):
        np.testing.assert_array_equal(getattr(php, name).numpy(),
                                      np.asarray(getattr(phj, name)),
                                      err_msg=name)
    moved = sct | copies
    for name in ("e", "w", "w0"):
        a, b = getattr(php, name).numpy(), np.asarray(getattr(phj, name))
        np.testing.assert_array_equal(a[~moved], b[~moved], err_msg=name)
        assert_mostly_close(a[moved], b[moved], 1e-5, name)
    assert_new_direction(php, phj, d["mu"], d["cphi"], d["sphi"], sct)
    np.testing.assert_array_equal(tlp.n_esp.numpy(), np.asarray(tlj.n_esp))
    for name in ("edep", "e_ic", "e_scatter"):
        ref = np.asarray(getattr(tlj, name))
        np.testing.assert_allclose(getattr(tlp, name).numpy(), ref,
                                   rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


# ---- the end-to-end checks of tests/test_stratified.py, on the port ----
def _corona(strat: bool, copies: int, seed: int = 0):
    """The 2x2 optically thick corona of tests/test_stratified.py (tau ~ 6,
    a 0.1% power-law tail at 50 keV), at its sizes."""
    nz, nr = 2, 2
    grid = pcfg.GridConfig(
        nz=nz, nr=nr, z_max=1e15, r_max=1e15,
        num_nt=120, n_vol=48, nphfield=48, n_gg=16, n_ref=50, nmu=4,
        spectral_regions=((1e-4, 1e-1, 10), (1e-1, 1e7, 30)),
        lc_bands=((2.0, 10.0),),
    )
    win = pcfg.TimeWindow(
        t0=0.0, t1=1e30, tbb_lower=(0.5,) * nr, tbb_upper=(0.0,) * nr,
        tbb_inner=(0.0,) * nz, tbb_outer=(0.0,) * nz,
    )
    cfg = pcfg.SimConfig(
        grid=grid, physics=pcfg.PhysicsConfig(t_const=True),
        source=pcfg.SourceConfig(nst=1000, strat_split=strat,
                                 strat_gamma_c=1e3, strat_copies=copies),
        run=pcfg.RunConfig(seed=seed, n_slots=16384, event_capacity=16384,
                           max_flight_iters=256),
        windows=(win,),
    )
    zi = pcfg.ZoneInit.uniform(
        grid, tea=50.0, tna=50.0, n_e=1e9, B_field=1.0, amxwl=0.999,
        gmin=1e2, gmax=1e4, p_nth=2.4,
    )
    return Simulation(cfg, zi, device="cpu")


def _run_tail(sim, steps=3):
    """Tail photons (> 10 MeV) in census and in the event records, the
    escaped energy and the last census energy; every step's audit within
    5e-3."""
    n_tail, e_esc = 0, 0.0
    for _ in range(steps):
        out = sim.step()
        a = sim.energy_audit()
        assert np.isclose(a["balance"], 1.0, atol=5e-3), a
        ph = sim.state.photons
        n_tail += int(torch.sum(ph.alive & (ph.e > 1e4)))
        nev = int(min(int(out.events.count[0]), out.events.data.shape[0]))
        n_tail += int(torch.sum(out.events.data[:nev, 1] > 1e4))
        e_esc += a["escaped"]
    return n_tail, e_esc, a["census"]


def test_end_to_end_tail_coverage():
    """Stratified splitting at least doubles the deep-KN tail samples at
    fixed nst, with the audit exact."""
    tail_off, _, _ = _run_tail(_corona(False, 1))
    tail_on, _, _ = _run_tail(_corona(True, 1))
    assert tail_on > 2 * max(tail_off, 1), (tail_on, tail_off)


def test_strat_copies_unbiased_and_multiplies_tail():
    """strat_copies = 4 against 1 on the same seed: the tail samples more
    than double while escaped and census energy agree within 0.15 (the
    parents' random numbers do not depend on the number of copies, so the
    comparison is paired, as in the reference's test)."""
    tail1, esc1, cen1 = _run_tail(_corona(True, 1))
    tail4, esc4, cen4 = _run_tail(_corona(True, 4))
    assert tail4 > 2 * max(tail1, 1), (tail4, tail1)
    assert np.isclose(esc4, esc1, rtol=0.15), (esc4, esc1)
    assert np.isclose(cen4, cen1, rtol=0.15), (cen4, cen1)


# ---- port vs reference on a small Mrk 421 run --------------------------
MRK = dict(nz=4, nr=2, nst=1500, n_slots=8192, num_nt=160, n_vol=64,
           nphfield=64)
SEEDS = (0, 1, 2)


def _strat(cfg):
    return dataclasses.replace(cfg, source=dataclasses.replace(
        cfg.source, strat_split=True, strat_copies=4))


def test_mrk421_strat_matches_reference_statistically():
    """Escaped and census energy after 3 steps with splitting on agree with
    the reference within z < 4 over 3 seeds a side (standard error with a
    0.1% floor for float32 rounding)."""
    steps = 3
    jsim = jex.mrk421(**MRK)
    jsim = jsim.with_config(_strat(jsim.cfg))
    init = jsim.state
    ref, port = [], []
    for s in SEEDS:
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        jsim.run(steps)
        a = jsim.energy_audit()
        ref.append([a["escaped"], a["census"]])
        psim = pex.mrk421(**MRK, seed=s, device="cpu")
        psim = psim.with_config(_strat(psim.cfg))
        psim.run(steps)
        a = psim.energy_audit()
        assert abs(a["balance"] - 1.0) < 5e-3, a
        port.append([a["escaped"], a["census"]])
    ref, port = np.array(ref), np.array(port)
    k = len(SEEDS)
    se = np.sqrt(ref.var(0, ddof=1) / k + port.var(0, ddof=1) / k)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    z = np.abs(port.mean(0) - ref.mean(0)) / se
    assert np.all(z < 4.0), (z, port.mean(0), ref.mean(0))


def _electrons_and_events(sim, out_dir):
    """The zones' mean Lorentz factor after the last FP step, the number of
    event records and their median log10 energy (by count: a few records
    of the dense blob carry most of the energy, so energy-weighted sums
    spread over orders of magnitude between seeds)."""
    z = sim.state.zones
    f_nt = np.asarray(z.f_nt)
    gamma = np.asarray(sim.tables.gnt) + 1.0
    ev = np.loadtxt(f"{out_dir}/evb.dat").reshape(-1, 7)
    return [float(np.mean((f_nt * gamma).sum(-1) / f_nt.sum(-1))),
            float(len(ev)), float(np.median(np.log10(ev[:, 1])))]


def test_mrk421_dense_strat_matches_reference_statistically(tmp_path,
                                                            monkeypatch):
    """At the dense run's electron density (n_e = 2e6), where collisions
    freeze and tail copies are placed: the zone electron spectrum (its
    mean Lorentz factor, after shock injection, turbulence and the FP
    solve), the number of escaping records and their median energy agree
    with the reference within z < 4 over 3 seeds a side (standard error
    with a 1e-3 floor), with every run's audit within 5e-3."""
    steps = 3
    kw = dict(MRK, n_e=2e6)
    counts = {"frozen": 0, "copies": 0}
    apply_scatter = ptr.apply_scatter

    def counted(ph, tl, sct, *rest):
        ph2, tl2 = apply_scatter(ph, tl, sct, *rest)
        counts["frozen"] += int(sct.sum())
        counts["copies"] += int(ph2.alive.sum()) - int(ph.alive.sum())
        return ph2, tl2

    monkeypatch.setattr(ptr, "apply_scatter", counted)
    jsim = jex.mrk421(**kw)
    jsim = jsim.with_config(_strat(jsim.cfg))
    init = jsim.state
    ref, port = [], []
    for s in SEEDS:
        out = tmp_path / f"jax{s}"
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        jsim.attach_outputs(str(out))
        jsim.run(steps)
        assert abs(jsim.energy_audit()["balance"] - 1.0) < 5e-3
        ref.append(_electrons_and_events(jsim, out))
        out = tmp_path / f"port{s}"
        psim = pex.mrk421(**kw, seed=s, device="cpu")
        psim = psim.with_config(_strat(psim.cfg))
        psim.attach_outputs(str(out))
        psim.run(steps)
        assert abs(psim.energy_audit()["balance"] - 1.0) < 5e-3
        port.append(_electrons_and_events(psim, out))
    assert counts["frozen"] > 0 and counts["copies"] > 0, counts
    ref, port = np.array(ref), np.array(port)
    k = len(SEEDS)
    se = np.sqrt(ref.var(0, ddof=1) / k + port.var(0, ddof=1) / k)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    z = np.abs(port.mean(0) - ref.mean(0)) / se
    assert np.all(z < 4.0), (z, port.mean(0), ref.mean(0))
