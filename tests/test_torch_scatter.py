"""The port's weighted scatter sampler (``transport/scatter.py``) against
the JAX reference's ``compton2d_tpu.transport.scatter``: the deterministic
pieces exactly or to 1e-6, the sampler stages with the reference's own
uniforms fed in (allclose 1e-5: torch's and XLA's cos/log/sqrt may differ
in the last bit), and the sampler as a whole statistically, by the three
checks of tests/test_stratified.py at their tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from compton2d_tpu.physics import electron_dist as jed
from compton2d_tpu.transport import scatter as jsc
from compton2d_tpu_torch.physics import compton as pcompton
from compton2d_tpu_torch.physics import electron_dist as ped
from compton2d_tpu_torch.tables import e_field_grid
from compton2d_tpu_torch.transport import scatter as psc

from jax_scatter_draws import (
    assert_mostly_close,
    assert_new_direction,
    strat_draws,
    sz_uniforms,
    to_draws,
)

torch.set_num_threads(2)
MAX_TRIES = 64


def _t(x):
    return torch.as_tensor(np.array(x))


def _cdf_rows(n, num_nt=80, seed=0):
    """Hybrid thermal + power-law CDFs of a few zones, one row per lane;
    one row is made non-monotone in its last bits, as a parallel cumsum
    can leave it."""
    rng = np.random.default_rng(seed)
    gnt = ped.gnt_grid(num_nt).astype(np.float32)
    rows = []
    for tea in (5.0, 50.0, 300.0):
        g = gnt
        pdf = (np.exp(-g / (tea / 511.0)) * g * g
               + 1e-3 * np.where(g > 50.0, g ** -2.4, 0.0))
        c = np.cumsum(pdf)
        rows.append(c / c[-1])
    cdf = np.asarray(rows, np.float32)
    cdf[1, 40:44] = cdf[1, 40] + np.float32(1e-7) * np.array([0, -1, 1, -2])
    zone = rng.integers(0, 3, n)
    return gnt, cdf, zone


def test_kn_ratio_matches_reference():
    """rtol 1e-6 wherever torch's and XLA's f32 log(1 + 2z) agree; where
    they differ by their last bit (z just above the 0.15 series cut, where
    the closed form's numerator cancels), within what that one bit makes
    of 0.375 gamz log(1 + 2z) / z^3."""
    z = np.concatenate([np.geomspace(1e-12, 1e4, 4000),
                        [0.1499999, 0.15, 0.1500001]]).astype(np.float32)
    got = psc._kn_ratio_f32(_t(z)).numpy()
    ref = np.asarray(jsc._kn_ratio_f32(jnp.asarray(z)))
    betz = (1.0 + 2.0 * np.maximum(z, 1e-6)).astype(np.float32)
    log_t = torch.log(_t(betz)).numpy()
    log_j = np.asarray(jnp.log(jnp.asarray(betz)))
    same_log = (log_t == log_j) | (z <= 0.15)
    np.testing.assert_allclose(got[same_log], ref[same_log], rtol=1e-6,
                               atol=0)
    zs = z[~same_log].astype(np.float64)
    one_bit = 0.375 * np.abs(zs * (zs - 2.0) - 2.0) * np.abs(
        log_t - log_j)[~same_log] / zs ** 3
    # with the f32 roundings of the closed form around it, at most twice
    # that (1.28 times measured)
    assert np.all(np.abs(got - ref)[~same_log]
                  <= 2.0 * one_bit + 1e-6 * np.abs(ref[~same_log]))


def test_draw_from_cdf_matches_reference():
    """The compare-count bin is exact, also on the non-monotone row and at
    u equal to CDF values; gamma and beta to 1e-6."""
    n = 6000
    gnt, cdf, zone = _cdf_rows(n)
    rng = np.random.default_rng(1)
    u = rng.uniform(0, 1, n).astype(np.float32)
    u[:200] = cdf[zone[:200], rng.integers(0, 80, 200)]   # ties
    u[200:400] = 1.0 - np.geomspace(1e-7, 1e-2, 200)       # deep tail
    rows = cdf[zone]
    gp, bp, ip = psc._draw_from_cdf(_t(u), _t(rows), _t(gnt))
    gj, bj, ij = jsc._draw_from_cdf(jnp.asarray(u), jnp.asarray(rows),
                                    jnp.asarray(gnt))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=1e-6)
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-7)


def test_sample_sz_and_finish_with_reference_uniforms():
    """_sample_sz with the reference's per-round candidates (allclose
    1e-5; lanes that need no scatter keep sz = 1 on both sides) and
    _finish_scatter with its angle uniforms (allclose 1e-5 as in
    assert_mostly_close and assert_new_direction)."""
    n = 4096
    rng = np.random.default_rng(2)
    znue = (10.0 ** rng.uniform(-4, 2, n)).astype(np.float32)
    need = rng.uniform(size=n) < 0.9
    key = jax.random.PRNGKey(3)
    u1, u2 = sz_uniforms(key, n, MAX_TRIES)
    sz_p = psc._sample_sz(_t(znue), _t(u1), _t(u2), _t(need))
    sz_j = jsc._sample_sz(key, jnp.asarray(znue), MAX_TRIES,
                          jnp.asarray(need))
    np.testing.assert_allclose(sz_p.numpy(), np.asarray(sz_j), rtol=1e-5)
    assert np.all(sz_p.numpy()[~need] == 1.0)

    # a physical electron-photon pair: znue from (E, gamma, angle)
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    ua = [np.asarray(jax.random.uniform(k, (n,), jnp.float32)) for k in ks]
    e = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    znu = e / np.float32(511.0)
    gamma = (1.0 + 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    beta = np.sqrt(np.maximum(1.0 - 1.0 / gamma ** 2, 0.0)).astype(
        np.float32)
    omeg = rng.uniform(-0.999, 0.999, n).astype(np.float32)
    znue = np.maximum((1.0 - beta * omeg) * znu * gamma, 1e-10).astype(
        np.float32)
    sz = np.asarray(jsc._sample_sz(jax.random.PRNGKey(5),
                                   jnp.asarray(znue), MAX_TRIES,
                                   jnp.ones(n, bool)))
    phi = rng.uniform(0, 2 * np.pi, n)
    mu = rng.uniform(-1, 1, n).astype(np.float32)
    cphi, sphi = np.cos(phi).astype(np.float32), np.sin(phi).astype(
        np.float32)
    i_gam = rng.integers(1, 80, n).astype(np.int32)
    args = (znu, mu, cphi, sphi, gamma, beta, omeg, znue, sz, i_gam)
    rp = psc._finish_scatter(*map(_t, args), *map(_t, ua))
    rj = jsc._finish_scatter(tuple(ks), *map(jnp.asarray, args))
    for name in ("e", "wscale"):
        assert_mostly_close(getattr(rp, name).numpy(),
                             np.asarray(getattr(rj, name)), 1e-5, name)
    np.testing.assert_array_equal(rp.i_gam.numpy(), i_gam)
    assert_new_direction(rp, rj, mu, cphi, sphi, np.ones(n, bool))


def test_scatter_stratified_with_reference_uniforms():
    """The whole weighted sampler on strata [u_lo, u_hi) with the
    reference's uniforms: the electron bin exact, the new energy allclose
    1e-5 (as in assert_mostly_close), the direction as in
    assert_new_direction, and wscale to 2e-5: it carries the KN ratio,
    whose last-bit log difference the closed form's cancellation
    amplifies to 8e-6 (see test_kn_ratio_matches_reference)."""
    n = 4096
    gnt, cdf, zone = _cdf_rows(n, seed=5)
    rng = np.random.default_rng(6)
    rows = cdf[zone]
    e = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    mu = rng.uniform(-1, 1, n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n)
    cphi, sphi = np.cos(phi).astype(np.float32), np.sin(phi).astype(
        np.float32)
    u_lo = np.where(rng.uniform(size=n) < 0.5, 0.0,
                    rng.uniform(0.9, 0.999, n)).astype(np.float32)
    u_hi = np.where(u_lo > 0, 1.0, rng.uniform(0.5, 1.0, n)).astype(
        np.float32)
    inv_z = rng.uniform(0.5, 2.0, n).astype(np.float32)
    need = rng.uniform(size=n) < 0.8
    key = jax.random.PRNGKey(7)
    d = strat_draws(key, n, MAX_TRIES)
    arrays = (e, mu, cphi, sphi, rows, gnt, u_lo, u_hi, inv_z)
    rp = psc.scatter_stratified(*map(_t, arrays), to_draws(d), _t(need))
    rj = jsc.scatter_stratified(key, *map(jnp.asarray, arrays[:6]),
                                u_lo=jnp.asarray(u_lo),
                                u_hi=jnp.asarray(u_hi),
                                inv_z=jnp.asarray(inv_z),
                                max_tries=MAX_TRIES, need=jnp.asarray(need))
    np.testing.assert_array_equal(rp.i_gam.numpy()[need],
                                  np.asarray(rj.i_gam)[need])
    assert_mostly_close(rp.e.numpy()[need], np.asarray(rj.e)[need], 1e-5,
                         "e")
    assert_mostly_close(rp.wscale.numpy()[need],
                         np.asarray(rj.wscale)[need], 2e-5, "wscale")
    assert_new_direction(rp, rj, mu, cphi, sphi, need)


# ---- statistical checks (tests/test_stratified.py's three) -------------
def _hybrid(num_nt=80, tea=50.0, amxwl=0.9, gmin=1e2, gmax=1e4, p_nth=2.4):
    """The reference's hybrid electron distribution and CDF (one zone)."""
    gnt = jnp.asarray(jed.gnt_grid(num_nt))
    shape = lambda v: jnp.full((1, 1), v, jnp.float32)  # noqa: E731
    f_nt = jed.init_f_nt(gnt, shape(tea), shape(amxwl), shape(gmin),
                         shape(gmax), shape(p_nth))
    cdf = jed.build_cdf(f_nt, gnt)
    return np.asarray(gnt), np.asarray(f_nt), np.asarray(cdf).reshape(-1)


def _port_weighted(n, e_kev, mu, gnt, cdf, u_lo, u_hi, seed,
                   chunk=50_000):
    """n weighted scatters of one photon state, in chunks of lanes (the
    sz candidates are (max_tries, lanes))."""
    gen = torch.Generator().manual_seed(seed)
    parts = []
    for k in range(0, n, chunk):
        m = min(chunk, n - k)
        ones = torch.ones(m)
        parts.append(psc.scatter_stratified(
            torch.full((m,), e_kev), torch.full((m,), mu), ones,
            torch.zeros(m), _t(cdf).expand(m, -1), _t(gnt), u_lo * ones,
            u_hi * ones, ones,
            psc.draw_scatter_uniforms(gen, m, MAX_TRIES, "cpu"),
            torch.ones(m, dtype=torch.bool)))
    return psc.ScatterResult(*(torch.cat(f) for f in zip(*parts)))


def test_weighted_sampler_matches_rejection_sampler():
    """Self-normalized weighted estimator E[xknot e'/e] / E[xknot] of the
    port equals the reference's rejection sampler's mean weight scale
    within 2e-2 (n = 200000 a side, as in tests/test_stratified.py)."""
    n = 200_000
    gnt, _, cdf = _hybrid()
    e, mu = 10.0, 0.3
    res = _port_weighted(n, e, mu, gnt, cdf, 0.0, 1.0, seed=0)
    xknot = res.wscale * e / torch.clamp_min(res.e, 1e-30)
    m_w = float(torch.sum(res.wscale.double()) / torch.sum(xknot.double()))
    rows = jnp.broadcast_to(jnp.asarray(cdf)[None, :], (n, cdf.shape[0]))
    rej = jsc.scatter(jax.random.PRNGKey(0), jnp.full((n,), e, jnp.float32),
                      jnp.full((n,), mu, jnp.float32), jnp.ones(n),
                      jnp.zeros(n), rows, jnp.asarray(gnt))
    m_rej = float(jnp.mean(rej.wscale))
    assert np.isclose(m_w, m_rej, rtol=2e-2), (m_w, m_rej)


def test_normalizer_matches_sigma_table():
    """The empirical <xknot> under the (f, flux) measure equals
    sigma_zone(E) / (n_e sigma_T F_tot), the driver's inv_nsigt
    normalizer, within 3e-2 (n = 400000)."""
    n = 400_000
    gnt, f_nt, cdf = _hybrid()
    res = _port_weighted(n, 10.0, 0.3, gnt, cdf, 0.0, 1.0, seed=1)
    xknot = res.wscale * 10.0 / torch.clamp_min(res.e, 1e-30)
    z_emp = float(torch.mean(xknot.double()))
    e_grid = e_field_grid(64)
    sig_tab = _t(pcompton.sigma_e_table(e_grid, gnt).astype(np.float32))
    sig = pcompton.zone_sigma_table(sig_tab, _t(f_nt), _t(gnt),
                                    torch.ones((1, 1)))[0, 0].numpy()
    i = int(np.searchsorted(e_grid, 10.0)) - 1
    f = (np.log(10.0) - np.log(e_grid[i])) / (
        np.log(e_grid[i + 1]) - np.log(e_grid[i]))
    sig_e = float(sig[i]) * (1 - f) + float(sig[i + 1]) * f
    ftot = float(np.sum(f_nt[0, 0, :-1] * np.diff(gnt)))
    z_tab = sig_e / (pcompton.SIGMA_T * ftot)
    assert np.isclose(z_emp, z_tab, rtol=3e-2), (z_emp, z_tab)


def test_stratified_combination_unbiased():
    """(1-p) E_A[wscale] + p E_B[wscale] == E_full[wscale] within 0.15,
    and the tail stratum amplifies far more (n = 400000 per stratum)."""
    n = 400_000
    gnt, _, cdf = _hybrid(gmin=50.0, gmax=300.0)
    icut = int(np.searchsorted(ped.gnt_grid(80), 150.0 - 1.0))
    c = float(cdf[icut])
    p = 1.0 - c
    assert 1e-4 < p < 0.5

    def mean_wscale(u_lo, u_hi, seed):
        res = _port_weighted(n, 10.0, -0.2, gnt, cdf, u_lo, u_hi, seed)
        return float(torch.mean(res.wscale.double()))

    m_full = mean_wscale(0.0, 1.0, 7)
    m_a = mean_wscale(0.0, c, 8)
    m_b = mean_wscale(c, 1.0, 9)
    m_comb = (1.0 - p) * m_a + p * m_b
    assert np.isclose(m_comb, m_full, rtol=0.15), (m_comb, m_full)
    assert m_b > 10.0 * m_a
