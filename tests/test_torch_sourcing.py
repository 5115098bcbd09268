"""Sourcing and census roulette of the port against the JAX reference.
The samplers get the reference's own uniforms: each test recreates them
from the same key with ``jax.random`` exactly as the reference draws
them, and feeds them through the port's draw arguments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu.state import PhotonArray as JPhotons
from compton2d_tpu.transport import sourcing as jsrc
from compton2d_tpu.transport.population import census_roulette as j_rr
from compton2d_tpu_torch import convert
from compton2d_tpu_torch.state import PhotonArray as PPhotons
from compton2d_tpu_torch.transport import sourcing as psrc
from compton2d_tpu_torch.transport.population import census_roulette as p_rr

torch.set_num_threads(2)

N = 4096


@pytest.fixture(scope="module")
def setup():
    jsim = jex.small_corona(nz=3, nr=2, nst=3000, n_slots=N, num_nt=50,
                            n_vol=64, nphfield=64, seed=1)
    _, tables, grid, src, _ = convert.from_reference(
        convert.flatten(jsim.state), convert.flatten(jsim.tables),
        convert.flatten(jsim.grid), convert.flatten(jsim.src_static),
        device="cpu")
    return jsim, tables, grid, src


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _photons(seed, frac_alive):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, N)
    d = dict(
        e=rng.uniform(0.1, 10.0, N), w=rng.gamma(0.5, 1.0, N),
        w0=np.ones(N), r=rng.uniform(0, 1, N), z=rng.uniform(0, 1, N),
        mu=rng.uniform(-1, 1, N), cphi=np.cos(phi), sphi=np.sin(phi),
        dcen=rng.uniform(0, 0.1, N),
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["jz"] = rng.integers(0, 3, N).astype(np.int32)
    d["kr"] = rng.integers(0, 2, N).astype(np.int32)
    d["alive"] = rng.uniform(size=N) < frac_alive
    return (JPhotons(**{k: jnp.asarray(v) for k, v in d.items()}),
            PPhotons(**{k: _t(v) for k, v in d.items()}))


def _budget_inputs(seed=0):
    rng = np.random.default_rng(seed)
    fas = rng.uniform(0.1, 2.0, (3, 2)).astype(np.float32)
    ecens = rng.uniform(0.0, 1.0, (3, 2)).astype(np.float32)
    return fas, ecens


def _budgets(jsim, grid, src, nst=3000):
    fas, ecens = _budget_inputs()
    jg, sc = jsim.grid, jsim.scales
    dt = jsim.state.dt
    bj = jsrc.compute_budget(
        jsim.src_static, jnp.asarray(fas), jnp.asarray(ecens),
        jnp.zeros(2), jg.area_lower, jg.area_upper, jg.area_inner,
        jg.area_outer, jnp.asarray(dt), jnp.asarray(dt), nst, 10.0,
        sc.sigma_sb)
    bp = psrc.compute_budget(
        src, _t(fas), _t(ecens), torch.zeros(2), grid.area_lower,
        grid.area_upper, grid.area_inner, grid.area_outer,
        torch.as_tensor(np.float32(dt)), torch.as_tensor(np.float32(dt)),
        nst, 10.0, sc.sigma_sb)
    return bj, bp


def test_compute_budget_matches(setup):
    jsim, _, grid, src = setup
    bj, bp = _budgets(jsim, grid, src)
    for name in bj._fields:
        a, b = _np(getattr(bp, name)), _np(getattr(bj, name))
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
    assert int(bj.n_new) > 0


def test_emit_matches_with_reference_uniforms(setup):
    """Integer fields and the alive mask exact; floats rtol 1e-5 (atol
    1e-6 for direction cosines near zero)."""
    jsim, tables, grid, src = setup
    bj, _ = _budgets(jsim, grid, src)
    jph, pph = _photons(2, 0.6)
    rng = np.random.default_rng(3)
    eps = np.cumsum(rng.uniform(0, 1, (2, 3, 2, 64)), axis=-1)
    eps = (eps / eps[..., -1:]).astype(np.float32)
    eloss_tot = rng.uniform(1.0, 2.0, (3, 2)).astype(np.float32)
    eloss_th = (eloss_tot * rng.uniform(0, 1, (3, 2))).astype(np.float32)
    jg, dt = jsim.grid, jsim.state.dt
    key = jax.random.PRNGKey(5)
    phj, lost_j = jsrc.emit(
        jph, key, bj, jsim.src_static, jg.r_edges, jg.z_edges,
        jg.zone_surf, jnp.asarray(eps[0]), jnp.asarray(eps[1]),
        jnp.asarray(eloss_th), jnp.asarray(eloss_tot), jsim.tables.e_ph,
        jnp.asarray(dt), 3, 2, c_scaled=jsim.scales.c)
    # the reference's draws (sourcing.emit and planck.sample_planck)
    keys = jax.random.split(key, 12)
    u = [jax.random.uniform(k, (N,), jnp.float32, 1e-7, 1.0) for k in keys]
    k1, k2 = jax.random.split(keys[9])
    u4 = jax.random.uniform(k1, (N, 4), jnp.float32, 1e-12, 1.0)
    rn = jax.random.uniform(k2, (N,), jnp.float32)
    draws = psrc.EmitUniforms(u=_t(np.stack([np.asarray(x) for x in u])),
                              planck_u4=_t(u4), planck_rn=_t(rn))
    bp = psrc.SourceBudget(**{k: _t(getattr(bj, k)) for k in bj._fields})
    php, lost_p = psrc.emit(
        pph, draws, bp, src, grid.r_edges, grid.z_edges, grid.zone_surf,
        _t(eps[0]), _t(eps[1]), _t(eloss_th), _t(eloss_tot), tables.e_ph,
        torch.as_tensor(np.float32(dt)), 3, 2, c_scaled=jsim.scales.c)
    new = np.asarray(phj.alive) & ~np.asarray(jph.alive)
    assert new.sum() > 1000
    for name in ("jz", "kr", "alive"):
        np.testing.assert_array_equal(_np(getattr(php, name)),
                                      _np(getattr(phj, name)), err_msg=name)
    for name in ("e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen"):
        np.testing.assert_allclose(_np(getattr(php, name)),
                                   _np(getattr(phj, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(lost_p), float(lost_j), rtol=1e-5)


@pytest.mark.parametrize("n_reserve", [300, 3000])
def test_census_roulette_matches_with_reference_uniforms(n_reserve):
    """The roulette fires (occupancy above 0.85, or too few free slots);
    survivors exact, weights rtol 1e-5."""
    jph, pph = _photons(4, 0.9)
    key = jax.random.PRNGKey(7)
    ph_j, e_rr_j, n_rr_j = j_rr(jph, key, 0.85, 0.6,
                                n_reserve=jnp.int32(n_reserve))
    u = jax.random.uniform(key, (N,), jnp.float32)
    ph_p, e_rr_p, n_rr_p = p_rr(pph, _t(u), 0.85,
                                torch.tensor(0.6 * N, dtype=torch.float32),
                                n_reserve=torch.tensor(n_reserve))
    assert int(n_rr_j) > 0
    assert int(n_rr_p) == int(n_rr_j)
    np.testing.assert_array_equal(_np(ph_p.alive), _np(ph_j.alive))
    np.testing.assert_allclose(_np(ph_p.w), _np(ph_j.w), rtol=1e-5)
    np.testing.assert_allclose(float(e_rr_p), float(e_rr_j), rtol=1e-5,
                               atol=1e-5 * float(np.asarray(jph.w).sum()))


def test_census_roulette_idle_below_occupancy():
    _, pph = _photons(5, 0.5)
    ph_p, e_rr, n_rr = p_rr(pph, torch.rand(N), 0.85,
                            torch.tensor(0.6 * N, dtype=torch.float32),
                            n_reserve=torch.tensor(100))
    assert int(n_rr) == 0 and float(e_rr) == 0.0
    assert torch.equal(ph_p.w, pph.w)
