"""The JAX reference's scatter uniforms as numpy, for feeding the port's
samplers the same numbers, the tolerances that sampler outputs are held
to, and the flight kernel's exhaustion rule patched into the reference's
rejection sampler (a helper of the tests/test_torch_*.py files and of
tests/compare_pairs.py)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from compton2d_tpu_torch.transport.scatter import ScatterDraws


def _u(key, n):
    return np.asarray(jax.random.uniform(key, (n,), jnp.float32))


def sz_uniforms(key, n, max_tries):
    """The (u1, u2) candidates of ``scatter._sample_sz(key, ...)``, one
    row per rejection round."""
    u1, u2 = [], []
    for _ in range(max_tries):
        key, k1, k2 = jax.random.split(key, 3)
        u1.append(_u(k1, n))
        u2.append(_u(k2, n))
    return np.stack(u1), np.stack(u2)


def strat_draws(key, n, max_tries) -> dict:
    """Every uniform ``scatter.scatter_stratified(key, ...)`` draws for n
    lanes, by the field names of :class:`ScatterDraws`."""
    k1a, k1b, k1c, k2, k3, k4, k5 = jax.random.split(key, 7)
    u_sz1, u_sz2 = sz_uniforms(k2, n, max_tries)
    return dict(u_e=_u(k1a, n), u_om=_u(k1b, n), u_tl=_u(k1c, n),
                u_sz1=u_sz1, u_sz2=u_sz2, u_a1=_u(k3, n), u_a2=_u(k4, n),
                u_sgn=_u(k5, n))


def rejection_draws(key, n, max_tries) -> dict:
    """Every uniform ``scatter.scatter(key, ...)`` draws for n lanes, with
    its rejection loops run to max_tries rounds: per electron candidate the
    draw, angle, flip and acceptance uniforms of ``_sample_electron_and_
    angle``'s key chain, one row per round."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    rows = {"u_e": [], "u_om": [], "u_tl": [], "u_acc": []}
    for _ in range(max_tries):
        k1, *ks = jax.random.split(k1, 5)
        for name, k in zip(rows, ks):
            rows[name].append(_u(k, n))
    u_sz1, u_sz2 = sz_uniforms(k2, n, max_tries)
    return dict({k: np.stack(v) for k, v in rows.items()}, u_sz1=u_sz1,
                u_sz2=u_sz2, u_a1=_u(k3, n), u_a2=_u(k4, n), u_sgn=_u(k5, n))


def kernel_exhaustion_sampler(key, znu, draw_electron, max_tries, need):
    """The reference's ``scatter._sample_electron_and_angle`` with the
    flight kernel's exhaustion rule (flight_pallas2.py:722-740): at the
    last round a lane that has accepted nothing takes its candidate with
    znue = max(zn, 1e-10), where the reference keeps gamma 1, beta 0,
    omeg 0 and znue 1e-3."""
    from compton2d_tpu.transport import scatter as jsc

    n = znu.shape[0]

    def body(carry):
        it, key, acc, gamma, beta, omeg, znue, i_gam = carry
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        g_new, b_new, i_new = draw_electron(k1)
        om = 2.0 * jax.random.uniform(k2, (n,), jnp.float32) - 1.0
        om = jnp.clip(om, -jsc._CLAMP, jsc._CLAMP)
        tl = jax.random.uniform(k3, (n,), jnp.float32)
        tr = 0.5 * (1.0 - b_new * om)
        om = jnp.clip(jnp.where(tl > tr, -om, om), -jsc._CLAMP, jsc._CLAMP)
        zn = (1.0 - b_new * om) * znu * g_new
        u_acc = jax.random.uniform(k4, (n,), jnp.float32)
        ok = (zn >= 1e-10) & (u_acc <= jsc._kn_ratio_f32(zn))
        take = (ok | (it == max_tries - 1)) & ~acc
        gamma = jnp.where(take, g_new, gamma)
        beta = jnp.where(take, b_new, beta)
        omeg = jnp.where(take, om, omeg)
        znue = jnp.where(take, jnp.maximum(zn, 1e-10), znue)
        i_gam = jnp.where(take, i_new, i_gam)
        return it + 1, key, acc | take, gamma, beta, omeg, znue, i_gam

    def cond(carry):
        it, _, acc, *_ = carry
        return (it < max_tries) & ~jnp.all(acc)

    z0 = jnp.zeros((n,), jnp.float32)
    init = (0, key, ~need, jnp.ones((n,), jnp.float32), z0, z0,
            jnp.full((n,), 1e-3, jnp.float32), jnp.zeros((n,), jnp.int32))
    _, _, _, gamma, beta, omeg, znue, i_gam = jax.lax.while_loop(
        cond, body, init)
    return gamma, beta, omeg, znue, i_gam


@contextlib.contextmanager
def kernel_exhaustion_rule():
    """The reference's rejection sampler with the kernel's exhaustion rule
    (:func:`kernel_exhaustion_sampler`) inside the block. Patch before the
    reference's step is first traced: a Simulation built inside the block
    traces its step with it."""
    from compton2d_tpu.transport import scatter as jsc

    orig = jsc._sample_electron_and_angle
    jsc._sample_electron_and_angle = kernel_exhaustion_sampler
    try:
        yield
    finally:
        jsc._sample_electron_and_angle = orig


def to_draws(d: dict, idx=None) -> ScatterDraws:
    """ScatterDraws of the lanes ``idx`` (all lanes if None)."""
    sel = slice(None) if idx is None else np.asarray(idx)
    return ScatterDraws(**{k: torch.as_tensor(v[..., sel].copy())
                           for k, v in d.items()})


def apply_scatter_draw(k_scat, n, max_tries, rejection=False):
    """The port's ``tracking.ScatterDrawFn`` giving the reference's
    ``apply_scatter`` numbers: stream 0 from k_scat, stream 1 + m from
    fold_in(k_scat, 1 + m), each drawn for all n slots and then gathered
    at the lanes asked for; the weighted sampler's uniforms, or with
    ``rejection`` the rejection sampler's (the branch without strat_split
    has stream 0 only)."""
    cache = {}
    uniforms = rejection_draws if rejection else strat_draws

    def draw(first, n_streams, idx):
        parts = []
        for s in range(first, first + n_streams):
            if s not in cache:
                key = k_scat if s == 0 else jax.random.fold_in(k_scat, s)
                cache[s] = uniforms(key, n, max_tries)
            parts.append(to_draws(cache[s], idx.numpy()))
        return ScatterDraws(*(
            None if getattr(parts[0], f) is None
            else torch.cat([getattr(p, f) for p in parts], dim=-1)
            for f in ScatterDraws._fields))

    return draw


def assert_mostly_close(a, b, rtol, name, frac=0.999, cap=1e-3):
    """rtol on at least ``frac`` of the lanes and ``cap`` on all: where
    the lab boost 1 + beta cos(theta') nears 0 (head-on backscatter off a
    fast electron), it amplifies last-bit differences of the angles."""
    ok = np.isclose(a, b, rtol=rtol, atol=1e-6)
    assert ok.mean() >= frac, (name, ok.mean())
    np.testing.assert_allclose(a, b, rtol=cap, atol=1e-6, err_msg=name)


def _direction(mu, cphi, sphi):
    s = np.sqrt(np.maximum(1.0 - mu.astype(np.float64) ** 2, 0.0))
    return np.stack([s * cphi, s * sphi, mu], axis=-1)


def assert_new_direction(rp, rj, mu, cphi, sphi, mask):
    """The new direction (mu, cphi, sphi), components of unit vectors, to
    1e-5 on 99.5% of the lanes. Near the poles of the deflection (its
    angle near 0 or pi, where 1 - gams^2 cancels, or mu near +-1, where
    the azimuth of the deflection, cosd in _finish_scatter, is 0/0) the
    last bits of the inputs decide; there, on every lane, the new 3-D
    direction agrees within the deflection itself,
    sqrt(2 (1 - |cos theta|)), plus 1e-4."""
    mu_p, mu_j = rp.mu.numpy()[mask], np.asarray(rj.mu)[mask]
    for name in ("mu", "cphi", "sphi"):
        a = getattr(rp, name).numpy()[mask]
        b = np.asarray(getattr(rj, name))[mask]
        assert np.mean(np.abs(a - b) <= 1e-5) >= 0.995, name
    d_old = _direction(mu[mask], cphi[mask], sphi[mask])
    d_j = _direction(mu_j, np.asarray(rj.cphi)[mask],
                     np.asarray(rj.sphi)[mask])
    d_p = _direction(mu_p, rp.cphi.numpy()[mask], rp.sphi.numpy()[mask])
    cos_t = np.sum(d_old * d_j, axis=-1)
    dev = np.linalg.norm(d_p - d_j, axis=-1)
    assert np.all(dev <= np.sqrt(2.0 * (1.0 - np.abs(cos_t))) + 1e-4)
