"""The JAX reference's scatter uniforms as numpy, for feeding the port's
samplers the same numbers, and the tolerances that sampler outputs are
held to (a helper of the tests/test_torch_*.py files)."""
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


def to_draws(d: dict, idx=None) -> ScatterDraws:
    """ScatterDraws of the lanes ``idx`` (all lanes if None)."""
    sel = slice(None) if idx is None else np.asarray(idx)
    return ScatterDraws(**{k: torch.as_tensor(v[..., sel].copy())
                           for k, v in d.items()})


def apply_scatter_draw(k_scat, n, max_tries):
    """The port's ``tracking.ScatterDrawFn`` giving the reference's
    ``apply_scatter`` numbers: stream 0 from k_scat, stream 1 + m from
    fold_in(k_scat, 1 + m), each drawn for all n slots and then gathered
    at the lanes asked for."""
    cache = {}

    def draw(first, n_streams, idx):
        parts = []
        for s in range(first, first + n_streams):
            if s not in cache:
                key = k_scat if s == 0 else jax.random.fold_in(k_scat, s)
                cache[s] = strat_draws(key, n, max_tries)
            parts.append(to_draws(cache[s], idx.numpy()))
        return ScatterDraws(*(torch.cat([getattr(p, f) for p in parts],
                                        dim=-1)
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
