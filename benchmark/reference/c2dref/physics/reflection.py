"""A copy of the reference's jax-free
``compton2d_tpu.physics.reflection``, so that the port imports nothing
of the JAX package. Keep the two in step.

Compton reflection matrices (White, Lightman & Zdziarski 1988).

Re-implements ``reference/src/ref_matrix.f``:

- ``pref_matrix``: the energy-redistribution probability matrix
  P_ref(n_out, n_in) from the WLZ Green's function on a 500-bin log grid
  over 1..1000 keV, pass-through below the 20 keV transition energy
  (ref_matrix.f:7-85);
- ``wabs_matrix``: the photoabsorption-albedo weight matrix W_abs from
  neutral-metal photoionization cross sections and edges
  (ref_matrix.f:96-499). The reference's ionization-fraction arrays are
  all ground-state (ionf_x = [1, 0, ...], ref_matrix.f:132-157), so only
  the first ion stage of each element contributes.

Computed once at setup on the host (numpy); the resulting matrices are
device constants used by the boundary-reflection kernel.
"""
from __future__ import annotations

import numpy as np

from c2dref import constants as cn

_E_TRANS = 20.0  # keV, pass-through below (ref_matrix.f:21)

# (ab0, sigma1, edge1, sigma2, edge2) for the ground-state ion of each
# element (ref_matrix.f:159-290; only i=1 entries have nonzero ionf).
# He has no edge condition on its first cross section and no edge2.
_GROUND_STATE = [
    # ab0       sigma1    edge1   sigma2   edge2
    (6.33e-2, 9.0e-18, 0.024, 0.0, np.inf),      # He (edge applied always)
    (3.90e-4, 1.0e-18, 0.30, 3.0e-16, 0.011),    # C
    (8.12e-5, 9.0e-19, 0.40, 3.0e-16, 0.014),    # N
    (6.47e-4, 6.0e-19, 0.52, 5.0e-16, 0.013),    # O
    (9.14e-5, 4.0e-19, 0.88, 1.0e-15, 0.021),    # Ne
    (3.73e-5, 2.0e-19, 1.2, 4.0e-17, 0.054),     # Mg
    (3.52e-5, 1.3e-19, 1.8, 4.0e-17, 0.11),      # Si
    (1.76e-5, 1.0e-19, 2.4, 1.0e-17, 0.16),      # S
    (3.73e-6, 8.0e-20, 3.1, 7.0e-18, 0.23),      # Ar
    (2.20e-6, 7.0e-20, 4.1, 4.0e-18, 0.35),      # Ca
    (3.16e-5, 3.0e-20, 7.1, 2.5e-18, 0.71),      # Fe
    (1.68e-6, 3.0e-20, 8.2, 2.0e-18, 0.89),      # Ni
]


def e_ref_grid(n_ref: int = cn.N_REF) -> np.ndarray:
    """Log grid 1..1000 keV (ref_matrix.f:17-20)."""
    de = np.exp(np.log(1.0e3) / n_ref)
    return de ** np.arange(n_ref)


def pref_matrix(n_ref: int = cn.N_REF) -> np.ndarray:
    """P_ref(n_out, n_in): cumulative probability that an incident photon
    in bin n_in reflects into an outgoing bin <= n_out
    (ref_matrix.f:23-81)."""
    e = e_ref_grid(n_ref)
    de = np.exp(np.log(1.0e3) / n_ref)
    x = 1.957e-3 * e                    # keV -> mc^2, reference's constant
    y = 1.0 / x

    p = np.zeros((n_ref, n_ref))
    for n_in in range(n_ref):
        if e[n_in] <= _E_TRANS:
            # pass-through: step CDF at n_in
            p[:, n_in] = (np.arange(n_ref) >= n_in).astype(float)
            continue
        y0 = y[n_in]
        dyc = 1.0e3 - y0
        A = 0.56 + 1.12 / y0**0.785 - 0.34 / y0**1.04
        alpha = -0.3 / y0**0.51 + 0.06 / y0**0.824
        beta = 0.37 - y0**0.85
        if abs(alpha + 0.5) < 1e-4:
            B = (
                (1.0 - A * (2.0 + np.log(0.5 * dyc)) / np.sqrt(dyc))
                / (y0 ** (1.0 - beta) * (y0 + 2.0) ** beta
                   * ((1.0 + 2.0 / y0) ** (1.0 - beta) - 1.0))
                * (1.0 - beta)
            )
        else:
            B = (
                (1.0 - A * (2.0 + ((0.5 * dyc) ** (alpha + 0.5) - 1.0)
                            / (alpha + 0.5)) / np.sqrt(dyc))
                / (y0 ** (1.0 - beta) * (y0 + 2.0) ** beta
                   * ((1.0 + 2.0 / y0) ** (1.0 - beta) - 1.0))
                * (1.0 - beta)
            )
        n_out = np.arange(n_in + 1)
        x1 = x[n_out]
        y1 = y[n_out]
        dy = y1 - y0
        gy = np.where(
            dy < 2.0,
            B * ((y0 + 2.0) / (y0 + dy)) ** beta,
            np.where(
                dy < dyc,
                A * (dyc / np.maximum(dy, 1e-30)) ** alpha
                / np.maximum(dy, 1e-30) ** 1.5,
                A / np.maximum(dy, 1e-30) ** 1.5,
            ),
        )
        gx = gy / x1**2
        dx = de * x1
        csum = np.cumsum(gx * dx)
        p[: n_in + 1, n_in] = csum / csum[-1]
        p[n_in + 1:, n_in] = 1.0
    return p


def _sigma_ions(e: np.ndarray) -> np.ndarray:
    """Metal photoionization cross section per H atom [cm^2]
    (ref_matrix.f:335-389, ground-state terms only)."""
    sig = np.zeros_like(e)
    for (ab0, s1, edge1, s2, edge2) in _GROUND_STATE:
        if s2 == 0.0:
            # helium: no edge gate (ref_matrix.f:341-346)
            sig = sig + ab0 * s1 / (e / edge1) ** 3
        else:
            sig = sig + np.where(e > edge1, ab0 * s1 / (e / edge1) ** 3, 0.0)
            sig = sig + np.where(e > edge2, ab0 * s2 / (e / edge2) ** 3, 0.0)
    return sig


def wabs_matrix(n_ref: int = cn.N_REF) -> np.ndarray:
    """W_abs(n_out, n_in) albedo weight matrix (ref_matrix.f:391-487)."""
    e = e_ref_grid(n_ref)
    x = 1.957e-3 * e
    n_disk = 1.0e18
    kappa_c = 6.65e-25 * n_disk
    k_nu = _sigma_ions(e) * n_disk
    eps = k_nu / (k_nu + kappa_c)

    w = np.zeros((n_ref, n_ref))
    x0 = x[None, :]   # n_in
    x1 = x[:, None]   # n_out
    hi = e[None, :] > _E_TRANS
    yy = 2.5e-6 * (1.0 / x0**4 - 1.0 / x1**4)
    w_hi = np.where(yy >= -50.0, np.minimum(1.0, np.exp(np.minimum(yy, 0.0))), 0.0)
    se = np.sqrt(eps)[None, :]
    w_lo = (1.0 - se) / (1.0 + se) * np.ones_like(w)
    w = np.where(hi, w_hi, w_lo)
    # upscattering in reflection is forbidden (ref_matrix.f:397-400)
    w = np.where(x1 > x0, 0.0, w)
    return w
