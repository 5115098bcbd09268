"""Reference-deactivated emissivity channels, kept as diagnostics (the
port's copy of ``compton2d_tpu.physics.emissivity_extras``, numpy only).

The Fortran reference computes thermal-cyclotron emission/absorption
(``volume2d.f:253-315``) and the pair-annihilation radiation spectrum via
the ``vdsigma`` cross section (``volume2d.f:318-339, 448-570``), but
excludes BOTH from the active MC emission CDF and the energy budget:
``kappa_tot = kappa_sy`` only and "deactivated any spectrum except
synchrotron" (``volume2d.f:347-351``); ``Eloss_tot = Eloss_sy`` in the
budget (``imcgen2d.f:328-331``). Only the ``Eloss_cy`` *tally* is still
accumulated (``volume2d.f:353``).

This module reproduces those channels on the host (float64 numpy: they
feed no device path):

- :func:`cyclotron` — first-n-harmonics Gaussian lines + the
  Mahadevan-Narayan-Yi (1996) high-harmonic formula, with the Razin
  suppression factor f_rz and plasma cutoff;
- :func:`vdsigma` / :func:`annihilation_spectrum` — Svensson-style
  pair-annihilation spectrum from the electron + positron
  distributions;
- :func:`eloss_cy` — the reference's Eloss_cy tally over the
  optically-thin bins.

All are inactive in the simulation step by construction (parity with
the reference); ``driver.write_diagnostics`` dumps them when asked.
"""
from __future__ import annotations

import numpy as np

N_HARMONICS = 5   # volume2d.f n_harmonics


def _mcdonald_k2(theta: np.ndarray) -> np.ndarray:
    """K_2(1/Theta) (volume2d.f:599-626 via scipy-free integral)."""
    theta = np.atleast_1d(np.asarray(theta, float))
    x = 1.0 / np.maximum(theta, 1e-10)
    # integral representation K_2(x) = int cosh(2t) e^{-x cosh t} dt
    t = np.linspace(0.0, 12.0, 4001)
    ct = np.cosh(t)
    integ = np.cosh(2.0 * t)[None, :] * np.exp(
        -np.minimum(x[:, None] * ct[None, :], 700.0)
    )
    return np.trapezoid(integ, t, axis=1)


def cyclotron(
    e_ph: np.ndarray,       # (n_vol,) [keV]
    tea: np.ndarray,        # (...,) zone temperature [keV]
    n_e: np.ndarray,        # (...,) [cm^-3]
    B: np.ndarray,          # (...,) [G]
    n_harmonics: int = N_HARMONICS,
):
    """Thermal cyclotron j_cy [erg/s/cm^3/sr/keV-ish, the reference's
    internal units] and kappa_cy [1/cm] per zone per bin
    (volume2d.f:253-315). Returns arrays (*zone_shape, n_vol)."""
    tea = np.atleast_1d(np.asarray(tea, float))
    sh = tea.shape
    tz = tea.reshape(-1)[:, None]                   # (Z, 1)
    nz_ = np.asarray(n_e, float).reshape(-1)[:, None]
    Bz = np.maximum(np.asarray(B, float).reshape(-1)[:, None], 1e-20)
    E = np.asarray(e_ph, float)[None, :]            # (1, n_vol)
    nu = 2.41487e17 * E
    theta = tz / 511.0

    nu_c = 2.8e6 * Bz
    nu_min = n_harmonics * nu_c
    nu_p = 9.0e3 * np.sqrt(nz_)

    # Razin suppression (volume2d.f:104-110)
    g_av = _gamma_bar(theta[:, 0])[:, None]
    gamma_R = 2.1e-3 * np.sqrt(nz_) / (Bz * np.sqrt(g_av))
    y = gamma_R / g_av
    f_rz = np.where(y < 100.0, np.exp(-np.minimum(y, 100.0)), 0.0)

    j_cy = np.zeros_like(nu)
    kap_cy = np.zeros_like(nu)
    f_m = 1.0
    for m in range(1, n_harmonics + 1):
        mm = float(m)
        f_m = f_m / (4.0 * mm)
        nu_m = mm * nu_c
        E_m = 4.14e-18 * nu_m
        D_m = 7.07e-1 * theta * E_m
        x = ((E - E_m) / np.maximum(D_m, 1e-300)) ** 2
        yy = E_m / tz
        ok = x < 50.0
        f_cy = np.where(
            ok,
            f_rz * np.exp(-np.minimum(x, 50.0)) * nz_ * Bz**2
            * theta ** (mm - 1.5) * (mm + 1.0) * f_m
            * mm ** (2.0 * mm + 1.0),
            0.0,
        )
        j_cy += 8.46e-14 * f_cy * E**2 / E_m**3
        kap_cy += np.where(
            yy < 150.0,
            5.705e33 * np.expm1(np.minimum(yy, 150.0)) * f_cy
            / (nu * nu_m**3),
            np.where(
                (yy - x > -100.0) & (yy - x <= 150.0),
                f_rz * 5.705e33
                * np.exp(np.clip(yy - x, -100.0, 150.0)) * nz_
                * Bz**2 * theta ** (mm - 1.5) * f_m * (mm + 1.0)
                * mm ** (2.0 * mm + 1.0) / (nu * nu_m**3),
                np.where(yy - x > 150.0, 1e70, 0.0),
            ),
        )

    # MNY96 high harmonics (volume2d.f:294-315)
    K2 = _mcdonald_k2(theta[:, 0])[:, None]
    v = nu / (nu_c * theta**2)
    yv = 4.5 * v
    j_hi = np.where(
        (nu > nu_min) & (yv < 1e6),
        4.652e-12 * nz_ * nu
        / (K2 * v**(1.0 / 6.0)
           * np.exp(np.minimum(yv ** (1.0 / 3.0), 700.0))),
        0.0,
    )
    j_cy = j_cy + j_hi
    ye = E / tz
    B_nu = np.where(
        ye < 1e-6,
        3.56e-30 * nu**3 / np.maximum(ye, 1e-300),
        3.56e-30 * nu**3 / np.maximum(np.expm1(np.minimum(ye, 700.0)),
                                      1e-300),
    )
    kap_cy = kap_cy + np.where(
        (nu > nu_min) & (ye < 100.0), j_hi / np.maximum(B_nu, 1e-300),
        0.0,
    )
    # plasma cutoff (volume2d.f:256-260)
    below = nu <= nu_p
    j_cy = np.where(below, 0.0, j_cy)
    kap_cy = np.where(below, 0.0, kap_cy)
    nv = E.shape[1]
    return j_cy.reshape(sh + (nv,)), kap_cy.reshape(sh + (nv,))


def _gamma_bar(theta: np.ndarray) -> np.ndarray:
    """Mean Lorentz factor of a Maxwell-Juttner distribution."""
    g = np.geomspace(1.0 + 1e-6, 1e4, 2000)
    beta = np.sqrt(1.0 - 1.0 / g**2)
    th = np.maximum(np.atleast_1d(theta), 1e-6)[:, None]
    f = g[None, :] ** 2 * beta[None, :] * np.exp(
        -np.minimum((g[None, :] - 1.0) / th, 700.0)
    )
    num = np.trapezoid(f * g[None, :], g, axis=1)
    den = np.maximum(np.trapezoid(f, g, axis=1), 1e-300)
    return num / den


def vdsigma(eps, ge, gp):
    """Velocity-averaged pair-annihilation differential cross section
    (Svensson 1982-style, volume2d.f:448-570), vectorized over any
    broadcastable (eps, ge, gp). eps in m_e c^2 units."""
    eps = np.asarray(eps, float)
    ge = np.asarray(ge, float)
    gp = np.asarray(gp, float)
    be = np.sqrt(np.maximum(1.0 - 1.0 / ge**2, 0.0)) + 1e-10
    bp = np.sqrt(np.maximum(1.0 - 1.0 / gp**2, 0.0)) + 1e-10
    eps_u = 0.5 * (gp * (1.0 + bp) + ge * (1.0 + be))
    eps_l = 0.5 * (gp * (1.0 - bp) + ge * (1.0 - be))
    gcm_l2 = 0.5 * (1.0 + ge * gp * (1.0 - be * bp))
    gcmmax2 = 0.5 * (1.0 + ge * gp * (1.0 + be * bp))
    gcms2 = eps * (ge + gp - eps)
    valid = (
        (ge >= 1.000001) & (gp >= 1.0000001)
        & (eps > eps_l) & (eps < eps_u)
        & (gcm_l2 > 1.00001) & (gcmmax2 > 1.0) & (gcms2 > 1.00001)
    )
    gcm_l = np.sqrt(np.maximum(gcm_l2, 1.0))
    gcm_u = np.minimum(np.sqrt(np.maximum(gcms2, 1.0)),
                       np.sqrt(np.maximum(gcmmax2, 1.0)))
    valid &= gcm_u > 1.0001 * gcm_l
    out = np.where(
        valid,
        7.48e-15
        * (_f_vds(gcm_u, ge, gp, eps) - _f_vds(gcm_l, ge, gp, eps))
        / (be * bp * (ge * gp) ** 2),
        0.0,
    )
    return np.where(np.isfinite(out), out, 0.0)


def _f_vds(gcm, ge, gp, eps):
    D = (ge + gp) ** 2 - 4.0 * gcm**2
    root = np.sqrt(np.maximum(D, 0.0))
    return np.where(
        D > 1e-20,
        root + _h_pa(gcm, ge, gp, eps) + _h_pa(gcm, gp, ge, eps),
        0.0,
    )


def _h_pa(gcm, ge, gp, eps):
    c = (ge - eps) ** 2 - 1.0
    d = ge * (gp + ge) + eps * (gp - ge)
    gcms2 = eps * (ge + gp - eps)
    gstar = np.sqrt(np.maximum(gcms2, 1.0))
    u2 = c * gcm**2 + gcms2
    u = np.sqrt(np.maximum(u2, 1e-20))
    big_c = np.abs(c) > 1e-8
    with np.errstate(divide="ignore", invalid="ignore"):
        h_full = (
            (2.0 + (1.0 - gcms2) / np.where(big_c, c, 1.0))
            * _i_pa(c, gcm, gstar, u)
            + (1.0 / gcm - gcm / np.where(big_c, c, 1.0)
               + 0.5 * gcm * (2.0 * c - d) / gcms2) / u
            + gcm * u / np.where(big_c, c, 1.0)
        )
        h_small = (
            (2.0 * gcm**3 / 3.0 + 2.0 * gcm + 1.0 / gcm) / gstar
            + 0.5 * (2.0 * gcm**3 / 3.0 - d * gcm) / gstar**3
        )
    h = np.where(big_c, h_full, h_small)
    return np.where((gcms2 >= 1.00001) & (u2 >= 1e-20) & np.isfinite(h),
                    h, 0.0)


def _i_pa(c, gcm, gcmstar, u):
    with np.errstate(divide="ignore", invalid="ignore"):
        pos = np.log(
            np.maximum(gcm * np.sqrt(np.maximum(c, 1e-300)) + u, 1e-300)
        ) / np.sqrt(np.maximum(c, 1e-300))
        neg = np.arcsin(
            np.clip(gcm * np.sqrt(np.maximum(-c, 0.0)) / gcmstar,
                    -1.0, 1.0)
        ) / np.sqrt(np.maximum(-c, 1e-300))
    return np.where(c >= 1e-8, pos, np.where(c <= -1e-8, neg, 0.0))


def annihilation_spectrum(
    e_ph: np.ndarray,      # (n_vol,) [keV]
    gnt: np.ndarray,       # (num_nt,) gamma-1 grid
    f_nt: np.ndarray,      # (..., num_nt) unit-normalized e- dist
    n_pos: np.ndarray,     # (..., num_nt) positron counts
    n_e: np.ndarray,       # (...,) [cm^-3]
) -> np.ndarray:
    """Pair-annihilation emissivity j_pa(E) per zone
    (volume2d.f:318-339): eps*1.6e-9 * sum_el dg n_e f sum_pos dg
    n_pos vdsigma. Returns (*zone_shape, n_vol)."""
    gnt = np.asarray(gnt, float)
    num_nt = gnt.shape[0]
    f = np.asarray(f_nt, float).reshape(-1, num_nt)
    npos = np.asarray(n_pos, float).reshape(-1, num_nt)
    ne = np.asarray(n_e, float).reshape(-1)
    eps = 1.957e-3 * np.asarray(e_ph, float)       # E/mec2
    g = gnt + 1.0
    dg = np.diff(gnt)
    # (n_vol, num_nt-1, num_nt-1) kernel, computed once per call
    vd = vdsigma(
        eps[:, None, None], g[None, :-1, None], g[None, None, :-1]
    )
    inner = np.einsum("vep,zp->zve", vd, npos[:, :-1] * dg[None, :])
    j_pa = np.einsum(
        "zve,ze->zv", inner, f[:, :-1] * dg[None, :]
    ) * ne[:, None] * (eps * 1.6e-9)[None, :]
    sh = np.asarray(n_e).shape
    return j_pa.reshape(sh + (len(eps),))


def eloss_cy(e_ph: np.ndarray, j_cy: np.ndarray) -> np.ndarray:
    """The reference's Eloss_cy tally (volume2d.f:353): sum over thin
    bins of j_cy * E * (dE_ratio - 1)."""
    e = np.asarray(e_ph, float)
    ratio = e[1] / e[0]
    return np.sum(j_cy * e * (ratio - 1.0), axis=-1)
