"""A copy of the reference's jax-free
``compton2d_tpu.physics.icloss``, so that the port imports nothing
of the JAX package. Keep the two in step.

Inverse-Compton single-electron energy-loss kernel F_IC.

Exact full-Klein-Nishina IC loss rate of one electron (Lorentz factor
gamma) in an isotropic monochromatic photon bath (energy epsilon), after
Jones (1968): ``reference/src/icloss2d.f``. Precomputed once at
setup (host numpy float64 — the device is float32-only) on the
(num_nt gamma) x (nphfield photon-energy) grid; the FP solve contracts it
against the tallied radiation field ``n_field`` to get the per-bin IC
drift dg_ic (update2d.f:568-574) — on TPU that contraction is a
(zones, nphfield) @ (nphfield, num_nt) matmul.

The reference's f_Li series (icloss2d.f:104-125) converges as 1/n^2 and
needs ~1e5 terms near threshold; here it is evaluated in closed form via
the dilogarithm: f_Li(z) = ln(y)(ln(y)/2 - ln(2z)) + Li2(1/y), y = 1+2z.
"""
from __future__ import annotations

import numpy as np

from c2dref import constants as cn

_A_IC = 3.7419e-15  # c*pi*r_0^2 / 2 ... reference constant (icloss2d.f:22)
_THOMSON_COEF = 2.66e-14  # Thomson-limit coefficient (icloss2d.f:32)


def dilog_01(p):
    """Li2(p) for p in [0, 1]. Host numpy."""
    p = np.asarray(p, np.float64)
    hi = p > 0.5
    w = np.where(hi, 1.0 - p, p)            # w in [0, 1/2]

    pw = np.ones_like(w)
    series = np.zeros_like(w)
    for k in range(1, 60):
        pw = pw * w
        series = series + pw / (k * k)
    pi2_6 = np.pi * np.pi / 6.0
    lp = np.log(np.maximum(p, 1e-300))
    l1p = np.log(np.maximum(1.0 - p, 1e-300))
    return np.where(hi, pi2_6 - lp * l1p - series, series)


def f_li(z):
    """Closed form of the reference's f_Li series (icloss2d.f:104-125)."""
    y = 1.0 + 2.0 * z
    ly = np.log(y)
    return ly * (0.5 * ly - np.log(2.0 * np.maximum(z, 1e-300))) + dilog_01(
        1.0 / y
    )


def f1(z):
    """icloss2d.f:68-81."""
    y = 1.0 + 2.0 * z
    zs = np.maximum(z, 1e-300)
    sd1 = (z + 6.0 + 3.0 / zs) * np.log(y)
    sd2 = ((22.0 / 3.0) * z**3 + 24.0 * z**2 + 18.0 * z + 4.0) / (y * y)
    return sd1 - sd2 - 2.0 + 2.0 * f_li(z)


def f2(z):
    """icloss2d.f:85-99."""
    y = 1.0 + 2.0 * z
    zs = np.maximum(z, 1e-300)
    sd1 = (z + 31.0 / 6.0 + 5.0 / zs + 1.5 / zs**2) * np.log(y)
    sd2 = (
        (22.0 / 3.0) * z**3 + 28.0 * z**2 + (103.0 / 3.0) * z
        + 17.0 + 3.0 / zs
    ) / (y * y)
    return sd1 - sd2 - 2.0 + f_li(z)


def fic_table(gnt, e_field) -> np.ndarray:
    """F_IC(gamma, epsilon) on the (num_nt,) x (nphfield,) grid
    (icloss2d.f:24-45). ``e_field`` in keV. Host numpy float64."""
    gamma = (np.asarray(gnt, np.float64) + 1.0)[:, None]
    eps = (cn.KEV_TO_MEC2 * np.asarray(e_field, np.float64))[None, :]
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (gamma * gamma), 1e-24))
    thomson = _THOMSON_COEF * eps * (gamma * gamma - 1.0)
    z1 = eps * gamma * (1.0 + beta)
    z2 = eps / (gamma * (1.0 + beta))
    F = gamma * (f1(z1) - f1(z2)) - eps * (f2(z1) - f2(z2))
    full = _A_IC * F / ((eps * gamma) ** 2 * beta)
    return np.where(gamma * eps < 1e-2, thomson, full)
