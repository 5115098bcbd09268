"""Compton cross sections (counterpart of ``compton2d_tpu.physics.compton``).

``sigma_e_table`` is the reference's host float64 builder of the
angle-averaged Klein-Nishina cross section sigma_E(E, gamma) (Coppi &
Blandford 1990 eq. 2.3, comtot2d.f:219-247), copied so the table is
bitwise equal. ``zone_sigma_table`` contracts it against each zone's
electron distribution as one float32 matmul (TF32 off, see ``policy``).
"""
from __future__ import annotations

import numpy as np
import torch

from c2dref import constants as cn

SIGMA_T = 6.65e-25  # cm^2; the reference's value (comtot2d.f:162)


def dilog_neg(x):
    """Li2(-x) for x >= 0, host numpy float64."""
    x = np.asarray(x, np.float64)
    big = x > 1.0
    xr = np.where(big, 1.0 / np.maximum(x, 1.0), x)
    landen = xr > 0.5
    w = np.where(landen, xr / (1.0 + xr), -xr)
    p = np.ones_like(w)
    series = np.zeros_like(w)
    for k in range(1, 60):
        p = p * w
        series = series + p / (k * k)
    li2_xr = np.where(landen, -0.5 * np.log1p(xr) ** 2 - series, series)
    pi2_6 = np.pi * np.pi / 6.0
    lx = np.log(np.maximum(x, 1e-300))
    return np.where(big, -pi2_6 - 0.5 * lx * lx - li2_xr, li2_xr)


def intg_v(x):
    """Antiderivative of the Coppi & Blandford eq. 2.3 integrand."""
    x = np.asarray(x, np.float64)
    xs = np.maximum(x, 1e-300)
    return (
        -0.5 * x
        + 0.5 / (1.0 + x)
        + 4.0 * dilog_neg(x)
        + (9.0 + x + 8.0 / xs) * np.log1p(x)
    )


def sigma_e(E_keV, gamma):
    """Angle-averaged KN cross section [cm^2] for a photon of energy E in
    an isotropic bath of electrons of Lorentz factor gamma."""
    x = np.asarray(E_keV, np.float64) / cn.EMASS_KEV
    g = np.maximum(np.asarray(gamma, np.float64), 1.0 + 1e-12)
    beta = np.sqrt(1.0 - 1.0 / (g * g))
    small = x * g * (1.0 + beta) < 1e-2
    sig_small = SIGMA_T * (1.0 - 2.0 * x * g)
    up = intg_v(2.0 * g * (1.0 + beta) * x)
    dn = intg_v(2.0 * g * (1.0 - beta) * x)
    xs = np.maximum(x, 1e-300)
    bs = np.maximum(beta, 1e-12)
    sig_full = 0.09375 * SIGMA_T / (g * g * bs * xs * xs) * (up - dn)
    return np.where(small, sig_small, sig_full)


def sigma_e_table(E_grid, gnt) -> np.ndarray:
    """sigma_E on the (photon-energy grid) x (gamma grid), (n_E, num_nt),
    host numpy float64."""
    gamma = np.asarray(gnt, np.float64) + 1.0
    return sigma_e(np.asarray(E_grid, np.float64)[:, None], gamma[None, :])


def zone_sigma_table(sigma_tab, f_nt, gnt, n_e, f_pair=None):
    """Per-zone macroscopic Compton opacity n_e sum_i sigma_E(E, g_i)
    f(i) dg_i, shape (nz, nr, n_E), floored at 1e-30."""
    dg = torch.diff(gnt)
    w = torch.cat([dg, dg[-1:] * 0.0])
    fw = f_nt * w
    nz, nr, num_nt = fw.shape
    sig = torch.matmul(fw.reshape(nz * nr, num_nt), sigma_tab.T)
    sig = sig.reshape(nz, nr, -1)
    ne = n_e
    if f_pair is not None:
        ne = ne * (1.0 + 2.0 * f_pair)
    return torch.clamp_min(sig * ne[..., None], 1e-30)
