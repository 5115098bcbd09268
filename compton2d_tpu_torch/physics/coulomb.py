"""Exact Coulomb (electron-proton) and Moller (electron-electron)
drift/dispersion coefficients (the port's copy of
``compton2d_tpu.physics.coulomb``).

The live integrals of ``FP_calc`` (update2d.f:2083-2470 of the Fortran
reference) in host numpy float64: ``Intdgcp``/``Intd2cp`` (relativistic
e-p Coulomb drift/dispersion over a thermal proton bath), ``dg_mo`` /
``disp_mo`` (the Nayakshin & Melia 1998 small-angle Moller forms with
the chi/zeta closed forms ``ch_f``/``z_f``) and ``Inteta``.

And the rate-table layer of ``coulomb.f``: the reference caches these
integrals in per-temperature files (``rates/dgeTTTT.dat``); here
:func:`build_coulomb_tables` precomputes (temperature x gamma) tables
once per process and :class:`CoulombTables` interpolates them on the
device for the optional ``fp_include_coulomb`` FP operator (the
reference's *active* operator excludes these terms,
update2d.f:1048-1049).

:func:`intd2cp` evaluates the three ``Inteta`` integrals of each proton
Lorentz factor on one shared grid, a block of factors at a time, and
keeps the reference's sequential sum and its stop rule (the first term
past the 101st below 1e-12 of the running total ends it).

Usage of the raw integrals in FP coefficients (update2d.f:898-988):

    dg_cp  = 1.194e-14 n_p lnL Intdgcp /((1+1.875 Th_p+.8203 Th_p^2)
             sqrt(Th_p) g^2 b)                       [gamma < 3]
    dg_ce  = 1.496e-14 lnL (n_lept/Th K2(1/Th)) dg_mo /(g^2 b)
    disp_ce= 0.25 * 2.99e-14 lnL (n_lept/Th K2) disp_mo /(g^2 b)
    disp_cp= 1.194e-14 n_p Intd2cp /(Th_p^1.5 (1+1.875 Th_p
             +.8203 Th_p^2) g^2 b)                   [gamma < 3]
"""
from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from compton2d_tpu_torch.physics.electron_dist import _mcdonald_np

ME_KEV = 511.0
MP_KEV = 9.38e5
# proton Lorentz factors of intd2cp evaluated together (rows of 2000
# float64 points each)
_D2CP_BLOCK = 256


def ch_f(x):
    """update2d.f:2402-2421."""
    x = np.asarray(x, np.float64)
    ok = x >= 1.00000001
    xs = np.where(ok, x, 2.0)
    z = np.sqrt(0.5 * (xs - 1.0))
    x1 = 2.0 * np.log(z + np.sqrt(z * z + 1.0))
    x2 = np.sqrt(xs * xs - 1.0)
    x3 = np.sqrt((xs + 1.0) / (xs - 1.0))
    return np.where(ok, x1 + x2 - x3, 0.0)


def z_f(g, g1, x):
    """update2d.f:2425-2443."""
    x = np.asarray(x, np.float64)
    ok = x >= 1.00000001
    xs = np.where(ok, x, 2.0)
    y = xs * xs - 1.0
    sq = np.sqrt(y)
    I1 = sq - np.log(xs + sq) + np.sqrt((xs - 1.0) / (xs + 1.0))
    I2 = 0.5 * (xs * sq + np.log(xs + sq))
    return np.where(ok, 0.5 * (g + g1) ** 2 * I1 - I2, 0.0)


def dg_mo(g, b, theta, n_x=4000):
    """Small-angle Moller energy-exchange integral
    (update2d.f:2330-2358), vectorized over the thermal bath grid."""
    g = np.asarray(g, np.float64)[..., None]
    b = np.asarray(b, np.float64)[..., None]
    xs = 1.0 + (np.arange(n_x) + 0.5) * (10.0 * theta / n_x)
    d = 10.0 * theta / n_x
    bs = np.sqrt(np.maximum(1.0 - 1.0 / xs**2, 0.0))
    y = xs / theta
    gplus = g * xs * (1.0 + b * bs)
    gminus = g * xs * (1.0 - b * bs)
    chi = ch_f(gplus) - ch_f(gminus)
    sd = np.where(
        (y < 500.0) & (gplus > 1.0001 * gminus),
        0.5 * (xs - g) * chi * np.exp(-np.minimum(y, 500.0)),
        0.0,
    )
    return np.sum(sd * d, axis=-1)


def disp_mo(g, b, theta, n_x=4000):
    """update2d.f:2366-2396."""
    g = np.asarray(g, np.float64)[..., None]
    b = np.asarray(b, np.float64)[..., None]
    xs = 1.0 + (np.arange(n_x) + 0.5) * (10.0 * theta / n_x)
    d = 10.0 * theta / n_x
    bs = np.sqrt(np.maximum(1.0 - 1.0 / xs**2, 0.0))
    y = xs / theta
    gplus = g * xs * (1.0 + b * bs)
    gminus = g * xs * (1.0 - b * bs)
    chi = ch_f(gplus) - ch_f(gminus)
    zeta = z_f(g, xs, gplus) - z_f(g, xs, gminus)
    sd = np.where(
        (y < 500.0) & (gplus > 1.0001 * gminus),
        (-0.5 * (g - xs) ** 2 * chi + zeta)
        * np.exp(-np.minimum(y, 500.0)),
        0.0,
    )
    return np.sum(sd * d, axis=-1)


def intdgcp(g, b, kTp, n_gr=12000):
    """Relativistic e-p Coulomb drift integral (update2d.f:2083-2139),
    midpoint log grid over the proton Lorentz factor."""
    g = float(g)
    b = float(b)
    me, mp = ME_KEV, MP_KEV
    dgr = 1.001
    gr = np.cumprod(np.full(n_gr, dgr)) / dgr
    grs = gr * 0.5 * (1.0 + dgr)
    d = dgr - 1.0
    br = np.sqrt(np.maximum(1.0 - 1.0 / grs**2, 1e-30))
    s = mp**2 + me**2 + 2.0 * mp * me * grs
    q = np.sqrt(s) / kTp
    gs = (mp * grs + me) / np.sqrt(s)
    bs = np.sqrt(np.maximum(1.0 - 1.0 / gs**2, 0.0))
    E10, E1s = me * g, me * gs
    p10 = me * g * b
    p1s = me * mp * grs * br / np.sqrt(s)
    gcp = (E10 * E1s + p10 * p1s) / me**2
    gcm = (E10 * E1s - p10 * p1s) / me**2
    xm = (mp + g * me) / kTp - q * gcm
    xp = (mp + g * me) / kTp - q * gcp
    om1 = np.where(xm > -200.0, np.exp(np.minimum(xm, 200.0)), 0.0)
    om2 = np.where(xp > -200.0, np.exp(np.minimum(xp, 200.0)), 0.0)
    om_p, om_m = om1 + om2, om1 - om2
    sd = (
        om_m * (g * (bs * gs) ** 2 + gs / q)
        - om_p * b * g * bs * gs**2
    ) / (grs * br**3)
    return float(np.sum(sd * gr * d))


def _inteta(x0, x1, p, q, tau, n=2000):
    """update2d.f:2446-2470 (midpoint log grid)."""
    if x1 <= x0:
        return 0.0
    x = np.geomspace(x0, x1, n + 1)
    xs = np.sqrt(x[1:] * x[:-1])
    dx = np.diff(x)
    y = tau - q * xs
    sd = np.where(
        y > -200.0,
        (xs**p if p >= 0.1 else 1.0) * np.exp(np.minimum(y, 200.0)),
        0.0,
    )
    return float(np.sum(sd * dx))


def _inteta012(x0, x1, q, tau, n=2000):
    """``_inteta`` for p = 0, 1, 2 of each row (x0, x1, q all (k,), with
    x1 > x0), on one grid and one exponential: three (k,) arrays."""
    # C order, so that each row's sums are numpy's pairwise sums of a row
    x = np.ascontiguousarray(np.geomspace(x0, x1, n + 1, axis=-1))
    xs = np.sqrt(x[:, 1:] * x[:, :-1])
    dx = np.diff(x, axis=-1)
    y = tau - q[:, None] * xs
    e = np.where(y > -200.0, np.exp(np.minimum(y, 200.0)), 0.0)
    return (np.sum(e * dx, axis=-1), np.sum(xs * e * dx, axis=-1),
            np.sum(xs**2 * e * dx, axis=-1))


def intd2cp(g, b, kTp, lnL=20.0, n_gr=3000):
    """update2d.f:2145-2196."""
    me, mp = ME_KEV, MP_KEV
    dgr = 1.001
    gr = np.cumprod(np.full(n_gr, dgr)) / dgr
    grs = gr * 0.5 * (1.0 + dgr)
    d = dgr - 1.0
    br = np.sqrt(np.maximum(1.0 - 1.0 / grs**2, 1e-30))
    const_A = lnL - 0.25 * (1.0 + br**2)
    const_B = lnL - 0.25 * (6.0 + br**2)
    s = mp**2 + me**2 + 2.0 * mp * me * grs
    gs = (mp * grs + me) / np.sqrt(s)
    bs = np.sqrt(np.maximum(1.0 - 1.0 / gs**2, 1e-30))
    p1s = me * mp * grs * br / np.sqrt(s)
    gcp = (me * g * me * gs + me * g * b * p1s) / me**2
    gcm = (me * g * me * gs - me * g * b * p1s) / me**2
    q = np.sqrt(s) / kTp
    tau = (mp + g * me) / kTp
    live = np.flatnonzero(~(gcp <= gcm * (1.0 + 1e-12)))
    total = 0.0
    for lo in range(0, live.shape[0], _D2CP_BLOCK):
        i = live[lo:lo + _D2CP_BLOCK]
        eta0, eta1, eta2 = _inteta012(gcm[i], gcp[i], q[i], tau)
        bg2 = (bs[i] * gs[i]) ** 2
        sd = (
            -eta0 * (const_A[i] * bg2 + const_B[i] * g**2)
            + 2.0 * eta1 * const_B[i] * g * gs[i]
            + eta2 * (const_A[i] * bg2 - const_B[i] * gs[i] ** 2)
        ) / (gs[i] * bs[i] * br[i] ** 2)
        # the running total, summed in the reference's order
        run = np.cumsum(np.concatenate([[total], sd * gr[i] * d]))[1:]
        stop = np.flatnonzero((i > 100) & (np.abs(sd) < 1e-12 * np.abs(run)))
        if stop.shape[0]:
            return float(run[stop[0]])
        total = run[-1]
    return float(total)


def _k2_theta(theta):
    """Th * K2(1/Th) (the reference's Th_K2, update2d.f:878)."""
    return float(theta * _mcdonald_np(2.0, np.array([1.0 / theta]))[0])


class CoulombTables(NamedTuple):
    """(T x gamma) float32 tables on the device (the reference's rates/
    file cache, coulomb.f:29-132)."""

    log_te: torch.Tensor     # (nte,) log electron temperature grid [keV]
    log_tp: torch.Tensor     # (ntp,) log proton temperature grid [keV]
    dg_ce: torch.Tensor      # (nte, num_nt) per n_lept [1/s cm^3]
    disp_ce: torch.Tensor    # (nte, num_nt)
    dg_cp: torch.Tensor      # (ntp, num_nt) per n_p
    disp_cp: torch.Tensor    # (ntp, num_nt)

    def electron_rows(self, te):
        """(dg_ce, disp_ce) rows at electron temperatures te (Z,) [keV],
        each (Z, num_nt), still to be multiplied by n_lept."""
        return _rows((self.dg_ce, self.disp_ce), self.log_te, te)

    def proton_rows(self, tp):
        """(dg_cp, disp_cp) rows at proton temperatures tp (Z,) [keV],
        each (Z, num_nt), still to be multiplied by n_p."""
        return _rows((self.dg_cp, self.disp_cp), self.log_tp, tp)


def _rows(tables, log_grid, t):
    """The reference's lookup (``CoulombTables.lookup``) of each table at
    t: x, the knot index of log t (``jnp.interp`` against 0..n-1: linear
    between knots, held at the ends), then the rows i0 = min(floor(x),
    n - 2) and i0 + 1 weighted by f = x - i0."""
    n = log_grid.shape[0]
    lt = torch.log(t)
    i = torch.clamp(torch.searchsorted(log_grid, lt.contiguous(),
                                       right=True), 1, n - 1)
    x = (i - 1).to(lt.dtype) + (lt - log_grid[i - 1]) / (
        log_grid[i] - log_grid[i - 1])
    x = torch.clamp(x, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    f = (x - i0)[:, None]
    return tuple(tab[i0] * (1 - f) + tab[i0 + 1] * f for tab in tables)


def build_coulomb_tables(
    gnt: np.ndarray,
    te_grid=None,
    tp_grid=None,
    lnL: float = 20.0,
    gamma_cp_max: float = 3.0,
    device="cpu",
) -> CoulombTables:
    """The coefficient tables (host numpy f64, float32 on ``device``),
    built once per process for each set of arguments.

    Uses the NM98 small-angle Moller forms for e-e (the reference's
    live path when rate files are absent, update2d.f:911-915, 966-977)
    and Intdgcp/Intd2cp for e-p below gamma_cp_max (frozen above, as in
    update2d.f:898-907).
    """
    if te_grid is None:
        te_grid = np.geomspace(5.0, 1000.0, 24)
    if tp_grid is None:
        tp_grid = np.geomspace(5.0, 1.0e5, 8)
    gnt = np.asarray(gnt)     # its dtype is the reference's gamma's
    arrays = _tables_np(
        gnt.dtype.str, gnt.tobytes(),
        np.asarray(te_grid, np.float64).tobytes(),
        np.asarray(tp_grid, np.float64).tobytes(), float(lnL),
        float(gamma_cp_max))
    return CoulombTables(*(torch.tensor(a, device=device) for a in arrays))


@functools.lru_cache(maxsize=8)
def _tables_np(gnt_dtype: str, gnt_b: bytes, te_b: bytes, tp_b: bytes,
               lnL: float, gamma_cp_max: float):
    """build_coulomb_tables' float32 arrays (read-only), memoised on its
    arguments as bytes."""
    gnt = np.frombuffer(gnt_b, gnt_dtype)
    te_grid, tp_grid = (np.frombuffer(b, np.float64) for b in (te_b, tp_b))
    gamma = gnt + 1.0
    beta = np.sqrt(np.maximum(1.0 - 1.0 / gamma**2, 1e-20))
    num_nt = len(gamma)

    dg_ce = np.zeros((len(te_grid), num_nt))
    disp_ce = np.zeros_like(dg_ce)
    for i, te in enumerate(te_grid):
        th = te / ME_KEV
        k2 = _k2_theta(th)
        dm = dg_mo(gamma, beta, th)
        d2 = disp_mo(gamma, beta, th)
        dg_ce[i] = 1.496e-14 * lnL / k2 * dm / (gamma**2 * beta)
        disp_ce[i] = 0.25 * 2.99e-14 * lnL / k2 * d2 / (gamma**2 * beta)

    def cp_row(tp):
        th_p = tp / MP_KEV
        denom_fac = (1.0 + 1.875 * th_p + 0.8203 * th_p**2)
        dg_row, disp_row = np.zeros(num_nt), np.zeros(num_nt)
        last_dg = 0.0
        for j, (g, b) in enumerate(zip(gamma, beta)):
            if g < gamma_cp_max:
                last_dg = (
                    1.194e-14 * lnL * intdgcp(g, b, tp)
                    / (denom_fac * np.sqrt(th_p) * g**2 * b)
                )
                disp_row[j] = (
                    1.194e-14 * intd2cp(g, b, tp, lnL)
                    / (th_p**1.5 * denom_fac * g**2 * b)
                )
            dg_row[j] = last_dg
        return dg_row, disp_row

    # one proton temperature a thread (numpy's loops release the GIL)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(len(tp_grid), os.cpu_count() or 1))
    ) as pool:
        cp_rows = list(pool.map(cp_row, tp_grid))
    dg_cp = np.array([r[0] for r in cp_rows]).reshape(len(tp_grid), num_nt)
    disp_cp = np.array([r[1] for r in cp_rows]).reshape(len(tp_grid),
                                                         num_nt)
    out = tuple(np.asarray(a, np.float32) for a in (
        np.log(te_grid), np.log(tp_grid), dg_ce, disp_ce, dg_cp, disp_cp))
    for a in out:
        a.flags.writeable = False
    return out
