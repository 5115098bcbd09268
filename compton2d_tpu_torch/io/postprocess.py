"""Doppler-boosted light curves and SEDs (the port's copy of
``compton2d_tpu.io.postprocess``).

Re-implements the reference's C post-processors
(``postprocessing/plcm.c`` light-curve extractor and
``pspt.c`` SED extractor) as vectorized numpy over event-record arrays.

Per photon (plcm.c:386-396), for a jet moving with bulk Lorentz factor
Gamma along +z (observer in the jet direction):

    mu      -> -mu
    D        = Gamma (1 + beta mu)
    t_bound -> (t_bound - beta z / c) / D
    E       -> E D
    ew      -> ew D
    mu      -> (mu + beta) / (1 + beta mu)
    c dt     = z mu / Gamma + sqrt(1-mu^2) (r_max - r cos phi)
    t_obs    = t_bound + dt/c ... (time-of-flight alignment)

Light curves bin (time x mu-bin x energy channel) accumulating
F = sum(ew), F2 = sum(ew^2) (for error bars) and particle counts
(plcm.c:440-464). SEDs select a time window and integrate flux vs
energy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

C_INV = 3.33333333e-11  # 1/c used by the reference (plcm.c:391,396)


def doppler_transform(
    events: np.ndarray, gam_bulk: float, r_max: float
) -> np.ndarray:
    """Apply the bulk-Doppler + time-of-flight transform; returns
    (n, 4): [t_obs, E, ew, mu] (plcm.c:386-396)."""
    t_b, E, ew, r, z, mu, phi = events.T
    mu = -mu
    beta = np.sqrt(max(1.0 - 1.0 / gam_bulk**2, 0.0))
    doppler = gam_bulk * (1.0 + mu * beta)
    t_b = (t_b - beta * z * C_INV) / doppler
    E = E * doppler
    ew = ew * doppler
    mu = (mu + beta) / (1.0 + mu * beta)
    cdt = z * mu / gam_bulk + np.sqrt(
        np.maximum(1.0 - mu * mu, 0.0)
    ) * (r_max - r * np.cos(phi))
    t_obs = t_b + C_INV * cdt
    return np.stack([t_obs, E, ew, mu], axis=1)


@dataclass
class LightCurves:
    t_edges: np.ndarray        # (nt+1,)
    mu_edges: np.ndarray       # (nmu+1,)
    e_bands: np.ndarray        # (nb, 2)
    flux: np.ndarray           # (nt, nmu, nb) sum of ew [erg]
    flux_sq: np.ndarray        # (nt, nmu, nb) sum of ew^2
    counts: np.ndarray         # (nt, nmu, nb)

    def rate(self) -> np.ndarray:
        """erg/s per bin."""
        dt = np.diff(self.t_edges)[:, None, None]
        return self.flux / dt

    def error(self) -> np.ndarray:
        """MC error bars from sum(ew^2) (plcm.c _aux output)."""
        return np.sqrt(self.flux_sq)


def light_curves(
    events: np.ndarray,
    gam_bulk: float,
    r_max: float,
    t_edges: np.ndarray,
    e_bands: np.ndarray,          # (nb, 2) [keV]
    mu_edges: Optional[np.ndarray] = None,
    t_offset: float = 0.0,
) -> LightCurves:
    """plcm.c main loop, vectorized."""
    if mu_edges is None:
        mu_edges = np.linspace(-1.0, 1.0, 11)   # plcm default 10 mu bins
    tr = doppler_transform(events, gam_bulk, r_max)
    t, E, ew, mu = tr.T
    t = t - t_offset
    nt = len(t_edges) - 1
    nmu = len(mu_edges) - 1
    nb = len(e_bands)

    it = np.searchsorted(t_edges, t, side="right") - 1
    imu = np.searchsorted(mu_edges, mu, side="right") - 1
    ok = (it >= 0) & (it < nt) & (imu >= 0) & (imu < nmu) & (t >= 0)

    flux = np.zeros((nt, nmu, nb))
    flux_sq = np.zeros((nt, nmu, nb))
    counts = np.zeros((nt, nmu, nb))
    for b, (e0, e1) in enumerate(np.asarray(e_bands)):
        sel = ok & (E >= e0) & (E < e1)
        np.add.at(flux[:, :, b], (it[sel], imu[sel]), ew[sel])
        np.add.at(flux_sq[:, :, b], (it[sel], imu[sel]), ew[sel] ** 2)
        np.add.at(counts[:, :, b], (it[sel], imu[sel]), 1.0)
    return LightCurves(
        t_edges=np.asarray(t_edges), mu_edges=np.asarray(mu_edges),
        e_bands=np.asarray(e_bands), flux=flux, flux_sq=flux_sq,
        counts=counts,
    )


@dataclass
class SED:
    e_edges: np.ndarray     # (ne+1,) [keV]
    flux: np.ndarray        # (ne,) sum of ew in window [erg]
    counts: np.ndarray      # (ne,)

    def nu_f_nu(self) -> np.ndarray:
        """E F(E) per log bin, up to a distance normalization."""
        de = np.diff(self.e_edges)
        e_mid = np.sqrt(self.e_edges[1:] * self.e_edges[:-1])
        return e_mid * self.flux / np.maximum(de, 1e-300)


def sed(
    events: np.ndarray,
    gam_bulk: float,
    r_max: float,
    t_start: float,
    t_end: float,
    e_edges: np.ndarray,
    mu_range: Tuple[float, float] = (-1.0, 1.0),
) -> SED:
    """pspt.c: time-window-selected, time-integrated spectrum."""
    tr = doppler_transform(events, gam_bulk, r_max)
    t, E, ew, mu = tr.T
    sel = (
        (t >= t_start) & (t < t_end)
        & (mu >= mu_range[0]) & (mu <= mu_range[1])
    )
    ne = len(e_edges) - 1
    ie = np.searchsorted(e_edges, E[sel], side="right") - 1
    ok = (ie >= 0) & (ie < ne)
    flux = np.zeros(ne)
    counts = np.zeros(ne)
    np.add.at(flux, ie[ok], ew[sel][ok])
    np.add.at(counts, ie[ok], 1.0)
    return SED(e_edges=np.asarray(e_edges), flux=flux, counts=counts)
