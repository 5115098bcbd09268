"""The plain SED and light curves of escaping-photon records: the
Doppler and time-of-flight transform of the reference's
``postprocessing/plcm.c`` (pspt.c for the SED), binned with numpy, with
the arithmetic of the port's ``run_mrk421.postprocess`` written out
from the configuration's ``postprocess`` section. ``dtype`` is float64
for the reference and float32 for its control; the weights (some 1e40
erg) are binned in units of the largest, and the tables scaled back and
put at Earth in float64, so that float32 holds every number it bins.
"""
from __future__ import annotations

import numpy as np

C_INV = 3.33333333e-11          # 1/c as the reference writes it (plcm.c)


def doppler(events: np.ndarray, gamma: float, r_max: float, dtype):
    """(t_obs, E, ew, mu) of each record (plcm.c:386-396)."""
    t_b, e, ew, r, z, mu, phi = np.asarray(events, dtype).T
    one = dtype(1.0)
    mu = -mu
    beta = dtype(np.sqrt(max(1.0 - 1.0 / gamma ** 2, 0.0)))
    d = dtype(gamma) * (one + mu * beta)
    t_b = (t_b - beta * z * dtype(C_INV)) / d
    mu = (mu + beta) / (one + mu * beta)
    cdt = z * mu / dtype(gamma) + np.sqrt(np.maximum(one - mu * mu, 0)) * (
        dtype(r_max) - r * np.cos(phi))
    return t_b + dtype(C_INV) * cdt, e * d, ew * d, mu


def sed_and_lc(events: np.ndarray, r_max: float, pp: dict,
               dtype=np.float64):
    """The SED table (E_mid, E F(E), records, nuFnu at Earth) and the
    light-curve table (t_mid, one rate a band) of ``events``."""
    events = np.array(events, np.float64)
    unit = float(np.max(events[:, 2])) or 1.0
    events[:, 2] /= unit
    t, e, ew, mu = doppler(events, pp["gamma_bulk"], r_max, dtype)
    lo, hi, n = pp["sed_edges_kev"]
    e_edges = np.geomspace(lo, hi, int(n)).astype(dtype)
    t_span = dtype(np.percentile(t, 99.5)) or dtype(1.0)
    mu0, mu1 = (dtype(x) for x in pp["mu_range"])
    sel = (t >= 0) & (t < t_span) & (mu >= mu0) & (mu <= mu1)
    ie = np.searchsorted(e_edges, e[sel], side="right") - 1
    ok = (ie >= 0) & (ie < e_edges.size - 1)
    flux = np.zeros(e_edges.size - 1, dtype)
    counts = np.zeros(e_edges.size - 1, dtype)
    np.add.at(flux, ie[ok], ew[sel][ok])
    np.add.at(counts, ie[ok], dtype(1.0))
    e_mid = np.sqrt(e_edges[1:] * e_edges[:-1])
    de = np.diff(e_edges)
    l_e = flux / (t_span * de * dtype(0.5) * (mu1 - mu0))
    earth = (e_mid * l_e).astype(np.float64) * (
        unit / (4.0 * np.pi * pp["d_l_cm"] ** 2))
    sed = np.column_stack([e_mid, (e_mid * flux / de).astype(np.float64)
                           * unit, counts, earth])

    step = dtype(pp["t_bin_obs_s"])
    t_edges = np.arange(dtype(0.0), t_span + step, step, dtype=dtype)
    it = np.searchsorted(t_edges, t, side="right") - 1
    # plcm.c's ten mu bins over [-1, 1), summed
    okt = ((it >= 0) & (it < t_edges.size - 1) & (t >= 0) & (mu >= -1)
           & (mu < 1))
    bands = np.asarray(pp["bands_kev"], dtype)
    rate = np.zeros((t_edges.size - 1, bands.shape[0]), dtype)
    for b, (e0, e1) in enumerate(bands):
        s = okt & (e >= e0) & (e < e1)
        np.add.at(rate[:, b], it[s], ew[s])
    rate = (rate / np.diff(t_edges)[:, None]).astype(np.float64) * unit
    lc = np.column_stack([0.5 * (t_edges[1:] + t_edges[:-1]), rate])
    return sed, lc
