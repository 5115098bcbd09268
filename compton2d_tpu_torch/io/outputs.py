"""Run outputs: spectra, light curves, temperature histories and the
diagnostic dumps (the port's copy of ``compton2d_tpu.io.outputs``).

Re-implements the master-rank output phase ``graphics``
(``src/graphics2d.f`` of the Fortran reference):

- time-integrated angle-resolved escaping spectrum, written as a
  staircase (two rows per bin edge) in erg and photon units, normalized
  by bin width in Hz and elapsed time (graphics2d.f:140-165);
- per-angle light-curve files with time bracket rows
  (graphics2d.f:170-206);
- density-weighted mean temperature vs radius (graphics2d.f:209-232).

The reference accumulates ``fout`` across the whole run in the COMMON
block; here :class:`OutputAccumulator` does that host-side from the
per-step tallies, which the caller hands over as host (CPU) arrays. The
dump writers take tensors on any device (or arrays) and write the
reference's text, byte for byte, for the same values.
"""
from __future__ import annotations

import os

import numpy as np
import torch

KEV_TO_HZ = 2.41487e17  # nu[Hz] per keV (volume2d.f:106)


class OutputAccumulator:
    """Accumulates per-step tallies into run-level outputs."""

    def __init__(self, hu, mu_edges, lc_bands, energy_scale: float):
        self.hu = np.asarray(hu)
        self.mu_edges = np.asarray(mu_edges)
        self.lc_bands = np.asarray(lc_bands, float).reshape(-1, 2)
        self.energy_scale = energy_scale
        nmu = len(self.mu_edges)
        self.fout = np.zeros((nmu, len(self.hu) - 1))
        self.lc_rows = []          # (time0, time1, edout snapshot)
        self.t_sum = None
        self.time_sum = 0.0
        self.n_steps = 0

    def add_step(self, tallies, time: float, dt: float, tea=None,
                 n_e=None):
        # device tallies are f32 in scaled units; convert to erg in f64
        self.fout += (
            np.asarray(tallies.fout, np.float64) * self.energy_scale
        )
        self.lc_rows.append(
            (
                time, time + dt,
                np.asarray(tallies.edout, np.float64) * self.energy_scale,
            )
        )
        if tea is not None:
            t = np.asarray(tea)
            if self.t_sum is None:
                self.t_sum = np.zeros_like(t)
            self.t_sum += t * dt
            self.time_sum += dt
        self.n_steps += 1

    # ---------------- spectrum (graphics2d.f:140-165) ----------------
    def spectrum(self, elapsed: float) -> np.ndarray:
        """Rows (E [keV], F_E [erg/Hz/s]) per (mu bin), staircase."""
        dnu = np.diff(self.hu) * KEV_TO_HZ
        spec = self.fout / dnu[None, :] / max(elapsed, 1e-300)
        return spec

    def write_spectrum(self, path: str, elapsed: float,
                       photons: bool = False):
        """Staircase text file: two rows per bin edge, one file with all
        mu bins side by side (columns: E, then one flux per mu bin)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        spec = self.spectrum(elapsed)
        if photons:
            e_mid = 0.5 * (self.hu[1:] + self.hu[:-1])
            spec = spec / (e_mid * 1.602e-9)[None, :]
        with open(path, "w") as fh:
            for i in range(spec.shape[1]):
                row = " ".join("%14.7e" % v for v in spec[:, i])
                fh.write("%14.7e %s\n" % (self.hu[i], row))
                fh.write("%14.7e %s\n" % (self.hu[i + 1], row))

    # ---------------- light curves (graphics2d.f:170-206) ------------
    def write_light_curves(self, path_prefix: str):
        """One file per mu bin: rows (t0, t1, rate per band...)."""
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        nmu = len(self.mu_edges)
        for n in range(nmu):
            with open(f"{path_prefix}_mu{n:02d}.dat", "w") as fh:
                for (t0, t1, ed) in self.lc_rows:
                    rates = " ".join(
                        "%14.7e" % ed[n, m]
                        for m in range(ed.shape[1])
                    )
                    fh.write("%14.7e %14.7e %s\n" % (t0, t1, rates))

    # ---------------- temperatures (graphics2d.f:209-269) ------------
    def write_temperature_profile(self, path: str, r_edges, n_e=None):
        if self.t_sum is None:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        t_avg = self.t_sum / max(self.time_sum, 1e-300)  # (nz, nr)
        if n_e is not None:
            w = np.asarray(n_e)
            t_r = (t_avg * w).sum(0) / np.maximum(w.sum(0), 1e-300)
        else:
            t_r = t_avg.mean(0)
        r_mid = 0.5 * (np.asarray(r_edges)[1:] + np.asarray(r_edges)[:-1])
        with open(path, "w") as fh:
            for r, t in zip(r_mid, t_r):
                fh.write("%14.7e %14.7e\n" % (r, t))


# ---------------------------------------------------------------------------
# Diagnostic dumps (SURVEY.md §4: the reference's verification-by-
# inspection files)
# ---------------------------------------------------------------------------
def _host(arr) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def write_icloss(path: str, gnt, e_field, f_ic):
    """icloss.dat (icloss2d.f:47-61): F_IC table dump."""
    gnt = _host(gnt)
    e_field = _host(e_field)
    f_ic = _host(f_ic)
    with open(path, "w") as fh:
        for i, g in enumerate(gnt):
            for j, e in enumerate(e_field):
                fh.write("%14.7e %14.7e %14.7e\n" % (g, e, f_ic[i, j]))


def write_electron_snapshots(dirpath: str, gnt, f_nt, n_pos, ncycle: int,
                             stride_j: int = 15, stride_k: int = 5):
    """output/fnt_JJ_KK_CCC.dat electron-distribution snapshots
    (update2d.f:1505-1533), same zone striding as the reference."""
    os.makedirs(dirpath, exist_ok=True)
    gnt = _host(gnt)
    f_nt = _host(f_nt)
    n_pos = _host(n_pos)
    nz, nr, _ = f_nt.shape
    for j in range(0, nz, stride_j):
        for k in range(0, nr, stride_k):
            name = os.path.join(
                dirpath, f"fnt_{j+1:02d}_{k+1:02d}_{ncycle:03d}.dat"
            )
            with open(name, "w") as fh:
                for i, g in enumerate(gnt):
                    fh.write(
                        "%14.7e %14.7e %14.7e\n"
                        % (g, max(f_nt[j, k, i], 1e-30),
                           max(n_pos[j, k, i], 1e-30))
                    )


def write_seb(path: str, gnt, f_nt, n_pos=None):
    """output/seb.dat initial electron distribution
    (nontherm2d.f:119-127), zone (0,0)."""
    gnt = _host(gnt)
    f = _host(f_nt)[0, 0]
    p = _host(n_pos)[0, 0] if n_pos is not None else np.zeros_like(f)
    with open(path, "w") as fh:
        for i, g in enumerate(gnt):
            fh.write(
                "%14.7e %14.7e %14.7e\n"
                % (g, max(f[i], 1e-30), max(p[i], 1e-30))
            )


def write_nfield(path: str, e_field, n_field, energy_scale: float,
                 photons_per_erg_kev: float = 6.25e8):
    """output/nfield.dat radiation-field dump (update2d.f:1975-1981);
    converts the scaled tally back to absolute photon counts."""
    e_field = _host(e_field)
    nf = (_host(n_field).astype(np.float64) * energy_scale
          * photons_per_erg_kev)
    tot = nf.sum(axis=(0, 1))
    with open(path, "w") as fh:
        for e, v in zip(e_field, tot):
            fh.write("%14.7e %14.7e\n" % (e, max(v, 1e-30)))


def write_eic(path: str, gnt, e_ic, energy_scale: float):
    """output/eic.dat IC energy-exchange per electron bin
    (update2d.f:2054-2060)."""
    gnt = _host(gnt)
    e = _host(e_ic).astype(np.float64) * energy_scale
    with open(path, "w") as fh:
        for g, v in zip(gnt, e):
            fh.write("%14.7e %14.7e\n" % (g, v))


def write_esp(path: str, gnt, n_esp):
    """esp.dat: histogram of electrons sampled at scattering events
    (xec2d.f:116-124, nelectron of nontherm2d.f:183)."""
    data = np.column_stack([_host(gnt) + 1.0, _host(n_esp)])
    np.savetxt(path, data, fmt="%14.7e")


def write_nph(path: str, e_gg, nph):
    """n_ph1/n_ph2.dat: per-zone gamma-gamma photon field dumps
    (imcgen2d.f:198-201); rows = E_gg, columns = zones."""
    nph = _host(nph)
    flat = nph.reshape(-1, nph.shape[-1]).T    # (n_gg, nzones)
    data = np.column_stack([_host(e_gg), flat])
    np.savetxt(path, data, fmt="%14.7e")
