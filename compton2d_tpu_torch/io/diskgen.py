"""A copy of the reference's numpy-only ``compton2d_tpu.io.diskgen``, so
that the port imports nothing of the JAX package. Keep the two in step.

External photon-field spectrum generator.

Re-implements ``reference/disk/disk.f`` exactly: generates the
5-column ``blackbody*.in`` files (E [keV], L_disk, F_beamed_blr, F_ir,
F_blr) consumed by the boundary file-spectrum machinery (``file_sp``
reads the first four columns, imcsurf2d_para.f:570-571):

- accretion disk: blackbody at T_disk = 3e4 K, norm 9e62 (disk.f:48);
- beamed BLR: the Tavecchio et al. (2008) eq. 4 integral over the
  digitized comoving BLR table ``tavecchio_Uext.dat`` (disk.f:94-102);
- IR torus: blackbody at 367*Gamma K (GG09, disk.f:35);
- unbeamed BLR: blackbody at the comoving Ghisellini-Ghisellini 2009
  temperature T_blr = 1.5 Gamma nu_alpha h / 3.93 k (disk.f:34);
- optional nonthermal power-law tail above E_min with exponential
  cutoff (disk.f:57-71) - note the reference freezes the thermal
  prefactor at its last sub-E_min value (Utherm_* are stale there),
  reproduced here deliberately.

Validated bin-by-bin against the statically-linked reference binary
``reference/disk/a.out`` (tests/test_diskgen_oracle.py).
"""
from __future__ import annotations

import numpy as np

H_ERG_S = 6.62618e-27
C_CM_S = 2.99792e10
K_B = 1.38e-16
SIGMA_SB = 5.67e-5
NU_ALPHA = 2.47e15  # Ly-alpha frequency (disk.f:10)
ERG_PER_KEV = 1.602e-9
PI = 3.14159  # disk.f:6 uses this 6-digit pi


def energy_grid(n_bins: int = 500, e0_kev: float = 1e-7):
    """The reference's grid (disk.f:39-42): ratio
    dnu = 10^(log10(1e10/E0)/n) starting at E0, reported at bin
    medians E0*sqrt(dnu)*dnu^i. Returns (medians, edges): disk.f
    evaluates the Planck shapes at the bin *edge* frequency (``nu``
    never gets the sqrt(dnu) shift, disk.f:40-42,73-74) but prints the
    median energy."""
    dnu = 10.0 ** (np.log10(1e10 / e0_kev) / n_bins)
    edges = e0_kev * dnu ** np.arange(n_bins)
    return edges * np.sqrt(dnu), edges


def _bb_shape(e_kev: np.ndarray, T_K: float, norm: float) -> np.ndarray:
    """norm * 2 h nu^3/c^2 / (e^{h nu/kT}-1) / (sigma/pi T^4)
    (disk.f:48-50)."""
    nu = e_kev * ERG_PER_KEV / H_ERG_S
    x = H_ERG_S * nu / (K_B * T_K)
    planck = np.where(
        x < 500.0,
        2.0 * H_ERG_S * nu**3 / C_CM_S**2 / np.expm1(np.minimum(x, 500.0)),
        0.0,
    )
    return norm * planck / (SIGMA_SB / PI * T_K**4)


def read_tavecchio_table(path: str) -> np.ndarray:
    """Digitized Tavecchio et al. (2008) comoving BLR spectrum
    (log10 nu-ish grid, log10 U): returns (n, 2) [E_kev, U]
    (disk.f:84-89)."""
    raw = np.loadtxt(path)
    e_kev = 10.0 ** raw[:, 0] * H_ERG_S / ERG_PER_KEV
    u = 10.0 ** raw[:, 1]
    return np.stack([e_kev, u], axis=1)


def beamed_blr(
    e_kev: np.ndarray, gamma_bulk: float, tave: np.ndarray
) -> np.ndarray:
    """Tavecchio et al. 2008 eq. 4 beaming integral (disk.f:94-102):
    F(E) = 2 pi E^2/(Gamma beta) * sum_{E' in (E/G/(1+b), E/G]}
    U(E')/E'^3 dE'."""
    beta = np.sqrt(1.0 - 1.0 / gamma_bulk**2)
    et, u = tave[:, 0], tave[:, 1]
    # integrand on the table's cells j..j+1 (last cell excluded, as the
    # reference loops j = 1..nph_tave-1)
    cell = (u[:-1] / et[:-1] ** 3) * np.diff(et)
    lo = e_kev / gamma_bulk / (1.0 + beta)
    hi = e_kev / gamma_bulk
    sel = (et[None, :-1] > lo[:, None]) & (et[None, :-1] <= hi[:, None])
    s = sel @ cell
    return s * 2.0 * PI * e_kev**2 / gamma_bulk / beta


def generate(
    gamma_bulk: float,
    n_bins: int = 500,
    e0_kev: float = 1e-7,
    L_disk_norm: float = 9.0e62,
    L_ext_norm: float = 1.0e44,
    tavecchio_table=None,
    pl_tail: bool = True,
    pl_e_min: float = 5e7,
    pl_e_max: float = 5e8,
    pl_index: float = 1.0,
) -> np.ndarray:
    """Returns the (n_bins, 5) table
    [E, L_disk, F_beamed_blr, F_ir, F_blr] in disk.f's column order
    (disk.f:106-110). ``tavecchio_table`` is a path or an (n, 2) array;
    when None the beamed-BLR column falls back to the unbeamed thermal
    shape (documented deviation)."""
    t_disk = 3.0e4
    t_blr = 1.5 * gamma_bulk * NU_ALPHA * H_ERG_S / 3.93 / K_B
    t_ir = 367.0 * gamma_bulk

    e, e_edge = energy_grid(n_bins, e0_kev)
    f_disk = _bb_shape(e_edge, t_disk, L_disk_norm)
    f_blr = _bb_shape(e_edge, t_blr, L_ext_norm)
    f_ir = _bb_shape(e_edge, t_ir, L_ext_norm)

    if tavecchio_table is not None:
        if isinstance(tavecchio_table, str):
            tavecchio_table = read_tavecchio_table(tavecchio_table)
        f_bblr = beamed_blr(e, gamma_bulk, tavecchio_table)
    else:
        f_bblr = f_blr.copy()

    thermal = e <= pl_e_min
    if pl_tail and not thermal.all():
        # disk.f:57-67: beyond E_min the reference reuses the *stale*
        # Utherm values (the last thermal bin's) times the power law;
        # the IR tail line multiplies an uninitialized Unth_ir and in
        # practice (static zero init) is 0
        i_last = int(np.max(np.nonzero(thermal)[0]))
        y = e / pl_e_max
        tail = np.where(
            y < 100.0,
            (e / pl_e_min) ** (-pl_index) * np.exp(-np.minimum(y, 100.0)),
            0.0,
        )
        f_disk = np.where(thermal, f_disk, f_disk[i_last] * tail)
        f_blr = np.where(thermal, f_blr, f_blr[i_last] * tail)
        f_ir = np.where(thermal, f_ir, 0.0)

    out = np.stack(
        [
            e,
            np.maximum(f_disk, 1e-30),
            np.maximum(f_bblr, 1e-30),
            np.maximum(f_ir, 1e-30),
            np.maximum(f_blr, 1e-30),
        ],
        axis=1,
    )
    return out


def write_spectrum_file(path: str, gamma_bulk: float, **kw):
    table = generate(gamma_bulk, **kw)
    np.savetxt(path, table, fmt="%14.6e")
    return table
