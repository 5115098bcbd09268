"""Static physics tables, assembled once at setup (counterpart of
``compton2d_tpu.tables``).

Every table is built host-side in float64 numpy — with the reference's
own jax-free builders (``physics.icloss``, ``physics.reflection``) or
copies of them — and stored as float32 tensors on the simulation's
device. ``sigma_e`` is pre-multiplied by the length scale so the
per-zone opacity contraction yields 1/L.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c2dref import constants as cn
from c2dref.config import GridConfig
from c2dref.physics import icloss, pairs, reflection
from c2dref.physics import compton
from c2dref.physics.electron_dist import GammaBarTable, gnt_grid
from c2dref.physics.emissivity import SyncKernelTable


class Tables(NamedTuple):
    gnt: torch.Tensor        # (num_nt,) electron gamma-1 grid
    e_ph: torch.Tensor       # (n_vol,) emissivity/opacity grid [keV]
    e_field: torch.Tensor    # (nphfield,) radiation-field grid [keV]
    e_gg: torch.Tensor       # (n_gg,) gamma-gamma grid [keV]
    e_ref: torch.Tensor      # (n_ref,) reflection grid [keV]
    hu: torch.Tensor         # (nphtotal+1,) spectral output edges [keV]
    mu_edges: torch.Tensor   # (nmu,) angular bin upper edges
    lc_lo: torch.Tensor      # (nph_lc,)
    lc_hi: torch.Tensor      # (nph_lc,)
    sigma_e: torch.Tensor    # (n_vol, num_nt) KN sigma_E * L
    f_ic: torch.Tensor       # (num_nt, nphfield) IC loss kernel
    p_ref: torch.Tensor      # (n_ref, n_ref)
    w_abs: torch.Tensor      # (n_ref, n_ref)
    sync: SyncKernelTable
    gamma_bar: GammaBarTable

    @property
    def e_ph_log0(self):
        return torch.log(self.e_ph[0])

    @property
    def e_ph_dlog(self):
        return torch.log(self.e_ph[1] / self.e_ph[0])

    @property
    def e_gg_log0(self):
        return torch.log(self.e_gg[0])

    @property
    def e_gg_dlog(self):
        return torch.log(self.e_gg[1] / self.e_gg[0])


def e_field_grid(n: int = cn.NPHFIELD) -> np.ndarray:
    """Log grid: 20 decades from 1e-10 keV (setup2d.f:216-222)."""
    de = np.exp(np.log(10.0**cn.EFIELD_DECADES) / n)
    return cn.EFIELD_MIN_KEV * de ** np.arange(n)


def e_gg_grid(n: int = cn.N_GG) -> np.ndarray:
    """Log grid: factor 100 from 50 keV (setup2d.f:199-209)."""
    de = np.exp(np.log(cn.EGG_SPAN) / n)
    return cn.EGG_MIN_KEV * de ** np.arange(n)


class PairTables(NamedTuple):
    """Static pair-physics kernels (built only when pair_switch is on;
    see ``physics.pairs``)."""

    kgg_mat: torch.Tensor    # (n_gg, n_gg) opacity matrix [cm^3 keV / L]
    pp_tensor: torch.Tensor  # (num_nt, n_gg, n_gg) pair-production kernel
    vsigma: torch.Tensor     # (num_nt, num_nt) annihilation <sigma v>


def build_pair_tables(grid_cfg: GridConfig, length_scale: float = 1.0,
                      device="cpu") -> PairTables:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    e_gg = e_gg_grid(grid_cfg.n_gg)
    gnt = gnt_grid(grid_cfg.num_nt)
    return PairTables(
        kgg_mat=t(pairs.kgg_matrix(e_gg, length_scale)),
        pp_tensor=t(pairs.pairprod_tensor(gnt, e_gg)),
        vsigma=t(pairs.vsigma_matrix(gnt)),
    )


def build_tables(grid_cfg: GridConfig, length_scale: float = 1.0,
                 device="cpu") -> Tables:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # f32 grids as the reference stores them; the f64 builders below see
    # the f32-rounded grids exactly as the reference's do
    gnt = np.asarray(gnt_grid(grid_cfg.num_nt), np.float32)
    e_ph = np.asarray(e_field_grid(grid_cfg.n_vol), np.float32)
    e_field = np.asarray(e_field_grid(grid_cfg.nphfield), np.float32)
    lc = np.asarray(grid_cfg.lc_bands, dtype=np.float64).reshape(-1, 2)
    return Tables(
        gnt=t(gnt),
        e_ph=t(e_ph),
        e_field=t(e_field),
        e_gg=t(e_gg_grid(grid_cfg.n_gg)),
        e_ref=t(reflection.e_ref_grid(grid_cfg.n_ref)),
        hu=t(grid_cfg.spectral_edges()),
        mu_edges=t(grid_cfg.mu_edges()),
        lc_lo=t(lc[:, 0]),
        lc_hi=t(lc[:, 1]),
        sigma_e=t(compton.sigma_e_table(e_ph, gnt) * float(length_scale)),
        f_ic=t(icloss.fic_table(gnt, e_field)),
        p_ref=t(reflection.pref_matrix(grid_cfg.n_ref)),
        w_abs=t(reflection.wabs_matrix(grid_cfg.n_ref)),
        sync=SyncKernelTable.build(device=device),
        gamma_bar=GammaBarTable.build(device=device),
    )
