"""Cylindrical (r, z) grid geometry (counterpart of ``compton2d_tpu.grid``).

Zone (j, k) spans ``z_edges[j] .. z_edges[j+1]`` x ``r_edges[k] ..
r_edges[k+1]``; axis 0 is z (``nz``), axis 1 is r (``nr``). The host
builds the geometry in float64 numpy and stores it as float32 tensors on
the simulation's device, as the JAX package stores it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c2dref.config import GridConfig


class Grid(NamedTuple):
    """Static geometry tensors (float32)."""

    z_edges: torch.Tensor     # (nz+1,)  z-plane positions, z_edges[0]=0
    r_edges: torch.Tensor     # (nr+1,)  r-shell radii, r_edges[0]=r_min
    vol: torch.Tensor         # (nz, nr) cell volumes [L^3]
    zone_surf: torch.Tensor   # (nz, nr) total cell surface [L^2]
    area_inner: torch.Tensor  # (nz,)
    area_outer: torch.Tensor  # (nz,)
    area_upper: torch.Tensor  # (nr,)
    area_lower: torch.Tensor  # (nr,)
    dz: torch.Tensor          # ()
    dr: torch.Tensor          # ()

    @property
    def nz(self) -> int:
        return self.vol.shape[0]

    @property
    def nr(self) -> int:
        return self.vol.shape[1]

    @property
    def r_min(self):
        return self.r_edges[0]

    @property
    def r_max(self):
        return self.r_edges[-1]

    @property
    def z_max(self):
        return self.z_edges[-1]


def make_grid(cfg: GridConfig, length_scale: float = 1.0,
              device="cpu") -> Grid:
    """Build the uniform grid; lengths are divided by ``length_scale``."""
    nz, nr = cfg.nz, cfg.nr
    L = float(length_scale)
    z_edges = np.linspace(0.0, cfg.z_max / L, nz + 1)
    r_edges = np.linspace(cfg.r_min / L, cfg.r_max / L, nr + 1)
    dz = z_edges[1:] - z_edges[:-1]
    r_lo, r_hi = r_edges[:-1], r_edges[1:]
    ring = np.pi * (r_hi**2 - r_lo**2)
    vol = dz[:, None] * ring[None, :]
    zone_surf = (
        2.0 * np.pi * (r_hi + r_lo)[None, :] * dz[:, None]
        + 2.0 * ring[None, :]
    )

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Grid(
        z_edges=t(z_edges),
        r_edges=t(r_edges),
        vol=t(vol),
        zone_surf=t(zone_surf),
        area_inner=t(2.0 * np.pi * cfg.r_min * dz),
        area_outer=t(2.0 * np.pi * cfg.r_max * dz),
        area_upper=t(ring),
        area_lower=t(ring),
        dz=t(dz[0]),
        dr=t(r_edges[1] - r_edges[0]),
    )


def initial_dt(grid: Grid, mcdt: float, inj_v: float,
               length_scale: float = 1.0) -> float:
    """dt = mcdt * min(r_max/nr, z_max/nz) / v (setup2d.f:50-51), with the
    float32 grid arithmetic of the reference."""
    dist = float(torch.minimum(grid.r_max / grid.nr, grid.z_max / grid.nz))
    return float(mcdt) * dist * float(length_scale) / float(inj_v)
