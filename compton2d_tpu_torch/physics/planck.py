"""Planck photon-energy sampler (counterpart of
``compton2d_tpu.physics.planck``): Canfield's x = -ln(u1 u2 u3 u4) T / m
with the harmonic index m drawn with probability 1/m^4 / zeta(4)
(planck2d.f:37-65). The uniforms are arguments, drawn by
:func:`draw_planck_uniforms`, so tests can feed the reference's numbers.
"""
from __future__ import annotations

import numpy as np
import torch

_ZETA4 = float(np.pi**4 / 90.0)
_M_MAX = 64
# the harmonic index's CDF, unnormalised: SourceStatic.planck_cdf
CDF_M = np.cumsum(1.0 / np.arange(1, _M_MAX + 1, dtype=np.float64) ** 4)


def draw_planck_uniforms(gen: torch.Generator, n: int, device):
    """(u4 (n, 4) in [1e-12, 1), rn (n,) in [0, 1))."""
    u4 = torch.rand((n, 4), generator=gen, device=device)
    u4 = 1e-12 + u4 * (1.0 - 1e-12)
    rn = torch.rand((n,), generator=gen, device=device)
    return u4, rn


def sample_planck(u4: torch.Tensor, rn: torch.Tensor, T_keV: torch.Tensor,
                  cdf: torch.Tensor) -> torch.Tensor:
    """Planck-distributed energies [keV] at temperatures ``T_keV``;
    ``cdf`` is CDF_M in float32 on their device."""
    ap0 = -torch.sum(torch.log(u4), dim=-1)
    # count(cdf < rn * zeta4): cdf is strictly increasing
    m = torch.searchsorted(cdf, (rn * _ZETA4).contiguous()) + 1
    inv_m = 1.0 / m.to(torch.float32)
    return (ap0 * inv_m) * T_keV.to(torch.float32)
