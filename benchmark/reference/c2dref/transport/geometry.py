"""Cylindrical (r, z) flight geometry over photon slots (counterpart of
``compton2d_tpu.transport.geometry``; imctrk2d.f:228-379, 467-484).

The azimuth is the unit vector (cphi, sphi) of the angle between the
horizontal velocity and the local outward radial direction, so the update
after a horizontal advance f is trig-free:
``cphi' = (f + cphi r) / r'``, ``sphi' = sphi r / r'``. The floors (1e-6,
1e-12, 1e-20) are normal float32 numbers, so the arithmetic is the same
whether or not denormals are flushed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_CLAMP = 0.99999999


class FlightGeom(NamedTuple):
    trldb: torch.Tensor   # distance to the nearest boundary [L]
    jnew: torch.Tensor    # int32 zone z-index after crossing
    knew: torch.Tensor    # int32 zone r-index after crossing
    rbnd: torch.Tensor    # radius at the boundary point
    zbnd: torch.Tensor    # height at the boundary point


def distance_to_boundary(r, z, mu, cphi, sphi, jz, kr, r_edges,
                         z_edges) -> FlightGeom:
    """imctrk2d.f:228-360 for every photon: the distance along the ray to
    the inner or outer r-shell or the z-plane it meets first, the zone it
    enters and the boundary point. ``jz``, ``kr`` are 0-based zone indices
    within the grid."""
    where = torch.where
    eta = torch.clamp(cphi, -_CLAMP, _CLAMP)
    mu_c = torch.clamp(mu, -_CLAMP, _CLAMP)
    sin_mu = torch.sqrt(1.0 - mu_c * mu_c)
    kr_l, jz_l = kr.long(), jz.long()
    r_in = r_edges[kr_l]
    r_out = r_edges[kr_l + 1]
    disp = eta * r
    psq = (r * sphi) ** 2          # r^2 (1 - eta^2), exact with (c, s)

    inward = (eta < 0.0) & (psq < r_in * r_in)
    inout = where(inward, -1.0, 1.0).to(r.dtype)
    rbnd_shell = where(inward, r_in, r_out)
    dpbsq = torch.clamp_min(rbnd_shell * rbnd_shell - psq, 1e-6)
    disbr = torch.clamp_min(inout * torch.sqrt(dpbsq) - disp, 0.0)
    trldb_r = disbr / torch.clamp_min(sin_mu, 1e-12)
    z_r = z + mu_c * trldb_r       # height at the shell crossing

    z_top = z_edges[jz_l + 1]
    z_bot = z_edges[jz_l]
    hits_top = z_r > z_top
    hits_bot = z_r < z_bot
    zbnd_z = where(hits_top, z_top, z_bot)
    f_z = torch.clamp_min(
        (zbnd_z - z) * sin_mu / where(torch.abs(mu_c) > 1e-12, mu_c, 1e-12),
        0.0)
    r_z = torch.sqrt(torch.clamp_min(r * r + f_z * f_z + 2.0 * r * f_z * eta,
                                     0.0))
    trldb_z = torch.sqrt(f_z * f_z + (zbnd_z - z) ** 2)

    hits_zplane = hits_top | hits_bot
    i32 = torch.int32
    return FlightGeom(
        trldb=where(hits_zplane, trldb_z, trldb_r),
        jnew=where(hits_top, jz + 1, where(hits_bot, jz - 1, jz)).to(i32),
        knew=where(hits_zplane, kr, kr + inout.to(i32)).to(i32),
        rbnd=where(hits_zplane, r_z, rbnd_shell),
        zbnd=where(hits_zplane, zbnd_z, z_r),
    )


def advance(r, z, mu, cphi, sphi, trld,
            rnew: Optional[torch.Tensor] = None,
            znew: Optional[torch.Tensor] = None):
    """Move a distance ``trld`` along the current direction: (r', z',
    cphi', sphi') (imctrk2d.f:372-377, 467-484). A move that ends on a
    known boundary passes ``rnew`` / ``znew`` to pin the boundary point."""
    mu_c = torch.clamp(mu, -_CLAMP, _CLAMP)
    f_h = trld * torch.sqrt(1.0 - mu_c * mu_c)
    if rnew is None:
        rnew = torch.sqrt(torch.clamp_min(f_h * f_h + r * r
                                          + 2.0 * f_h * r * cphi, 0.0))
    if znew is None:
        znew = z + trld * mu_c
    rs = torch.clamp_min(rnew, 1e-20)
    cphi_n = torch.clamp((f_h + cphi * r) / rs, -1.0, 1.0)
    sphi_n = torch.clamp(sphi * r / rs, -1.0, 1.0)
    nrm = torch.sqrt(torch.clamp_min(cphi_n ** 2 + sphi_n ** 2, 1e-12))
    return rnew, znew, cphi_n / nrm, sphi_n / nrm
