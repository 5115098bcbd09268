"""Per-zone volume emissivities, opacities and emission CDFs
(counterpart of ``compton2d_tpu.physics.emissivity``).

The host numpy fits (``expk13``, ``expk43``, ``sync_kernel``) are copies
of the reference's; ``volume_em`` evaluates the closed-form synchrotron
kernel on the device batched as (zones, n_vol, num_nt), in chunks of
zones that keep each such intermediate at or below ZONE_CHUNK_ELEMS
elements (a 99x99 grid at 400 x 200 bins would need 3.1 GB per
intermediate at once), in float32 with the reference's unit scaling
(lengths /L, energies /E, frequencies folded by 1e21 Hz).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c2dref import constants as cn
from c2dref.units import Scales

_SIGMA_T = 6.6524616e-25
_E_CHARGE = 4.803e-10
_E_MASS = 9.109e-28
_NU_FOLD = 1.0e21
# elements of one (zones, n_vol, num_nt) intermediate of volume_em (and of
# fp.update.zone_contract's (zones, N, K) product)
ZONE_CHUNK_ELEMS = 1 << 25


def expk13(t: np.ndarray) -> np.ndarray:
    """exp(t) * K_{1/3}(t) (volume2d.f:672-714). Host numpy."""
    c1, c2 = 0.35502805, 0.25881940
    ts = np.maximum(np.asarray(t, np.float64), 1e-30)
    z3 = 1.5 * ts
    zs = z3 ** (1.0 / 3.0)
    z = zs * zs
    z32 = z3 * z3
    f1 = 1.0 + z32 / 6.0 * (1.0 + z32 / 30.0 * (1.0 + z32 / 56.0))
    f2 = z * (1.0 + z32 / 12.0 * (1.0 + z32 / 42.0 * (1.0 + z32 / 90.0)))
    small = np.exp(np.minimum(ts, 1.0)) * np.pi * 1.7320508 / zs * (
        c1 * f1 - c2 * f2
    )
    zl = 1.0 / (72.0 * ts)
    poly = 1.0 - 5.0 * zl * (1.0 - 38.5 * zl)
    large = np.sqrt(0.5 * np.pi / ts) * poly / (
        1.0 + 1.0 / (1.0 + 58.0 * ts * ts)
    )
    return np.where(ts <= 1.0, small, large)


def expk43(t: np.ndarray) -> np.ndarray:
    """exp(t) * K_{4/3}(t) (volume2d.f:718-746). Host numpy."""
    ts = np.maximum(np.asarray(t, np.float64), 1e-30)
    poly_s = 1.0 + ts * (0.9757317 - 7.6790616e-2 * ts)
    small = 0.44648975 * (2.0 / ts) ** (4.0 / 3.0) * poly_s
    zl = 1.0 / (72.0 * ts)
    poly_l = 1.0 + 55.0 * zl * (1.0 - 8.5 * zl)
    large = np.sqrt(0.5 * np.pi / ts) * poly_l * (
        1.0 + 1.0 / (1.0 + 50.0 * ts * ts)
    )
    return np.where(ts <= 1.0, small, large)


def sync_kernel(t: np.ndarray) -> np.ndarray:
    """Angle-averaged single-electron synchrotron spectral shape
    (volume2d.f:206-216). Host numpy."""
    t = np.asarray(t, np.float64)
    e43 = expk43(t)
    e13 = expk13(t)
    ff = t * t * (e43 * e13 - 0.6 * t * (e43 - e13) * (e43 + e13))
    return np.where(t < 1.0e4, ff * np.exp(-2.0 * np.minimum(t, 700.0)), 0.0)


class SyncKernelTable(NamedTuple):
    """Log-spaced f32 table of sync_kernel (kept for Tables parity; the
    hot path evaluates the closed-form fits)."""

    log_t: torch.Tensor
    val: torch.Tensor

    @classmethod
    def build(cls, t_min=1e-12, t_max=2e4, n=2048,
              device="cpu") -> "SyncKernelTable":
        lt = np.linspace(np.log(t_min), np.log(t_max), n)
        return cls(
            log_t=torch.as_tensor(lt.astype(np.float32), device=device),
            val=torch.as_tensor(
                sync_kernel(np.exp(lt)).astype(np.float32), device=device
            ),
        )


def _expk13_f32(ts):
    """Device exp(t) K_{1/3}(t), same fit as :func:`expk13`; ts >= 1e-12."""
    c1, c2 = 0.35502805, 0.25881940
    z3 = 1.5 * ts
    zs = torch.pow(z3, 1.0 / 3.0)
    z = zs * zs
    z32 = z3 * z3
    f1 = 1.0 + z32 / 6.0 * (1.0 + z32 / 30.0 * (1.0 + z32 / 56.0))
    f2 = z * (1.0 + z32 / 12.0 * (1.0 + z32 / 42.0 * (1.0 + z32 / 90.0)))
    small = torch.exp(torch.clamp_max(ts, 1.0)) * (np.pi * 1.7320508) / zs * (
        c1 * f1 - c2 * f2
    )
    zl = 1.0 / (72.0 * ts)
    poly = 1.0 - 5.0 * zl * (1.0 - 38.5 * zl)
    large = torch.sqrt(0.5 * np.pi / ts) * poly / (
        1.0 + 1.0 / (1.0 + 58.0 * ts * ts)
    )
    return torch.where(ts <= 1.0, small, large)


def _expk43_f32(ts):
    """Device exp(t) K_{4/3}(t) (volume2d.f:718-746)."""
    poly_s = 1.0 + ts * (0.9757317 - 7.6790616e-2 * ts)
    small = 0.44648975 * torch.pow(2.0 / ts, 4.0 / 3.0) * poly_s
    zl = 1.0 / (72.0 * ts)
    poly_l = 1.0 + 55.0 * zl * (1.0 - 8.5 * zl)
    large = torch.sqrt(0.5 * np.pi / ts) * poly_l * (
        1.0 + 1.0 / (1.0 + 50.0 * ts * ts)
    )
    return torch.where(ts <= 1.0, small, large)


def sync_kernel_f32(t):
    """Device closed-form synchrotron spectral shape."""
    ts = torch.clamp(t, 1e-12, 2.0e4)
    e43 = _expk43_f32(ts)
    e13 = _expk13_f32(ts)
    ff = ts * ts * (e43 * e13 - 0.6 * ts * (e43 - e13) * (e43 + e13))
    return torch.where(
        t < 1.0e4, ff * torch.exp(-2.0 * torch.clamp_max(ts, 60.0)), 0.0
    )


def equipartition_b(ep_switch, tea, tna, n_e, f_pair, B_field,
                    gamma_bar_fwd):
    """B from electron (ep_switch=1) or proton (=2) thermal energy
    density equipartition (imcgen2d.f:216-236)."""

    def u_of(th):
        small = 1.5 * th + 7.5 * th * th
        large = gamma_bar_fwd(torch.clamp_min(th, 1e-6)) - 1.0
        return torch.where(th < 1e-2, small, large)

    th_e = cn.KEV_TO_MEC2 * tea
    ub_e = u_of(th_e) * n_e * cn.MEC2_ERG * (1.0 + 2.0 * f_pair)
    th_p = 1.066e-6 * tna
    ub_p = u_of(th_p) * n_e * 1.5e-3
    b1 = torch.sqrt(25.13 * ub_e)
    b2 = torch.sqrt(25.13 * ub_p)
    return torch.where(
        ep_switch == 1, b1, torch.where(ep_switch == 2, b2, B_field)
    )


class VolumeEmission(NamedTuple):
    """Per-zone, per-step emission tables, shapes (nz, nr, ...)."""

    kappa_tot: torch.Tensor   # (nz, nr, n_vol) [1/L] synchrotron s.a.
    eps_tot: torch.Tensor     # (nz, nr, n_vol) MC emission CDF
    eps_th: torch.Tensor      # (nz, nr, n_vol) thick thermal CDF
    eloss_sy: torch.Tensor    # (nz, nr) [E] per step
    eloss_th: torch.Tensor
    eloss_br: torch.Tensor
    eloss_pa: torch.Tensor
    eloss_tot: torch.Tensor   # = eloss_sy, the active budget


def normalized_cdf(p: torch.Tensor) -> torch.Tensor:
    """Rows of running sums ``p`` (Z, n) divided by their totals. A zone
    whose emission falls below the e_ph grid (total 0) collapses to a step
    at bin 0 (the reference's degenerate-spectrum guard); any positive
    total normalizes its row, subnormal ones included, where the reference
    divides by at least 1e-37 and leaves such a row's CDF short of 1 (its
    emission then lands in the top bin)."""
    total = p[:, -1:]
    pos = total > 0.0
    return torch.where(pos, p / torch.where(pos, total, 1.0), 1.0)


def volume_em(e_ph, gnt, f_nt, tea, n_e, B, amxwl, vol, zsurf, l_min, dt,
              scales: Scales, f_pair=None) -> VolumeEmission:
    """All zones at once (volume2d.f:10-390 + imcgen2d.f:276-335)."""
    nz, nr, num_nt = f_nt.shape
    n_vol = e_ph.shape[0]
    Z = nz * nr
    f32 = torch.float32
    gamma = (gnt + 1.0).to(f32)
    gamp = gamma * torch.sqrt(torch.clamp_min(gamma * gamma - 1.0, 1e-20))
    dg = torch.diff(gnt)
    wdg = torch.cat([dg, dg[-1:] * 0.0]).to(f32)
    nu21 = (2.41487e17 / _NU_FOLD * e_ph).to(f32)
    de_ratio = e_ph[1] / e_ph[0]
    bin_w = (e_ph * (de_ratio - 1.0)).to(f32)

    k_eloss_sy = 1.058e-15 * scales.L3 / scales.E
    k_eloss_th = scales.L2 / scales.E
    k_eloss_br = 5.34e-24 * scales.L3 / scales.E
    k_kappa_c = 6.65e-25 * scales.L
    k_jth = 1.47e-47 * _NU_FOLD**3
    k_kap_sy = 1.0 / (8.0 * np.pi * _E_MASS * _NU_FOLD**2)
    kap_L = scales.L

    if f_pair is None:
        f_pair = torch.zeros_like(tea)
    f = f_nt.reshape(Z, num_nt).to(f32)
    tea_z = tea.reshape(Z, 1).to(f32)
    nez = n_e.reshape(Z, 1).to(f32)
    Bz = torch.clamp_min(B.reshape(Z, 1).to(f32), 1e-20)
    volz = vol.reshape(Z, 1).to(f32)
    zsurfz = zsurf.reshape(Z, 1).to(f32)
    l_minz = l_min.reshape(Z, 1).to(f32)
    amxz = amxwl.reshape(Z, 1).to(f32)
    fp = f_pair.reshape(Z, 1).to(f32)
    dt32 = torch.as_tensor(dt, dtype=f32, device=f.device)

    nu_b = _E_CHARGE * Bz / (2.0 * np.pi * _E_MASS * cn.C_LIGHT)
    ub = Bz * Bz / (8.0 * np.pi)
    face = 3.0**1.5 * _SIGMA_T * cn.C_LIGHT * ub / (np.pi * nu_b)   # (Z, 1)
    nu_p21 = 9.0e3 / _NU_FOLD * torch.sqrt(nez)

    dfg = f / gamp
    slope = torch.cat([dfg[:, :-1] - dfg[:, 1:], dfg[:, -1:] * 0.0], dim=1)
    fw, sg = f * wdg, slope * gamp
    chunk = max(1, ZONE_CHUNK_ELEMS // (n_vol * num_nt))
    j_parts, k_parts = [], []
    for z0 in range(0, Z, chunk):
        zs = slice(z0, z0 + chunk)
        # t(nu, gamma) = nu / (3 gamma^2 nu_b), (chunk, n_vol, num_nt)
        t = nu21[None, :, None] / (
            3.0 * (gamma * gamma)[None, None, :]
            * (nu_b[zs] / _NU_FOLD)[:, :, None]
        )
        es = face[zs, :, None] * sync_kernel_f32(t)
        # products summed over gamma: a zone's sums do not depend on the
        # number of zones beside it (a batched matmul picks its kernel by
        # the shape), so the zone farm's slices equal the whole grid
        j_parts.append(torch.sum(es * fw[zs, None, :], dim=-1))
        k_parts.append(torch.sum(es * sg[zs, None, :], dim=-1))
    j_sy = torch.cat(j_parts) * nez / (4.0 * np.pi)
    kap_sy = torch.cat(k_parts) * nez * k_kap_sy / (nu21 * nu21)
    kap_sy = torch.abs(kap_sy)
    below_plasma = nu21 <= nu_p21
    j_sy = torch.where(below_plasma, 0.0, j_sy)
    kap_sy = torch.where(below_plasma, 0.0, kap_sy)

    kappa_tot = kap_sy * kap_L
    kappa_C = k_kappa_c * nez
    thin = kappa_tot < torch.maximum(1.0 / l_minz, 10.0 * kappa_C)

    x = e_ph.to(f32) / torch.clamp_min(tea_z, 1e-10)
    j_th = torch.where(
        x < 90.0,
        k_jth * (nu21 * nu21 * nu21)
        / torch.expm1(torch.clamp_max(x, 90.0) + 1e-12),
        0.0,
    )
    tau = torch.clamp_max(kappa_tot * l_minz, 50.0)
    j_th = j_th * -torch.expm1(-tau)

    w_tot = torch.where(thin, j_sy, 0.0) * bin_w
    w_th = torch.where(~thin, j_th, 0.0) * bin_w
    p_tot = torch.cumsum(w_tot, dim=1)
    p_th = torch.cumsum(w_th, dim=1)
    eps_tot = normalized_cdf(p_tot)
    eps_th = normalized_cdf(p_th)

    sum_g2m1 = torch.sum((gamma * gamma - 1.0) * f * wdg, dim=1)
    nez1, Bz1, volz1, tea1 = nez[:, 0], Bz[:, 0], volz[:, 0], tea_z[:, 0]
    eloss_sy = (k_eloss_sy * dt32) * nez1 * (Bz1 * Bz1) * sum_g2m1 * volz1
    eloss_th = (k_eloss_th * dt32) * zsurfz[:, 0] * p_th[:, -1]
    th_e = cn.KEV_TO_MEC2 * tea1
    f_rel = 1.41 * torch.sqrt(th_e) * (torch.log(2.0 * th_e) + 0.9228) - 1.0
    f_rel = torch.clamp_min(1.0 + th_e * th_e * f_rel / (1.0 + th_e * th_e),
                            1.0)
    eloss_br = (
        (k_eloss_br * dt32) * volz1 * amxz[:, 0]
        * torch.sqrt(tea1) * f_rel * nez1 * nez1
    )
    fp1 = fp[:, 0]
    eloss_pa = (
        (1.223e-20 * scales.L3 / scales.E * dt32) * volz1
        * fp1 * (1.0 + fp1) * nez1 * nez1
        / (1.0 / (1.0 + 6.0 * th_e)
           + th_e / (torch.log(1.123 * th_e + 1.0) + 0.25))
    )
    sh = (nz, nr)
    eloss_sy = eloss_sy.reshape(sh)
    return VolumeEmission(
        kappa_tot=kappa_tot.reshape(nz, nr, n_vol),
        eps_tot=eps_tot.reshape(nz, nr, n_vol),
        eps_th=eps_th.reshape(nz, nr, n_vol),
        eloss_sy=eloss_sy,
        eloss_th=eloss_th.reshape(sh),
        eloss_br=eloss_br.reshape(sh),
        eloss_pa=eloss_pa.reshape(sh),
        eloss_tot=eloss_sy,
    )
