"""Photon sourcing: per-step energy budget and emission sampling
(counterpart of ``compton2d_tpu.transport.sourcing``).

Source categories are laid out as ``[volume zones (nz*nr) | lower rings
(nr) | upper rings (nr) | inner rows (nz) | outer rows (nz)]``. The
samplers take their uniforms as arguments; :func:`draw_emit_uniforms` is
the thin draw layer the driver uses, and tests feed the reference's own
numbers through the same arguments.

File-spectrum boundaries (tbb < 0) draw their energies from the spectrum
bank by an exact inverse CDF (:func:`sample_file_spectrum`), where the
reference lerps a 4096-knot quantile table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch.physics.planck import (
    draw_planck_uniforms,
    sample_planck,
)
from compton2d_tpu_torch.state import PhotonArray

# slots per chunk of the inverse-CDF compare-count in emit: bounds the
# (chunk, n_vol) gathered CDF rows to ~50 MB at n_vol = 400
_EMIT_CHUNK = 1 << 15


class SourceBudget(NamedTuple):
    counts: torch.Tensor      # (C,) int32 photons per category
    cum_counts: torch.Tensor  # (C,) inclusive cumulative counts
    weights: torch.Tensor     # (C,) f32 energy weight
    n_new: torch.Tensor       # () int32
    erin_lower: torch.Tensor
    erin_upper: torch.Tensor
    erin_inner: torch.Tensor
    erin_outer: torch.Tensor
    bingo: torch.Tensor       # () fresh energy input + census


class SourceStatic(NamedTuple):
    """Per-window boundary data (fields as in the reference)."""

    tbb_lower: torch.Tensor
    tbb_upper: torch.Tensor
    tbb_inner: torch.Tensor
    tbb_outer: torch.Tensor
    # the spectrum bank: one row per distinct spectrum file, row 0 the
    # dummy "no file" row; each tbb < 0 ring indexes its row
    spec_e: torch.Tensor      # (n_spec, nf) energies [keV]
    spec_cdf: torch.Tensor    # (n_spec, nf) sampling CDF
    spec_lower: torch.Tensor
    spec_upper: torch.Tensor
    flux_lower: torch.Tensor
    flux_upper: torch.Tensor
    star_dilution: torch.Tensor
    # planck.CDF_M in float32 on the device (the reference's constant)
    planck_cdf: torch.Tensor


class EmitUniforms(NamedTuple):
    """The random numbers one ``emit`` consumes."""

    u: torch.Tensor          # (12, n) in [1e-7, 1); row 9 is unused,
                             # row 10 draws file-spectrum energies
    planck_u4: torch.Tensor  # (n, 4) in [1e-12, 1)
    planck_rn: torch.Tensor  # (n,) in [0, 1)


def draw_emit_uniforms(gen: torch.Generator, n: int, device) -> EmitUniforms:
    u = torch.rand((12, n), generator=gen, device=device)
    u = 1e-7 + u * (1.0 - 1e-7)
    u4, rn = draw_planck_uniforms(gen, n, device)
    return EmitUniforms(u=u, planck_u4=u4, planck_rn=rn)


def sample_file_spectrum(u, sid, spec_e, spec_cdf):
    """Energies of file-spectrum photons (file_sample,
    imcsurf2d_para.f:694-788): in bank row ``sid`` the bin j is the first
    whose CDF reaches ``u``, and log e is linear in u inside it."""
    sid = sid.long()
    nf = spec_e.shape[1]
    u = u.contiguous()
    j = torch.zeros_like(sid)
    for row in range(1, spec_e.shape[0]):
        j = torch.where(sid == row, torch.searchsorted(
            spec_cdf[row].contiguous(), u, side="left"), j)
    j = torch.clamp(j, 1, nf - 1)
    p_lo, p_hi = spec_cdf[sid, j - 1], spec_cdf[sid, j]
    log_e = torch.log(spec_e)
    le_lo, le_hi = log_e[sid, j - 1], log_e[sid, j]
    fr = torch.clamp((u - p_lo) / torch.clamp_min(p_hi - p_lo, 1e-30),
                     0.0, 1.0)
    return torch.exp(le_lo + fr * (le_hi - le_lo))


def compute_budget(
    src: SourceStatic, fas, ecens, ed_abs,
    area_lower, area_upper, area_inner, area_outer,
    dt, dt_prev, nst: int, bias_cap: float, sigma_sb_scaled: float,
    dh_sentinel: bool = False, replicas: int = 1,
) -> SourceBudget:
    """Energy inputs and photon counts per source category
    (imcgen2d.f:125-193, 430-517). Under a photon mesh every rank runs
    this budget with its own ``nst`` (the global one over the ranks) and
    ``replicas`` = the number of ranks: the weights divide each
    category's energy by the global photon count, so the ranks' emission
    sums to the budget."""
    nz = area_inner.shape[0]
    f32 = torch.float32
    dt32 = torch.as_tensor(dt, dtype=f32, device=fas.device)

    def erin_of(tbb, area, flux=None, dilution=None):
        tbb = tbb.to(f32)
        t4 = torch.clamp_min(tbb, 0.0) ** 2
        bb = (dt32 * sigma_sb_scaled) * area.to(f32) * t4 * t4
        if dilution is not None:
            bb = bb * dilution.to(f32)
        if flux is None:
            file_in = torch.zeros_like(bb)
        else:
            file_in = dt32 * area.to(f32) * flux.to(f32)
        return torch.where(
            tbb > 0.0, bb, torch.where(tbb < 0.0, file_in, 0.0)
        )

    erin_l = erin_of(src.tbb_lower, area_lower, src.flux_lower)
    if dh_sentinel:
        erin_l = erin_l + torch.where(
            src.tbb_lower > 1e-20,
            ed_abs.to(f32) * dt32
            / torch.clamp_min(torch.as_tensor(dt_prev, dtype=f32), 1e-30),
            0.0,
        )
    erin_u = erin_of(src.tbb_upper, area_upper, src.flux_upper,
                     dilution=src.star_dilution)
    erin_i = erin_of(src.tbb_inner, area_inner)
    erin_o = erin_of(src.tbb_outer, area_outer)

    fas = fas.to(f32)
    emiss_tot = torch.clamp_min(torch.sum(fas), 1e-30)
    bingo = (
        torch.sum(ecens.to(f32)) + torch.sum(fas)
        + torch.sum(erin_i) + torch.sum(erin_o)
        + torch.sum(erin_l) + torch.sum(erin_u)
    )
    i32 = torch.int32
    area_frac_l = area_lower / torch.sum(area_lower)
    area_frac_u = area_upper / torch.sum(area_upper)
    n_l = torch.where(erin_l > 0.0, (nst * area_frac_l).to(i32), 0)
    n_u = torch.where(erin_u > 0.0, (nst * area_frac_u).to(i32), 0)
    n_i = torch.where(erin_i > 0.0, nst // nz, 0).to(i32)
    n_o = torch.where(erin_o > 0.0, nst // nz, 0).to(i32)
    n_v = (0.5 * nst * fas / emiss_tot).to(i32).reshape(-1)
    counts = torch.cat([n_v, n_l.to(i32), n_u.to(i32), n_i, n_o])
    n_new = torch.sum(counts, dtype=i32)
    fbias = torch.where(
        n_new > bias_cap * nst,
        bias_cap * nst / torch.clamp_min(n_new, 1).to(f32), 1.0,
    )
    counts = (counts * fbias).to(i32)
    n_new = torch.sum(counts, dtype=i32)
    energies = torch.cat([fas.reshape(-1), erin_l, erin_u, erin_i, erin_o])
    weights = torch.where(
        counts > 0,
        energies.to(f32) / torch.clamp_min(counts * replicas, 1),
        0.0,
    ).to(f32)
    return SourceBudget(
        counts=counts,
        cum_counts=torch.cumsum(counts, dim=0, dtype=i32),
        weights=weights,
        n_new=n_new,
        erin_lower=erin_l, erin_upper=erin_u,
        erin_inner=erin_i, erin_outer=erin_o,
        bingo=bingo,
    )


def emit(
    photons: PhotonArray, draws: EmitUniforms, budget: SourceBudget,
    src: SourceStatic, grid_r_edges, grid_z_edges, zone_surf,
    eps_tot, eps_th, eloss_th, eloss_tot, e_ph, dt, nz: int, nr: int,
    c_scaled: float = cn.C_LIGHT, beam_mu: float = 0.99999999,
):
    """Fill free slots with freshly emitted photons; returns (photons,
    e_lost) with the source energy lost to slot overflow."""
    n = photons.n_slots
    nzr = nz * nr
    f32, i32 = torch.float32, torch.int32
    u = draws.u
    pi = float(np.pi)
    where = torch.where

    free = ~photons.alive
    rank = torch.cumsum(free.to(i32), dim=0, dtype=i32) - 1
    is_new = free & (rank < budget.n_new)
    # category: count(cum_counts <= rank) (cum_counts is non-decreasing)
    cat = torch.searchsorted(budget.cum_counts, rank, right=True).to(i32)
    cat = torch.clamp(cat, 0, budget.cum_counts.shape[0] - 1)

    is_vol = cat < nzr
    c_l = cat - nzr
    is_low = (c_l >= 0) & (c_l < nr)
    c_u = c_l - nr
    is_up = (c_u >= 0) & (c_u < nr)
    c_i = c_u - nr
    is_in = (c_i >= 0) & (c_i < nz)
    c_o = c_i - nz
    is_out = (c_o >= 0) & (c_o < nz)

    jz_v = torch.clamp(torch.div(cat, nr, rounding_mode="floor"), 0, nz - 1)
    kr_v = torch.clamp(cat % nr, 0, nr - 1)
    kr_s = torch.clamp(where(is_low, c_l, c_u), 0, nr - 1)
    jz_s = torch.clamp(where(is_in, c_i, c_o), 0, nz - 1)
    jz = where(is_vol, jz_v, where(is_low, 0, where(is_up, nz - 1, jz_s)))
    kr = where(is_vol, kr_v, where(is_in, 0, where(is_out, nr - 1, kr_s)))
    jz, kr = jz.to(i32), kr.to(i32)

    re = grid_r_edges.to(f32)
    ze = grid_z_edges.to(f32)
    r_in, r_out = re[kr.long()], re[kr.long() + 1]
    z_bot, z_top = ze[jz.long()], ze[jz.long() + 1]

    # ---- positions ------------------------------------------------------
    r_ann = torch.sqrt(r_in * r_in + u[0] * (r_out * r_out - r_in * r_in))
    z_unif = z_bot + u[1] * (z_top - z_bot)
    cat_v = torch.clamp(cat, 0, nzr - 1).long()
    f_th = (eloss_th / torch.clamp_min(eloss_tot, 1e-30)).reshape(-1)[cat_v]
    thermal = is_vol & (u[2] < f_th)
    dz_z = z_top - z_bot
    a_in = 2.0 * pi * r_in * dz_z
    a_out = 2.0 * pi * r_out * dz_z
    a_ud = pi * (r_out * r_out - r_in * r_in)
    a_tot = a_in + a_out + 2.0 * a_ud
    c1 = a_in / a_tot
    c2 = c1 + a_out / a_tot
    c3 = c2 + a_ud / a_tot
    face = where(u[3] < c1, 0, where(u[3] < c2, 1, where(u[3] < c3, 2, 3)))

    # ---- directions -----------------------------------------------------
    mu_iso = 2.0 * u[4] - 1.0
    phi_full = 2.0 * pi * (u[5] - 0.5)
    phi_outw = pi * (u[5] - 0.5)
    phi_inw = pi * (u[5] - 0.5) + pi
    r_v = where(thermal & (face == 0), r_in * 1.00001,
                where(thermal & (face == 1), r_out * 0.999999, r_ann))
    z_v = where(thermal & (face == 2), z_top * 0.999999,
                where(thermal & (face == 3), z_bot + 1e-6 * dz_z, z_unif))
    mu_v = where(thermal & (face == 2), u[6],
                 where(thermal & (face == 3), -u[6], mu_iso))
    phi_v = where(thermal & (face == 0), phi_inw,
                  where(thermal & (face == 1), phi_outw, phi_full))

    kr_sl, jz_sl = kr_s.long(), jz_s.long()
    tbb_here = where(
        is_low, src.tbb_lower[kr_sl],
        where(is_up, src.tbb_upper[kr_sl],
              where(is_in, src.tbb_inner[jz_sl], src.tbb_outer[jz_sl])),
    ).to(f32)
    is_file = tbb_here < 0.0
    r_b = where(is_in, re[0], where(is_out, re[nr], r_ann))
    z_b = where(is_low, 0.0, where(is_up, ze[nz], z_unif))
    mu_low = where(is_file, beam_mu, u[6])
    mu_b = where(is_low, mu_low, where(is_up, -u[6], mu_iso))
    phi_b = where(is_in, phi_outw, where(is_out, phi_inw, phi_full))

    r_new = where(is_vol, r_v, r_b)
    z_new = where(is_vol, z_v, z_b)
    mu_new = torch.clamp(where(is_vol, mu_v, mu_b), -0.99999999, 0.99999999)
    phi_new = where(is_vol, phi_v, phi_b)

    # ---- energies: inverse CDF over eps_tot / eps_th --------------------
    n_vol = e_ph.shape[0]
    eps_stack = torch.cat(
        [eps_tot.reshape(nzr, -1), eps_th.reshape(nzr, -1)], dim=0
    ).to(f32)
    row_id = cat_v + where(thermal, nzr, 0)
    iv = torch.empty(n, dtype=torch.int64, device=u.device)
    for s in range(0, n, _EMIT_CHUNK):
        sl = slice(s, min(s + _EMIT_CHUNK, n))
        iv[sl] = torch.sum(eps_stack[row_id[sl]] < u[7][sl, None], dim=1)
    iv = torch.clamp(iv, 0, n_vol - 1)
    e_ph32 = e_ph.to(f32)
    log_e0 = torch.log(e_ph32[0])
    dlog_e = torch.log(e_ph32[1] / e_ph32[0])
    e_hi = torch.exp(log_e0 + iv.to(f32) * dlog_e)
    e_lo = torch.exp(log_e0 + torch.clamp_min(iv - 1, 0).to(f32) * dlog_e)
    e_v = e_lo + u[8] * (e_hi - e_lo)
    e_b = sample_planck(draws.planck_u4, draws.planck_rn,
                        torch.clamp_min(tbb_here, 1e-6), src.planck_cdf)
    if src.spec_e.shape[0] > 1:
        # a bank of the dummy row alone means no ring reads a file
        sid = where(is_low, src.spec_lower[kr_sl], src.spec_upper[kr_sl])
        e_b = where(is_file, sample_file_spectrum(
            u[10], sid, src.spec_e, src.spec_cdf), e_b)
    e_new = where(is_vol, e_v, e_b)

    w_new = budget.weights[cat.long()]
    dcen_new = (u[11] * float(np.float32(c_scaled))) * torch.as_tensor(
        dt, dtype=f32, device=u.device)

    n_free = torch.sum(free.to(i32), dtype=i32)
    unplaced = torch.minimum(
        torch.clamp_min(budget.cum_counts - n_free, 0), budget.counts
    )
    e_lost = torch.sum(unplaced * budget.weights)

    photons = photons._replace(
        e=where(is_new, e_new, photons.e),
        w=where(is_new, w_new, photons.w),
        w0=where(is_new, w_new, photons.w0),
        r=where(is_new, r_new, photons.r),
        z=where(is_new, z_new, photons.z),
        mu=where(is_new, mu_new, photons.mu),
        cphi=where(is_new, torch.cos(phi_new), photons.cphi),
        sphi=where(is_new, torch.sin(phi_new), photons.sphi),
        dcen=where(is_new, dcen_new, photons.dcen),
        jz=where(is_new, jz, photons.jz),
        kr=where(is_new, kr, photons.kr),
        alive=photons.alive | is_new,
    )
    return photons, e_lost
