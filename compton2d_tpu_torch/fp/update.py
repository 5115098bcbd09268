"""Per-step electron update (counterpart of ``compton2d_tpu.fp.update``):
the Fokker-Planck solve of update2d.f vectorized over all zones.

IC drift from the tallied radiation field (a float32 contraction with
F_IC), synchrotron drift with the Razin-like suppression, hard-sphere
stochastic acceleration, injection and escape; under pair_switch the pair
sources and annihilation sinks on the electrons and the positrons, whose
distribution goes through the same Chang-Cooper operator; masked implicit
substeps (Chang-Cooper + PCR) with the geometric x1.25 floor backoff for
stiff zones, in a bounded loop whose condition is read on the host; the
temperature from <gamma> through the gamma_bar table; the dT_max -> dt
ladder and the effective nonthermal refit. Under fp_include_coulomb the
exact Moller and e-p Coulomb coefficients (``physics.coulomb`` tables,
or without tables the Spitzer-like e-p limits of ``_coulomb_drift``)
join the operator.

``photon_fill``: the reference's cycle-1 explicit thermal-rate table, a
diagnostic only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.config import PhysicsConfig
from compton2d_tpu_torch.units import Scales
from compton2d_tpu_torch.fp.chang_cooper import chang_cooper_coeffs, pcr_solve
from compton2d_tpu_torch.physics import electron_dist as ed
from compton2d_tpu_torch.physics.emissivity import ZONE_CHUNK_ELEMS
from compton2d_tpu_torch.state import ZoneState
from compton2d_tpu_torch.tables import Tables


def zone_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Z, K) rows of ``a`` against the (N, K) rows of ``b``: the (Z, N)
    sums over K, each added in an order that does not depend on Z (a
    product and a sum over the last axis; a BLAS matmul picks its kernel
    by the shape, so a zone's result would change with the number of
    zones beside it, and the zone farm's slices would differ from the
    whole grid). In chunks of zones whose (zones, N, K) product stays
    within ZONE_CHUNK_ELEMS elements, as ``volume_em``'s."""
    chunk = max(1, ZONE_CHUNK_ELEMS // (b.shape[0] * b.shape[1]))
    return torch.cat([torch.sum(a[z0:z0 + chunk, None, :] * b[None], dim=-1)
                      for z0 in range(0, a.shape[0], chunk)])


def _zero_last(t: torch.Tensor) -> None:
    """``t[-1] = 0``: on a card, a copy of the host's 0 that waits for the
    stream."""
    t[-1] = 0.0


class FPResult(NamedTuple):
    zones: ZoneState
    dt_new: torch.Tensor      # () adapted next step
    dT_max: torch.Tensor      # () max relative temperature change
    e_el_old: torch.Tensor    # () total electron energy before [E]
    e_el_new: torch.Tensor    # () after [E]
    substeps: torch.Tensor    # () int32 substeps used
    incomplete: torch.Tensor  # () int32 zones with t_fp < dt at the end


def fp_step(
    zones: ZoneState, n_field, tables: Tables, vol, z_max: float, dz, dt,
    time, eloss_sy, phys: PhysicsConfig, scales: Scales,
    eloss_br=None, dn_pp=None, dne_pa=None, dnp_pa=None, coulomb=None,
    j_row=None, slab_vol=None, zone_valid=None,
) -> FPResult:
    """All energies scaled by scales.E, volumes by scales.L^3. Under
    pair_switch, ``dn_pp`` (pair production), ``dne_pa`` and ``dnp_pa``
    (electron and positron annihilation), each (nz, nr, num_nt) in
    cm^-3 s^-1, act on the electrons and the positrons; all three are
    required then. Under ``phys.fp_include_coulomb`` the Coulomb terms
    come from ``coulomb`` (``physics.coulomb.CoulombTables``) when given,
    else from ``_coulomb_drift``. The solve runs in the precision of
    ``zones.f_nt``: float32 as the reference on every path; float64 zones
    (with the tables' gamma_bar in float64) are a precision check of the
    float32 solve.

    On a zone farm's slice (``parallel.mesh.zone_slice``: the rank's zones
    as a (Zs, 1) grid) three arguments keep each zone's solve what it is
    on the whole grid: ``j_row`` (nz, nr), the z-row of each zone (the
    shock front's timing; default its row here), ``slab_vol``, the volume
    of one z-slab of the whole grid (default sum(vol) / nz), and
    ``zone_valid`` (nz, nr) bool, False on pad zones, which gates their
    injection and keeps them out of the e_el sums and the incomplete
    count."""
    nz, nr, num_nt = zones.f_nt.shape
    Z = nz * nr
    f32, i32 = zones.f_nt.dtype, torch.int32
    dev = zones.f_nt.device
    gnt = tables.gnt.to(f32)
    gamma = gnt + 1.0
    dg = torch.diff(gnt)
    wdg = torch.cat([dg, dg[-1:] * 0.0])
    dt32 = torch.as_tensor(dt, dtype=f32, device=dev)
    time32 = torch.as_tensor(time, dtype=f32, device=dev)

    t_esc = phys.r_esc * z_max / cn.C_LIGHT
    t_acc = phys.r_acc * z_max / cn.C_LIGHT
    k_mec2_vol = scales.mec2_vol
    k_dgic = scales.nfield_to_dgic
    k_dT = 6.25e8 * scales.E / (1.5 * scales.L3)
    k_coul = 1.5 * 1.7386e-26 * scales.L3 / scales.E

    f_old = zones.f_nt.reshape(Z, num_nt).to(f32)
    sum_p = torch.clamp_min(
        torch.sum(f_old * wdg, dim=-1, keepdim=True), 1e-30)
    f_old = f_old / sum_p
    n_p = zones.n_e.reshape(Z).to(f32)
    f_pair = zones.f_pair.reshape(Z).to(f32)
    ne = n_p * (1.0 + f_pair)
    n_lept = ne + n_p * f_pair
    volume = vol.reshape(Z).to(f32)
    B = torch.clamp_min(zones.B_field.reshape(Z).to(f32), 1e-20)
    tea0 = zones.tea.reshape(Z).to(f32)
    tna = zones.tna.reshape(Z).to(f32)
    tlev = zones.turb_lev.reshape(Z).to(f32)

    valid = (torch.ones(Z, dtype=torch.bool, device=dev)
             if zone_valid is None else zone_valid.reshape(Z))

    def e_tot(f, nloc):
        return torch.where(valid, torch.sum(f * gamma * wdg, dim=-1) * (
            nloc * (k_mec2_vol * volume)), 0.0)

    e_el_old = torch.sum(e_tot(f_old, ne))

    nf = n_field.reshape(Z, -1).to(f32)
    dg_ic = -zone_contract(nf, tables.f_ic.to(f32)) * (k_dgic / volume[:, None])
    f_sy = 1.058e-15 * B * B / cn.MEC2_ERG
    dg_A = gamma[None, :] / t_acc
    disp_A = gamma[None, :] * gamma[None, :] / (2.0 * t_acc)
    dg_br = None
    if phys.fp_include_bremsstrahlung and eloss_br is not None:
        sum_g11 = torch.sum(gamma ** 1.1 * f_old * wdg, dim=-1)
        f_br = eloss_br.reshape(Z).to(f32) / torch.clamp_min(
            (k_mec2_vol * volume) * dt32 * n_lept * sum_g11, 1e-30)
        dg_br = -f_br[:, None] * gamma[None, :] ** 1.1

    th_p = tna / 9.382e5
    lnL = phys.lnL
    inj = phys.injection
    jrow_flat = (torch.arange(nz, dtype=f32, device=dev).repeat_interleave(nr)
                 if j_row is None else j_row.reshape(Z).to(f32))
    use_pairs = bool(phys.pair_switch)
    if use_pairs:
        if dn_pp is None or dne_pa is None or dnp_pa is None:
            raise ValueError(
                "fp_step: pair_switch needs dn_pp, dne_pa and dnp_pa")
        # the pair terms act on the interior bins only: the end bins are
        # the solve's boundary rows (x = d there, zeroed after the solve),
        # so a source there flows into its neighbour in proportion to the
        # drift coefficient without ever leaving the end bin, and creates
        # particles (a fault of the reference; ROADMAP C)
        interior = torch.ones(num_nt, dtype=f32, device=dev)
        interior[0] = interior[-1] = 0.0
        dn_pp_f = dn_pp.reshape(Z, num_nt).to(f32) * interior
        dne_pa_f = dne_pa.reshape(Z, num_nt).to(f32) * interior
        dnp_pa_f = dnp_pa.reshape(Z, num_nt).to(f32) * interior
    npos = zones.n_pos.reshape(Z, num_nt).to(f32)
    if slab_vol is None:
        slab_vol = torch.sum(volume) / nz
    eloss_sy_z = eloss_sy.reshape(Z).to(f32)

    def cool_heat_rates(f, th_e, te):
        g_av = tables.gamma_bar.forward(torch.clamp_min(th_e, 1e-6))
        gamma_R = 2.1e-3 * torch.sqrt(n_lept) / (B * torch.sqrt(g_av))
        hr_th_c = -torch.sum(dg_ic * f * wdg, dim=-1) * (
            (k_mec2_vol * volume) * n_lept)
        y = gamma_R / g_av
        hr_th_sy = torch.where(
            y < 90.0,
            -eloss_sy_z / (dt32 * torch.exp(torch.clamp_max(y, 90.0))),
            0.0,
        )
        tsum = th_e + th_p
        h_T = 0.79788 * (2.0 * (tsum * tsum) + 2.0 * tsum + 1.0) / (
            torch.clamp_min(tsum, 1e-12) ** 1.5
            * (1.0 + 1.875 * th_e + 0.8203 * (th_e * th_e))
        )
        hr_th_coul = (k_coul * n_p) * (volume * n_lept) * lnL * h_T * (
            tna - te)
        hr_th_A = torch.clamp_min(tlev * hr_th_coul, 1e-30)
        return hr_th_sy + hr_th_c + hr_th_A, gamma_R

    gauss_prof = torch.exp(
        -((gamma - inj.gauss_g) * (gamma - inj.gauss_g))
        / (2.0 * inj.gauss_sigma**2)
    )
    tm.read("fp.upload", gauss_prof, _zero_last)
    if phys.fp_include_coulomb and coulomb is not None:
        # the e-p rows depend on the (fixed) proton temperature only
        dg_cp_t, disp_cp_t = coulomb.proton_rows(tna)

    it = 0
    t_fp = torch.zeros(Z, dtype=f32, device=dev)
    f = f_old
    th_e = tea0 / cn.EMASS_KEV
    npz, nlept_z = n_p, n_lept
    grow = torch.ones(Z, dtype=f32, device=dev)
    done = torch.zeros(Z, dtype=torch.bool, device=dev)
    # bounded substep loop; the condition is read on the host
    while it < phys.fp_max_substeps and not tm.read(
            "fp.done", torch.all(done), bool):
        te = th_e * cn.EMASS_KEV
        hr_total, gamma_R = cool_heat_rates(f, th_e, te)
        dT_tot = (k_dT * dt32) * hr_total / torch.clamp_min(
            volume * n_lept, 1e-30)
        f_imp = torch.clamp(
            cn.DF_IMPLICIT * te / torch.clamp_min(torch.abs(dT_tot), 1e-30),
            0.0, cn.DF_T,
        )
        d_t = f_imp * dt32
        # stiff-zone floor, backing off x1.25 per floored substep
        floor = (1.001 * dt32 / phys.fp_max_substeps) * grow
        floored = d_t < floor
        d_t = torch.maximum(d_t, floor)
        grow = torch.where(floored & ~done, grow * 1.25, grow)
        last = d_t >= dt32 - t_fp
        d_t = torch.where(last, dt32 - t_fp, d_t)
        d_t = torch.clamp_min(d_t, 1e-30)

        # ---- pair sources/sinks (update2d.f:1185-1221) -------------------
        if use_pairs:
            dlt = d_t[:, None]
            f = torch.clamp_min(
                f + (dn_pp_f + dne_pa_f) * dlt
                / torch.clamp_min(ne, 1e-30)[:, None], 0.0)
            npos = torch.clamp_min(npos + (dn_pp_f + dnp_pa_f) * dlt, 0.0)

        # ---- injection (update2d.f:1229-1301) ---------------------------
        n_inject = torch.zeros(Z, dtype=f32, device=dev)
        f_inj = f
        if inj.pickup:
            psum = torch.clamp_min(torch.sum(gauss_prof * wdg), 1e-30)
            inj_rho = torch.where(valid, inj.pickup_rate * d_t, 0.0)
            f_inj = f_inj + (inj_rho[:, None] * gauss_prof[None, :] / psum
                             / torch.clamp_min(ne, 1e-30)[:, None])
            n_inject = n_inject + inj_rho
        if inj.switch != 0:
            if inj.distribution == 1:
                prof = gauss_prof[None, :].expand(Z, num_nt)
            else:
                if inj.g2var_switch:
                    ttz = (time32 + t_fp - inj.t_start).to(f32)
                    g2z = inj.g2 * torch.pow(10.0, torch.clamp(
                        ttz * float(np.float32(inj.v / z_max)), 0.0, 6.0))
                    yv = gamma[None, :] / g2z[:, None]
                else:
                    yv = (gamma[None, :] / inj.g2).expand(Z, num_nt)
                prof = torch.where(
                    (gamma[None, :] > inj.g1) & (yv < 100.0),
                    gamma[None, :] ** (-inj.p)
                    * torch.exp(-torch.clamp_max(yv, 100.0)),
                    0.0,
                )
                prof = prof.clone()
                prof[:, -1] = 0.0
            inj_sum = torch.clamp_min(
                torch.sum(prof * wdg[None, :], dim=-1, keepdim=True), 1e-30)
            inj_e_mean = torch.sum(
                prof * gamma[None, :] * wdg[None, :], dim=-1) / inj_sum[:, 0]
            t_row = dz * float(np.float32(scales.L)) / float(
                np.float32(inj.v))
            tt = time32 + t_fp - inj.t_start
            active = (tt > t_row * jrow_flat) & (tt < t_row * (jrow_flat + 1))
            lum_fold = float(inj.luminosity) / (8.186e-7 * scales.L3)
            inj_rate = lum_fold / torch.clamp_min(
                inj_e_mean * slab_vol, 1e-30)
            ok_inj = inj_sum[:, 0] > 1e-20
            inj_rho = torch.where(active & ok_inj & valid, inj_rate * d_t,
                                  0.0)
            f_inj = f_inj + (inj_rho[:, None] * prof / inj_sum
                             / torch.clamp_min(ne, 1e-30)[:, None])
            n_inject = n_inject + inj_rho
        npz = npz + n_inject
        nlept_z = nlept_z + n_inject

        # ---- escape (update2d.f:1309-1313) ------------------------------
        esc_fac = t_esc / (t_esc + d_t)
        npz = npz * esc_fac
        nlept_z = nlept_z * esc_fac

        # ---- operator (active terms, update2d.f:1048-1049) --------------
        y_sy = gamma_R[:, None] / gamma[None, :]
        dg_sy = torch.where(
            y_sy < 100.0,
            -f_sy[:, None] * (gamma[None, :] * gamma[None, :] - 1.0)
            / torch.exp(torch.clamp_max(y_sy, 100.0)),
            -1e-50,
        )
        dgdt = dg_sy + dg_ic + dg_A
        if dg_br is not None:
            dgdt = dgdt + dg_br
        disp = disp_A.expand(Z, num_nt)
        if phys.fp_include_coulomb:
            if coulomb is not None:
                # exact Moller/Coulomb tables (update2d.f:898-988) at this
                # substep's Te, on the lepton and proton densities after
                # injection and escape
                dg_ce_t, disp_ce_t = coulomb.electron_rows(te)
                dgdt = dgdt + dg_ce_t * nlept_z[:, None] \
                    + dg_cp_t * npz[:, None]
                disp = disp + disp_ce_t * nlept_z[:, None] \
                    + disp_cp_t * npz[:, None]
            else:
                dg_cp, disp_cp = _coulomb_drift(gamma, tna, npz, lnL)
                dgdt = dgdt + dg_cp
                disp = disp + disp_cp
        a, b, c = chang_cooper_coeffs(gnt, dgdt, disp, d_t, t_esc)
        f_new = pcr_solve(a, b, c, f_inj)
        f_new[..., 0] = 0.0
        f_new[..., -1] = 0.0
        if use_pairs:
            # positrons through the same operator (trid_p, update2d.f:1399,
            # 2524-2564)
            npos_new = pcr_solve(a, b, c, npos)
            npos_new[..., 0] = 0.0
            npos_new[..., -1] = 0.0
        s = torch.clamp_min(
            torch.sum(f_new * wdg, dim=-1, keepdim=True), 1e-30)
        f_new = f_new / s

        # ---- temperature from <gamma> (update2d.f:1440-1468) ------------
        gbar = torch.sum(gamma * f_new * wdg, dim=-1)
        th_new = tables.gamma_bar.inverse(gbar)

        upd = ~done
        f = torch.where(upd[:, None], f_new, f)
        if use_pairs:
            npos = torch.where(upd[:, None], npos_new, npos)
        th_e = torch.where(upd, th_new, th_e)
        t_fp = torch.where(upd, torch.where(last, dt32, t_fp + d_t), t_fp)
        done = t_fp >= dt32
        it += 1
    tm.count("fp.substeps", it)

    incomplete = torch.sum((valid & (t_fp < dt32)).to(i32), dtype=i32)
    te_new = torch.clamp(th_e * cn.EMASS_KEV, phys.temp_min, phys.temp_max)
    te_new = torch.where(tna > 1.0, te_new, tea0)
    dT = torch.abs(te_new - tea0) / torch.clamp_min(te_new, 1e-30)
    dT_max = torch.max(dT)
    np_fin = npz
    e_el_new = torch.sum(e_tot(f, np_fin * (1.0 + f_pair)))
    dt_new = torch.where(
        dT_max < 0.2 * cn.DF_T, 3.0 * dt32,
        torch.where(
            dT_max < 0.75 * cn.DF_T, 1.1 * dt32,
            torch.where(
                dT_max > 5.0 * cn.DF_T, 0.33 * dt32,
                torch.where(dT_max > 1.25 * cn.DF_T, 0.75 * dt32, dt32),
            ),
        ),
    )

    # ---- effective nonthermal parameters (update2d.f:1654-1736) ---------
    idx = torch.arange(num_nt, device=dev)
    interior = (idx >= 4) & (idx < num_nt - 5)
    above_lo = interior & (f > 1e-10)
    i_nt = torch.argmax(above_lo.to(i32), dim=-1)
    i_nt = torch.where(torch.any(above_lo, dim=-1), i_nt, 4)
    above_hi = interior & (f > 1e-15)
    i_hi = num_nt - 1 - torch.argmax(
        torch.flip(above_hi, dims=[-1]).to(i32), dim=-1)
    i_hi = torch.where(torch.any(above_hi, dim=-1), i_hi, num_nt - 6)
    gmin_eff = gamma[i_nt]
    gmax_eff = gamma[i_hi]
    below = idx[None, :] < i_nt[:, None]
    sum_th = torch.sum(torch.where(below, f * wdg, 0.0), dim=-1)
    sum_all = torch.clamp_min(torch.sum(f * wdg, dim=-1), 1e-30)
    amxwl_eff = torch.clamp(sum_th / sum_all, 0.0, 1.0)
    sum_e_mean = torch.sum(gamma * f * wdg, dim=-1) / sum_all
    p_cand = tm.read("fp.upload", np.arange(0.1, 10.01, 0.05,
                                            dtype=np.float32),
                     functools.partial(torch.as_tensor, device=dev,
                                       dtype=f32))
    nt_mask = (idx[None, :] >= i_nt[:, None]) & (idx < num_nt - 1)
    y_c = gamma[None, :] / gmax_eff[:, None]
    base = torch.where(nt_mask & (y_c < 90.0),
                       torch.exp(-torch.clamp_max(y_c, 90.0)) * wdg, 0.0)
    lg = torch.log(gamma)
    gp = torch.exp(-p_cand[:, None] * lg[None, :])
    denom_p = zone_contract(base, gp) + 1e-30
    numer_p = zone_contract(base * gamma[None, :], gp)
    miss = torch.abs(numer_p / denom_p - sum_e_mean[:, None])
    p_eff = p_cand[torch.argmin(miss, dim=-1)]
    pure_th = amxwl_eff > 0.9999
    gmin_eff = torch.where(pure_th, zones.gmin.reshape(Z), gmin_eff)
    gmax_eff = torch.where(pure_th, zones.gmax.reshape(Z), gmax_eff)
    p_eff = torch.where(pure_th, zones.p_nth.reshape(Z), p_eff)

    f_nt_new = f.reshape(nz, nr, num_nt)
    zones_new = zones._replace(
        tea=te_new.reshape(nz, nr),
        n_e=np_fin.reshape(nz, nr),
        f_nt=f_nt_new,
        cdf_nt=ed.build_cdf(f_nt_new, gnt),
        gmin=gmin_eff.reshape(nz, nr),
        gmax=gmax_eff.reshape(nz, nr),
        p_nth=p_eff.reshape(nz, nr),
        amxwl=torch.where(pure_th, 1.0, amxwl_eff).reshape(nz, nr),
    )
    if use_pairs:
        # positron census -> pair fraction (update2d.f:1215-1221)
        n_positron = torch.sum(npos * wdg, dim=-1)
        zones_new = zones_new._replace(
            n_pos=npos.reshape(nz, nr, num_nt),
            f_pair=torch.clamp_min(
                n_positron / torch.clamp_min(np_fin, 1e-30), 0.0
            ).reshape(nz, nr),
        )
    return FPResult(
        zones=zones_new, dt_new=dt_new, dT_max=dT_max, e_el_old=e_el_old,
        e_el_new=e_el_new,
        substeps=tm.read("fp.upload", it, functools.partial(
            torch.tensor, dtype=i32, device=dev)),
        incomplete=incomplete,
    )


class PhotonFillRates(NamedTuple):
    """Per-zone explicit thermal heating/cooling rates [erg/s per
    electron] + total [keV/s] (photon_fill, update2d.f:1747-1921)."""

    dT_coulp: torch.Tensor   # (nz, nr) proton-electron Coulomb
    dT_sy: torch.Tensor      # (nz, nr) synchrotron cooling
    dT_c: torch.Tensor       # (nz, nr) Compton (from n_field x F_IC)
    dT_br: torch.Tensor      # (nz, nr) bremsstrahlung cooling
    dT_A: torch.Tensor       # (nz, nr) hydromagnetic acceleration
    dT_total: torch.Tensor   # (nz, nr) [keV/s]
    d_t_opt: torch.Tensor    # (nz, nr) [s] df_T-limited step suggestion
    te_est: torch.Tensor     # (nz, nr) [keV] explicit Te estimate


def photon_fill(zones: ZoneState, n_field, tables: Tables, vol, dt,
                eloss_sy, eloss_br, phys: PhysicsConfig,
                scales: Scales) -> PhotonFillRates:
    """First-cycle explicit thermal-rate estimate (photon_fill,
    update2d.f:1747-1921): the reference computes it for ncycle <= 1
    before the FP farm, overwrites its Te_new with FP_calc's and leaves
    its dt adjustment commented out (update2d.f:1887,1914-1915), so it is
    a cycle-1 diagnostic: the per-channel rates it logs. Rates as in
    update2d.f:1850-1886; n_field (nz, nr, nphfield) is the scaled field
    tally, vol [L^3], eloss_* [E] per step."""
    nz, nr, num_nt = zones.f_nt.shape
    Z = nz * nr
    f32 = torch.float32
    gnt = tables.gnt.to(f32)
    dgw = torch.cat([torch.diff(gnt), gnt.new_zeros(1)])

    n_p = zones.n_e.reshape(Z).to(f32)
    tea = zones.tea.reshape(Z).to(f32)
    tna = zones.tna.reshape(Z).to(f32)
    tlev = zones.turb_lev.reshape(Z).to(f32)
    B = torch.clamp_min(zones.B_field.reshape(Z).to(f32), 1e-20)
    f_nt = zones.f_nt.reshape(Z, num_nt).to(f32)
    volume = vol.reshape(Z).to(f32)
    dt32 = torch.as_tensor(dt, dtype=f32, device=f_nt.device)

    th_p = tna / 9.382e5                       # update2d.f:1846
    th_e = tea / 5.11e2
    g_av = tables.gamma_bar.forward(torch.clamp_min(th_e, 1e-6))
    gamma_R = 2.1e-3 * torch.sqrt(n_p) / (B * torch.sqrt(g_av))

    tsum = th_e + th_p
    h_T = 0.79788 * (2.0 * (tsum * tsum) + 2.0 * tsum + 1.0) / (
        torch.clamp_min(tsum, 1e-12) ** 1.5
        * (1.0 + 1.875 * th_e + 0.8203 * (th_e * th_e))
    )
    dT_coulp = 2.608e-26 * n_p * phys.lnL * (tna - tea) * h_T

    # Eloss [scaled E] -> erg, vol [L^3] -> cm^3: the ratio E/L^3 folded
    # on the host (either factor alone can overflow f32)
    k_ul = float(np.float32(scales.E / scales.L3))
    y = gamma_R / g_av
    per_e = (eloss_sy.reshape(Z).to(f32) / volume * k_ul
             / (torch.clamp_min(n_p, 1e-30) * dt32))
    dT_sy = torch.where(
        y < 100.0,
        -(2.0 / 3.0) * per_e / torch.exp(torch.clamp_max(y, 100.0)),
        0.0,
    )
    dT_br = (-(2.0 / 3.0) * eloss_br.reshape(Z).to(f32) / volume * k_ul
             / (torch.clamp_min(n_p, 1e-30) * dt32))

    # dT_c from the same dg_ic contraction as FP_calc
    # (update2d.f:1864-1872)
    nf = n_field.reshape(Z, -1).to(f32)
    dg_ic = -torch.matmul(nf, tables.f_ic.to(f32).T) * (
        float(np.float32(scales.nfield_to_dgic)) / volume[:, None])
    dT_c = -(2.0 / 3.0) * float(np.float32(cn.MEC2_ERG)) * torch.sum(
        dg_ic * f_nt * dgw[None, :], dim=-1)

    dT_A = tlev * dT_coulp
    dT_total = (dT_coulp + dT_sy + dT_br + dT_c + dT_A) / 1.6e-9

    # zones without protons are skipped (update2d.f:1808-1809)
    skip = (n_p < 1e-11) | (tna < 1.0)
    dT_total = torch.where(skip, 0.0, dT_total)
    d_t_opt = cn.DF_T * tea / torch.clamp_min(torch.abs(dT_total), 1e-30)
    te_est = tea + dt32 * dT_total

    sh = (nz, nr)
    return PhotonFillRates(
        dT_coulp=dT_coulp.reshape(sh), dT_sy=dT_sy.reshape(sh),
        dT_c=dT_c.reshape(sh), dT_br=dT_br.reshape(sh),
        dT_A=dT_A.reshape(sh), dT_total=dT_total.reshape(sh),
        d_t_opt=d_t_opt.reshape(sh), te_est=te_est.reshape(sh),
    )


def _coulomb_drift(gamma, tna, n_p, lnL):
    """Electron-proton Coulomb drift + dispersion for fp_include_coulomb
    without tables (update2d.f:898-907, 979-988; the exact Intdgcp
    integrals approximated by their nonrelativistic Spitzer-like
    limits)."""
    th_p = tna / 9.382e5
    beta = torch.sqrt(torch.clamp_min(1.0 - 1.0 / (gamma * gamma), 1e-20))
    pref = 1.194e-14 * n_p[:, None] * lnL
    denom = (
        (1.0 + 1.875 * th_p + 0.8203 * (th_p * th_p))[:, None]
        * torch.sqrt(torch.clamp_min(th_p, 1e-12))[:, None]
        * (gamma * gamma)[None, :] * beta[None, :]
    )
    dg_cp = -pref / torch.clamp_min(denom, 1e-30) * (gamma[None, :] - 1.0)
    disp_cp = torch.abs(dg_cp) * torch.clamp_min(th_p, 1e-12)[:, None]
    return dg_cp, disp_cp
