"""Per-step electron update (counterpart of ``compton2d_tpu.fp.update``):
the Fokker-Planck solve of update2d.f vectorized over all zones.

IC drift from the tallied radiation field (a float32 contraction with
F_IC), synchrotron drift with the Razin-like suppression, hard-sphere
stochastic acceleration, injection and escape; under pair_switch the pair
sources and annihilation sinks on the electrons and the positrons, whose
distribution goes through the same Chang-Cooper operator; implicit
substeps (Chang-Cooper + PCR) with the geometric x1.25 floor backoff for
stiff zones, each zone to the end of the step; the temperature from
<gamma> through the gamma_bar table; the dT_max -> dt ladder and the
effective nonthermal refit. Under fp_include_coulomb the exact Moller
and e-p Coulomb coefficients (``physics.coulomb`` tables, or without
tables the Spitzer-like e-p limits of ``_coulomb_drift``) join the
operator.

The substep loop (:func:`substep_loop`) runs each zone's substeps to the
end of the step, a zone's substeps independent of every other zone's. On
a CUDA card it is one launch of the hand-written kernel
``csrc/fp_substeps.cu`` a step (:func:`substep_loop_kernel`); on the CPU
it is its plain version, :func:`substep_loop_reference`: masked substeps
over all zones in a bounded loop whose condition is read on the host.

``photon_fill``: the reference's cycle-1 explicit thermal-rate table, a
diagnostic only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from time import perf_counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch import kernel_build
from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.config import PhysicsConfig
from compton2d_tpu_torch.units import Scales
from compton2d_tpu_torch.fp.chang_cooper import (chang_cooper_coeffs,
                                                 grid_spacing, pcr_solve)
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


class FPConstants(NamedTuple):
    """What :func:`fp_step` takes from the configuration and the tables
    alone, made once a run by :func:`fp_constants`."""

    p_cand: torch.Tensor      # (199,) f32 the refit's trial power-law indices
    t_esc: float              # escape time [s]: the kernel's
    t_esc_dev: torch.Tensor   # () f64 and on the device: the plain loop's


def fp_constants(gnt: torch.Tensor, z_max: float,
                 phys: PhysicsConfig) -> FPConstants:
    """The FPConstants of the configuration on the device of ``gnt``."""
    t_esc = phys.r_esc * z_max / cn.C_LIGHT
    return FPConstants(
        p_cand=torch.as_tensor(np.arange(0.1, 10.01, 0.05, dtype=np.float32),
                               device=gnt.device),
        t_esc=t_esc, t_esc_dev=torch.tensor(t_esc, dtype=torch.float64,
                                            device=gnt.device))


class FPResult(NamedTuple):
    zones: ZoneState
    dt_new: torch.Tensor      # () adapted next step
    dT_max: torch.Tensor      # () max relative temperature change
    e_el_old: torch.Tensor    # () total electron energy before [E]
    e_el_new: torch.Tensor    # () after [E]
    substeps: torch.Tensor    # () int32 substeps used
    incomplete: torch.Tensor  # () int32 zones with t_fp < dt at the end


class Loop(NamedTuple):
    """What the substep loop reads, made once a step by :func:`fp_step`
    (Z zones, N = num_nt bins; float32, or float64 zones on the CPU)."""

    f: torch.Tensor           # (Z, N) distribution, normalised
    npos: torch.Tensor        # (Z, N) positrons
    th_e: torch.Tensor        # (Z,) kT_e / m_e c^2 at the start
    n_p: torch.Tensor         # (Z,) protons
    ne: torch.Tensor          # (Z,) electrons
    n_lept: torch.Tensor      # (Z,) leptons
    volume: torch.Tensor      # (Z,)
    B: torch.Tensor           # (Z,) field, floored at 1e-20
    f_sy: torch.Tensor        # (Z,) synchrotron drift factor
    tna: torch.Tensor         # (Z,) proton temperature [keV]
    th_p: torch.Tensor        # (Z,) kT_p / m_p c^2
    tlev: torch.Tensor        # (Z,) turbulence level
    eloss_sy: torch.Tensor    # (Z,) synchrotron loss of the step [E]
    valid: torch.Tensor       # (Z,) bool: False on a zone farm's pads
    jrow: torch.Tensor        # (Z,) the zone's z-row
    f_br: Optional[torch.Tensor]   # (Z,) bremsstrahlung factor, or None
    gnt: torch.Tensor         # (N,) gamma - 1
    gamma: torch.Tensor       # (N,)
    wdg: torch.Tensor         # (N,) bin widths, the last 0
    dg_ic: torch.Tensor       # (Z, N) inverse-Compton drift
    dg_a: torch.Tensor        # (1, N) stochastic acceleration drift
    disp_a: torch.Tensor      # (1, N) and its dispersion
    gauss_prof: torch.Tensor  # (N,) the Gaussian injection profile
    dn_pp: Optional[torch.Tensor]   # (Z, N) pair sources (interior bins)
    dne_pa: Optional[torch.Tensor]  # (Z, N) electron annihilation
    dnp_pa: Optional[torch.Tensor]  # (Z, N) positron annihilation
    dg_cp: Optional[torch.Tensor]   # (Z, N) e-p rows of the tables
    disp_cp: Optional[torch.Tensor]
    dt: torch.Tensor          # () step
    time: torch.Tensor        # () time at the start of the step
    slab_vol: torch.Tensor    # () volume of one z-slab of the whole grid
    dz: torch.Tensor          # () z-row height [L]
    t_esc: float              # escape time [s]
    t_esc_dev: torch.Tensor   # () the same on the device
    k_dT: float
    k_mec2_vol: float
    k_coul: float
    z_max: float
    phys: PhysicsConfig
    scales: Scales
    gamma_bar: ed.GammaBarTable
    coulomb: object           # physics.coulomb.CoulombTables or None


class Substeps(NamedTuple):
    """The substep loop's result: each zone at the end of its substeps."""

    f: torch.Tensor           # (Z, N) distribution
    th_e: torch.Tensor        # (Z,)
    t_fp: torch.Tensor        # (Z,) time reached (dt when done)
    npz: torch.Tensor         # (Z,) protons after injection and escape
    npos: torch.Tensor        # (Z, N) positrons
    count: torch.Tensor       # (Z,) int32 substeps the zone took


def fp_step(
    zones: ZoneState, n_field, tables: Tables, vol, z_max: float, dz, dt,
    time, eloss_sy, phys: PhysicsConfig, scales: Scales, fc: FPConstants,
    eloss_br=None, dn_pp=None, dne_pa=None, dnp_pa=None, coulomb=None,
    j_row=None, slab_vol=None, zone_valid=None,
) -> FPResult:
    """All energies scaled by scales.E, volumes by scales.L^3; ``fc`` is
    the run's :func:`fp_constants`. Under pair_switch, ``dn_pp`` (pair
    production), ``dne_pa`` and ``dnp_pa`` (electron and positron
    annihilation), each (nz, nr, num_nt) in cm^-3 s^-1, act on the
    electrons and the positrons; all three are required then. Under
    ``phys.fp_include_coulomb`` the Coulomb terms come from ``coulomb``
    (``physics.coulomb.CoulombTables``) when given, else from
    ``_coulomb_drift``. The solve runs in the precision of
    ``zones.f_nt``: float32 as the reference on every path; float64 zones
    (with the tables' gamma_bar in float64) are a precision check of the
    float32 solve, on the CPU.

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
    idx = torch.arange(num_nt, device=dev)

    t_acc = phys.r_acc * z_max / cn.C_LIGHT
    k_mec2_vol = scales.mec2_vol
    k_dgic = scales.nfield_to_dgic

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

    valid = (torch.ones(Z, dtype=torch.bool, device=dev)
             if zone_valid is None else zone_valid.reshape(Z))

    def e_tot(f, nloc):
        return torch.where(valid, torch.sum(f * gamma * wdg, dim=-1) * (
            nloc * (k_mec2_vol * volume)), 0.0)

    e_el_old = torch.sum(e_tot(f_old, ne))

    nf = n_field.reshape(Z, -1).to(f32)
    dg_ic = -zone_contract(nf, tables.f_ic.to(f32)) * (k_dgic / volume[:, None])
    f_br = None
    if phys.fp_include_bremsstrahlung and eloss_br is not None:
        sum_g11 = torch.sum(gamma ** 1.1 * f_old * wdg, dim=-1)
        f_br = eloss_br.reshape(Z).to(f32) / torch.clamp_min(
            (k_mec2_vol * volume) * dt32 * n_lept * sum_g11, 1e-30)

    use_pairs = bool(phys.pair_switch)
    pair_rows = (None, None, None)
    if use_pairs:
        if dn_pp is None or dne_pa is None or dnp_pa is None:
            raise ValueError(
                "fp_step: pair_switch needs dn_pp, dne_pa and dnp_pa")
        # the pair terms act on the interior bins only: the end bins are
        # the solve's boundary rows (x = d there, zeroed after the solve),
        # so a source there flows into its neighbour in proportion to the
        # drift coefficient without ever leaving the end bin, and creates
        # particles (a fault of the reference; ROADMAP C)
        inner = ((idx > 0) & (idx < num_nt - 1)).to(f32)
        pair_rows = tuple(x.reshape(Z, num_nt).to(f32) * inner
                          for x in (dn_pp, dne_pa, dnp_pa))
    inj = phys.injection
    gauss_prof = torch.where(idx < num_nt - 1, torch.exp(
        -((gamma - inj.gauss_g) * (gamma - inj.gauss_g))
        / (2.0 * inj.gauss_sigma**2)), 0.0)
    dg_cp = disp_cp = None
    if phys.fp_include_coulomb and coulomb is not None:
        # the e-p rows depend on the (fixed) proton temperature only
        dg_cp, disp_cp = coulomb.proton_rows(tna)

    sub = substep_loop(Loop(
        f=f_old, npos=zones.n_pos.reshape(Z, num_nt).to(f32),
        th_e=tea0 / cn.EMASS_KEV, n_p=n_p, ne=ne, n_lept=n_lept,
        volume=volume, B=B, f_sy=1.058e-15 * B * B / cn.MEC2_ERG, tna=tna,
        th_p=tna / 9.382e5, tlev=zones.turb_lev.reshape(Z).to(f32),
        eloss_sy=eloss_sy.reshape(Z).to(f32), valid=valid,
        jrow=(torch.arange(nz, dtype=f32, device=dev).repeat_interleave(nr)
              if j_row is None else j_row.reshape(Z).to(f32)),
        f_br=f_br, gnt=gnt, gamma=gamma, wdg=wdg, dg_ic=dg_ic,
        dg_a=gamma[None, :] / t_acc,
        disp_a=gamma[None, :] * gamma[None, :] / (2.0 * t_acc),
        gauss_prof=gauss_prof, dn_pp=pair_rows[0], dne_pa=pair_rows[1],
        dnp_pa=pair_rows[2], dg_cp=dg_cp, disp_cp=disp_cp, dt=dt32,
        time=time32,
        slab_vol=(torch.sum(volume) / nz if slab_vol is None
                  else slab_vol),
        dz=dz, t_esc=fc.t_esc, t_esc_dev=fc.t_esc_dev,
        k_dT=6.25e8 * scales.E / (1.5 * scales.L3), k_mec2_vol=k_mec2_vol,
        k_coul=1.5 * 1.7386e-26 * scales.L3 / scales.E, z_max=z_max,
        phys=phys, scales=scales, gamma_bar=tables.gamma_bar,
        coulomb=coulomb if phys.fp_include_coulomb else None))
    f, th_e, t_fp, npos = sub.f, sub.th_e, sub.t_fp, sub.npos

    incomplete = torch.sum((valid & (t_fp < dt32)).to(i32), dtype=i32)
    te_new = torch.clamp(th_e * cn.EMASS_KEV, phys.temp_min, phys.temp_max)
    te_new = torch.where(tna > 1.0, te_new, tea0)
    dT = torch.abs(te_new - tea0) / torch.clamp_min(te_new, 1e-30)
    dT_max = torch.max(dT)
    np_fin = sub.npz
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
    p_cand = fc.p_cand.to(f32)
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
    # the step's substeps, read once at its end: the largest per-zone
    # count (the plain loop's global count) and the sum over the zones
    substeps = torch.max(sub.count)
    most, total = tm.read("fp.done", torch.stack(
        [substeps, torch.sum(sub.count, dtype=i32)]), tm.to_host).tolist()
    tm.count("fp.substeps", most)
    tm.count("fp.zone_substeps", total)
    return FPResult(
        zones=zones_new, dt_new=dt_new, dT_max=dT_max, e_el_old=e_el_old,
        e_el_new=e_el_new, substeps=substeps, incomplete=incomplete,
    )


def substep_loop(lp: Loop) -> Substeps:
    """Every zone's substeps to the end of the step: on CUDA tensors one
    launch of ``csrc/fp_substeps.cu`` (:func:`substep_loop_kernel`), on
    CPU tensors the plain version (:func:`substep_loop_reference`)."""
    if lp.f.device.type == "cpu":
        return substep_loop_reference(lp)
    if lp.f.device.type != "cuda":
        raise ValueError(f"fp_step: unsupported device {lp.f.device}")
    return substep_loop_kernel(lp)


def substep_loop_reference(lp: Loop) -> Substeps:
    """The plain version of the substep loop: masked substeps over all
    zones while any zone has not reached dt and the loop has run fewer
    than ``fp_max_substeps``, the condition read on the host after each
    substep (``fp.done``; before the first no zone is done). A zone that
    is done passes through the pair sources, injection and escape on each
    later substep with d_t = 1e-30; its distribution and temperature keep
    their values."""
    phys, inj = lp.phys, lp.phys.injection
    Z, num_nt = lp.f.shape
    f32, i32 = lp.f.dtype, torch.int32
    dev = lp.f.device
    gamma, wdg, dt32, volume, n_lept = (lp.gamma, lp.wdg, lp.dt, lp.volume,
                                        lp.n_lept)
    dg_ic, valid, ne = lp.dg_ic, lp.valid, lp.ne
    k_mec2_vol, t_esc = lp.k_mec2_vol, lp.t_esc
    lnL = phys.lnL
    use_pairs = lp.dn_pp is not None
    dg_br = (None if lp.f_br is None
             else -lp.f_br[:, None] * gamma[None, :] ** 1.1)

    def cool_heat_rates(f, th_e, te):
        g_av = lp.gamma_bar.forward(torch.clamp_min(th_e, 1e-6))
        gamma_R = 2.1e-3 * torch.sqrt(n_lept) / (lp.B * torch.sqrt(g_av))
        hr_th_c = -torch.sum(dg_ic * f * wdg, dim=-1) * (
            (k_mec2_vol * volume) * n_lept)
        y = gamma_R / g_av
        hr_th_sy = torch.where(
            y < 90.0,
            -lp.eloss_sy / (dt32 * torch.exp(torch.clamp_max(y, 90.0))),
            0.0,
        )
        tsum = th_e + lp.th_p
        h_T = 0.79788 * (2.0 * (tsum * tsum) + 2.0 * tsum + 1.0) / (
            torch.clamp_min(tsum, 1e-12) ** 1.5
            * (1.0 + 1.875 * th_e + 0.8203 * (th_e * th_e))
        )
        hr_th_coul = (lp.k_coul * lp.n_p) * (volume * n_lept) * lnL * h_T * (
            lp.tna - te)
        hr_th_A = torch.clamp_min(lp.tlev * hr_th_coul, 1e-30)
        return hr_th_sy + hr_th_c + hr_th_A, gamma_R

    it = 0
    t_fp = torch.zeros(Z, dtype=f32, device=dev)
    f, th_e, npos = lp.f, lp.th_e, lp.npos
    npz, nlept_z = lp.n_p, n_lept
    grow = torch.ones(Z, dtype=f32, device=dev)
    done = torch.zeros(Z, dtype=torch.bool, device=dev)
    count = torch.zeros(Z, dtype=i32, device=dev)
    # bounded substep loop, its condition read on the host
    while it < phys.fp_max_substeps and (
            it == 0 or not tm.read("fp.done", torch.all(done), bool)):
        te = th_e * cn.EMASS_KEV
        hr_total, gamma_R = cool_heat_rates(f, th_e, te)
        dT_tot = (lp.k_dT * dt32) * hr_total / torch.clamp_min(
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
                f + (lp.dn_pp + lp.dne_pa) * dlt
                / torch.clamp_min(ne, 1e-30)[:, None], 0.0)
            npos = torch.clamp_min(npos + (lp.dn_pp + lp.dnp_pa) * dlt, 0.0)

        # ---- injection (update2d.f:1229-1301) ---------------------------
        n_inject = torch.zeros(Z, dtype=f32, device=dev)
        f_inj = f
        if inj.pickup:
            psum = torch.clamp_min(torch.sum(lp.gauss_prof * wdg), 1e-30)
            inj_rho = torch.where(valid, inj.pickup_rate * d_t, 0.0)
            f_inj = f_inj + (inj_rho[:, None] * lp.gauss_prof[None, :] / psum
                             / torch.clamp_min(ne, 1e-30)[:, None])
            n_inject = n_inject + inj_rho
        if inj.switch != 0:
            if inj.distribution == 1:
                prof = lp.gauss_prof[None, :].expand(Z, num_nt)
            else:
                if inj.g2var_switch:
                    ttz = (lp.time + t_fp - inj.t_start).to(f32)
                    g2z = inj.g2 * torch.pow(10.0, torch.clamp(
                        ttz * float(np.float32(inj.v / lp.z_max)), 0.0, 6.0))
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
            t_row = lp.dz * float(np.float32(lp.scales.L)) / float(
                np.float32(inj.v))
            tt = lp.time + t_fp - inj.t_start
            active = (tt > t_row * lp.jrow) & (tt < t_row * (lp.jrow + 1))
            lum_fold = float(inj.luminosity) / (8.186e-7 * lp.scales.L3)
            inj_rate = lum_fold / torch.clamp_min(
                inj_e_mean * lp.slab_vol, 1e-30)
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
            -lp.f_sy[:, None] * (gamma[None, :] * gamma[None, :] - 1.0)
            / torch.exp(torch.clamp_max(y_sy, 100.0)),
            -1e-50,
        )
        dgdt = dg_sy + dg_ic + lp.dg_a
        if dg_br is not None:
            dgdt = dgdt + dg_br
        disp = lp.disp_a.expand(Z, num_nt)
        if lp.coulomb is not None:
            # exact Moller/Coulomb tables (update2d.f:898-988) at this
            # substep's Te, on the lepton and proton densities after
            # injection and escape
            dg_ce_t, disp_ce_t = lp.coulomb.electron_rows(te)
            dgdt = dgdt + dg_ce_t * nlept_z[:, None] \
                + lp.dg_cp * npz[:, None]
            disp = disp + disp_ce_t * nlept_z[:, None] \
                + lp.disp_cp * npz[:, None]
        elif phys.fp_include_coulomb:
            dg_cp, disp_cp = _coulomb_drift(gamma, lp.tna, npz, lnL)
            dgdt = dgdt + dg_cp
            disp = disp + disp_cp
        a, b, c = chang_cooper_coeffs(lp.gnt, dgdt, disp, d_t, lp.t_esc_dev)
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
        th_new = lp.gamma_bar.inverse(gbar)

        upd = ~done
        f = torch.where(upd[:, None], f_new, f)
        if use_pairs:
            npos = torch.where(upd[:, None], npos_new, npos)
        th_e = torch.where(upd, th_new, th_e)
        t_fp = torch.where(upd, torch.where(last, dt32, t_fp + d_t), t_fp)
        count = count + upd.to(i32)
        done = t_fp >= dt32
        it += 1
    return Substeps(f=f, th_e=th_e, t_fp=t_fp, npz=npz, npos=npos,
                    count=count)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fp_substeps.cu"
MAX_BINS = 512       # bins a block takes, one thread a bin (the kernel's)
MAX_GRID = 65535     # blocks a launch; they loop over the zones beyond
_N_RED, _MAX_WARPS = 5, MAX_BINS // 32
# the kernel's enums (csrc/fp_substeps.cu)
_INJ_NONE, _INJ_GAUSS, _INJ_PL, _INJ_PL_G2VAR = range(4)
_COUL_NONE, _COUL_TABLES, _COUL_DRIFT = range(3)
# kernel launches made by substep_loop on CUDA tensors; the plain version
# on CPU tensors does not count
_launches = 0
_lib = None

# the kernel's operands by shape, in the order of its struct Pointers:
# rows (N,), zone values (Z,), zone rows (Z, N), tables, outputs
_ROWS = ("gamma", "wdg", "dg_a", "disp_a", "d_gm", "d_gp", "delta_g",
         "gauss", "prof", "gpow", "gmask", "g11", "beta")
_ZONE = ("th_e", "ne_c", "n_p", "n_lept", "gr_num", "b_field", "f_sy",
         "c_ic", "eloss_sy", "th_p", "c_coul", "tna", "tlev", "vn", "valid",
         "t_lo", "t_hi", "f_br", "cd_den", "thp_c")
_ZONE_ROWS = ("f", "dg_ic", "npos", "src_e", "src_p", "dg_cp", "disp_cp")
_TABLES = ("lg_theta", "gbar", "lg_gbar_m1", "lg_te", "dg_ce", "disp_ce",
           "step")
_OUTS = ("f_o", "npos_o", "th_e_o", "t_fp_o", "npz_o", "count_o")
_POINTERS = _ROWS + _ZONE + _ZONE_ROWS + _TABLES + _OUTS


class _Pointers(ctypes.Structure):
    """``struct Pointers`` of csrc/fp_substeps.cu."""

    _fields_ = [(k, ctypes.c_void_p) for k in _POINTERS]


class _Scalars(ctypes.Structure):
    """``struct Scalars`` of csrc/fp_substeps.cu."""

    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "z", "n", "knots", "nte", "max_sub", "pairs", "brems", "coulomb",
            "pickup", "inj", "threads", "smem")]
        + [(k, ctypes.c_float) for k in (
            "t_esc", "emass_kev", "df_implicit", "df_t", "pickup_rate",
            "lum_fold", "t_start", "g2", "cv", "lnl", "interp_eps")]
    )


def launch_counts() -> dict:
    """The kernel's launches since the last reset."""
    return dict(fp_substeps=_launches)


def reset_launch_counts() -> None:
    """Set the launch count to 0."""
    global _launches
    _launches = 0


tm.register_launches(__name__, launch_counts)


def build() -> float:
    """Compile ``csrc/fp_substeps.cu`` into its hash-keyed library under
    ``_build/`` if that is missing (``kernel_build.compile_source``: nvcc,
    sm_90a, the flight kernel's flags) and load it as the kernel that
    :func:`substep_loop_kernel` launches. Returns the seconds spent."""
    global _lib
    t0 = perf_counter()
    path = kernel_build.compile_source(_SOURCE)
    if _lib is None or Path(_lib._name) != path:
        lib = ctypes.CDLL(str(path))
        for fn in ("fp_pointers_bytes", "fp_scalars_bytes"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        lib.fp_substeps_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fp_substeps_launch.restype = ctypes.c_int
        built = (lib.fp_pointers_bytes(), lib.fp_scalars_bytes())
        wanted = (ctypes.sizeof(_Pointers), ctypes.sizeof(_Scalars))
        if built != wanted:
            raise RuntimeError(f"{path.name}: struct bytes {built}, the "
                               f"wrapper's {wanted}")
        _lib = lib
    return perf_counter() - t0


def ptxas_report() -> str:
    """ptxas's registers, stack and spills for the kernel of the loaded
    build (:func:`build` first)."""
    return kernel_build.ptxas_entry(_SOURCE, "fp_substeps_kernel")


def block_threads(num_nt: int) -> int:
    """The kernel's block: one thread a bin, in whole warps."""
    if not 2 <= num_nt <= MAX_BINS:
        raise ValueError(f"fp substep kernel: num_nt={num_nt} outside "
                         f"2..{MAX_BINS}")
    return -(-num_nt // 32) * 32


def shared_bytes(threads: int, knots: int) -> int:
    """A block's dynamic shared memory: the gamma_bar table, the PCR
    rounds' two buffers of a, b, c and both right-hand sides, the
    Chang-Cooper neighbours and the block sums' partials."""
    return 4 * (3 * knots + 15 * threads + _N_RED * _MAX_WARPS)


def _kernel_operands(lp: Loop):
    """The kernel's inputs (``struct Pointers``) and switches (``struct
    Scalars``) from the loop's: what the plain loop computes from the
    step's constants on each substep, computed once here by the same
    operations in the same order."""
    phys, inj = lp.phys, lp.phys.injection
    Z, N = lp.f.shape
    f32 = torch.float32
    gamma, wdg = lp.gamma, lp.wdg
    d_gm, d_gp, delta_g = grid_spacing(lp.gnt)
    ops = dict(
        gamma=gamma, wdg=wdg, dg_a=lp.dg_a.reshape(N),
        disp_a=lp.disp_a.reshape(N), d_gm=d_gm, d_gp=d_gp, delta_g=delta_g,
        th_e=lp.th_e, ne_c=torch.clamp_min(lp.ne, 1e-30), n_p=lp.n_p,
        n_lept=lp.n_lept, gr_num=2.1e-3 * torch.sqrt(lp.n_lept),
        b_field=lp.B, f_sy=lp.f_sy,
        c_ic=(lp.k_mec2_vol * lp.volume) * lp.n_lept, eloss_sy=lp.eloss_sy,
        th_p=lp.th_p,
        c_coul=(lp.k_coul * lp.n_p) * (lp.volume * lp.n_lept) * phys.lnL,
        tna=lp.tna, tlev=lp.tlev,
        vn=torch.clamp_min(lp.volume * lp.n_lept, 1e-30),
        valid=lp.valid.to(f32), f=lp.f, dg_ic=lp.dg_ic,
        lg_theta=lp.gamma_bar.log_theta, gbar=lp.gamma_bar.gbar,
        lg_gbar_m1=lp.gamma_bar.log_gbar_m1,
    )
    psum = torch.zeros((), dtype=f32, device=lp.f.device)
    if inj.pickup:
        psum = torch.clamp_min(torch.sum(lp.gauss_prof * wdg), 1e-30)
    if inj.pickup or (inj.switch != 0 and inj.distribution == 1):
        ops["gauss"] = lp.gauss_prof
    mode = _INJ_NONE
    if inj.switch != 0:
        t_row = lp.dz * float(np.float32(lp.scales.L)) / float(
            np.float32(inj.v))
        ops["t_lo"] = t_row * lp.jrow
        ops["t_hi"] = t_row * (lp.jrow + 1)
        if inj.distribution == 1:
            mode = _INJ_GAUSS
        elif inj.g2var_switch:
            mode = _INJ_PL_G2VAR
            ops["gpow"] = gamma ** (-inj.p)
            ops["gmask"] = (gamma > inj.g1).to(f32)
        else:
            mode = _INJ_PL
            yv = gamma / inj.g2
            prof = torch.where((gamma > inj.g1) & (yv < 100.0),
                               gamma ** (-inj.p)
                               * torch.exp(-torch.clamp_max(yv, 100.0)), 0.0)
            # the last bin 0 (a setitem would copy the host's 0 and wait)
            last = torch.arange(N, device=gamma.device) == N - 1
            ops["prof"] = torch.where(last, 0.0, prof)
    if lp.f_br is not None:
        ops["f_br"] = lp.f_br
        ops["g11"] = gamma ** 1.1
    coul = _COUL_NONE
    if lp.coulomb is not None:
        coul = _COUL_TABLES
        ops.update(dg_cp=lp.dg_cp, disp_cp=lp.disp_cp,
                   lg_te=lp.coulomb.log_te, dg_ce=lp.coulomb.dg_ce,
                   disp_ce=lp.coulomb.disp_ce)
    elif phys.fp_include_coulomb:
        # _coulomb_drift's rows and zone factors
        coul = _COUL_DRIFT
        th_p = lp.th_p
        ops.update(
            beta=torch.sqrt(torch.clamp_min(1.0 - 1.0 / (gamma * gamma),
                                            1e-20)),
            cd_den=(1.0 + 1.875 * th_p + 0.8203 * (th_p * th_p))
            * torch.sqrt(torch.clamp_min(th_p, 1e-12)),
            thp_c=torch.clamp_min(th_p, 1e-12))
    pairs = lp.dn_pp is not None
    if pairs:
        ops.update(npos=lp.npos, src_e=lp.dn_pp + lp.dne_pa,
                   src_p=lp.dn_pp + lp.dnp_pa)
    ops["step"] = torch.stack([
        lp.dt, lp.time, lp.k_dT * lp.dt,
        1.001 * lp.dt / phys.fp_max_substeps,
        torch.as_tensor(lp.slab_vol, dtype=f32, device=lp.f.device), psum])
    sc = dict(
        z=Z, n=N, knots=lp.gamma_bar.log_theta.shape[0],
        nte=0 if lp.coulomb is None else lp.coulomb.log_te.shape[0],
        max_sub=int(phys.fp_max_substeps), pairs=int(pairs),
        brems=int(lp.f_br is not None), coulomb=coul,
        pickup=int(bool(inj.pickup)), inj=mode, t_esc=lp.t_esc,
        emass_kev=cn.EMASS_KEV, df_implicit=cn.DF_IMPLICIT, df_t=cn.DF_T,
        pickup_rate=float(inj.pickup_rate),
        lum_fold=float(inj.luminosity) / (8.186e-7 * lp.scales.L3),
        t_start=float(inj.t_start), g2=float(inj.g2),
        cv=float(np.float32(inj.v / lp.z_max)), lnl=float(phys.lnL),
        interp_eps=float(np.spacing(np.finfo(np.float32).eps)))
    return ops, sc


class _Prepared(NamedTuple):
    """A checked kernel launch: its C arguments, and the operands and
    outputs its pointers point to."""

    args: tuple
    ops: dict
    outs: dict
    pairs: bool


def _prepare(lp: Loop) -> _Prepared:
    """Check the loop's CUDA operands, make the kernel's, allocate the
    outputs and collect the launch's arguments."""
    Z, N = lp.f.shape
    dev = lp.f.device
    if lp.f.dtype != torch.float32:
        raise ValueError(f"fp substep kernel: zones in {lp.f.dtype}; the "
                         "card runs the float32 solve")
    threads = block_threads(N)
    ops, sc = _kernel_operands(lp)
    K = sc["knots"]
    shapes = dict({k: (N,) for k in _ROWS}, **{k: (Z,) for k in _ZONE},
                  **{k: (Z, N) for k in _ZONE_ROWS},
                  lg_theta=(K,), gbar=(K,), lg_gbar_m1=(K,),
                  lg_te=(sc["nte"],), dg_ce=(sc["nte"], N),
                  disp_ce=(sc["nte"], N), step=(6,))
    for k, t in ops.items():
        kernel_build.check(t, k, torch.float32, shapes[k], dev)
    smem = shared_bytes(threads, K)
    if smem > 48 * 1024:
        raise ValueError(f"fp substep kernel: {smem} bytes of shared memory")

    def emp(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    f32 = torch.float32
    outs = dict(f_o=emp(f32, Z, N),
                npos_o=emp(f32, Z, N) if sc["pairs"] else None,
                th_e_o=emp(f32, Z), t_fp_o=emp(f32, Z), npz_o=emp(f32, Z),
                count_o=emp(torch.int32, Z))
    if _lib is None:
        build()
    both = dict(ops, **outs)
    ptrs = _Pointers(*[0 if both.get(k) is None else both[k].data_ptr()
                       for k in _POINTERS])
    scal = _Scalars(threads=threads, smem=smem, **sc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the structs are passed by pointer and live as long as the arguments
    args = (ctypes.byref(ptrs), ctypes.byref(scal), ctypes.sizeof(ptrs),
            ctypes.sizeof(scal), min(Z, MAX_GRID), stream)
    return _Prepared(args, ops, outs, bool(sc["pairs"]))


def _launch(args: tuple) -> None:
    """One launch of the loaded kernel (``fp_substeps_launch``'s
    arguments)."""
    rc = _lib.fp_substeps_launch(*args)
    if rc != 0:
        raise RuntimeError(f"fp substep kernel launch failed: cudaError {rc}")


def launch_only(lp: Loop):
    """The timing hook: checks the operands and allocates the outputs once
    and returns a callable that launches the kernel alone on them (its
    launches are not counted)."""
    prep = _prepare(lp)
    return lambda: _launch(prep.args)


def substep_loop_kernel(lp: Loop) -> Substeps:
    """The substep loop as one launch of ``csrc/fp_substeps.cu`` (built
    at first use) on CUDA tensors: a block a zone runs the zone's
    substeps to the end of the step, and a done zone stops (the plain
    loop's later substeps leave it as it is, but for the pair sources and
    the injection at d_t = 1e-30). Raises on float64 zones, on num_nt
    outside 2..MAX_BINS and on operands it does not take."""
    global _launches
    prep = _prepare(lp)
    _launch(prep.args)
    _launches += 1
    o = prep.outs
    return Substeps(f=o["f_o"], th_e=o["th_e_o"], t_fp=o["t_fp_o"],
                    npz=o["npz_o"],
                    npos=o["npos_o"] if prep.pairs else lp.npos,
                    count=o["count_o"])


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
