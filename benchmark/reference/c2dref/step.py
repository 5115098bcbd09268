"""The program's step, frozen: the phase order of the port's
``driver._step_impl`` and the helpers it calls, copied with the plain
flight loop in place of the CUDA kernel and without the Coulomb drift and
file-spectrum boundaries (no configuration of the benchmark uses them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from c2dref import constants as cn
from c2dref.config import SimConfig, TimeWindow, ZoneInit
from c2dref.units import Scales
from c2dref.fp.update import FPResult, fp_step
from c2dref.grid import Grid
from c2dref.parallel import mesh as pmesh
from c2dref.physics.compton import SIGMA_T, zone_sigma_table
from c2dref.physics.electron_dist import gnt_grid
from c2dref.physics.emissivity import equipartition_b, volume_em
from c2dref.physics import pairs
from c2dref.state import EventBuffer, PhotonArray, SimState, Tallies, ZoneState
from c2dref.tables import PairTables, Tables
from c2dref.transport import flight, sourcing
from c2dref.transport.population import census_roulette, zone_sort
from c2dref.transport.tracking import (
    TrackContext,
    TrackStatics,
    census_tally,
    hist2d,
    loggrid_bin,
    segment_sum,
    transport_step,
)


def external_spectrum(name, ext):
    raise NotImplementedError(
        f"file-spectrum boundary {name!r}: not in the frozen reference")


class StepOutputs(NamedTuple):
    """Per-step results (fields as in the reference)."""

    tallies: Tallies
    events: EventBuffer
    bingo: torch.Tensor
    e_el_old: torch.Tensor
    e_el_new: torch.Tensor
    dT_max: torch.Tensor
    fp_substeps: torch.Tensor
    fp_incomplete: torch.Tensor
    n_tracked: torch.Tensor
    nph_raw: torch.Tensor
    nph_fit: torch.Tensor


class WindowSources(NamedTuple):
    """Per-time-window boundary sources sharing one spectrum bank. The
    ``off`` variant of a window zeroes its file flux: a file boundary
    sources only once time + dt/2 >= t0 (imcgen2d.f:127,139,156,173)."""

    t0: np.ndarray                              # (n_windows,) start [s]
    t1: np.ndarray                              # (n_windows,) end [s]
    on: Tuple[sourcing.SourceStatic, ...]
    off: Tuple[sourcing.SourceStatic, ...]

    def select(self, time: float, dt: float, ncycle: int):
        """First window with t1 > time + dt/2, clamped to the last
        (imcgen2d.f:111-120; ncycle 0 uses window 1)."""
        t_avg = time + 0.5 * dt
        idx = 0 if ncycle == 0 else min(
            int(np.searchsorted(self.t1, t_avg, side="right")),
            len(self.on) - 1)
        return self.on[idx] if t_avg >= float(self.t0[idx]) \
            else self.off[idx]


def spectrum_bank(cfg: SimConfig, scales: Scales, names):
    """Each distinct spectrum file read once (file_sp,
    imcsurf2d_para.f:544-685) into a padded (n_spec, nf) bank on the
    host: energies, the sampling CDF (padded with 1) and the flux in
    scaled E/(L^2 s). Row 0 is the dummy "no file" row."""
    rows = []
    for nm in names:
        e_file, _, p_file, int_file = external_spectrum(
            nm, cfg.source.external)
        rows.append((np.asarray(e_file, np.float32),
                     np.asarray(p_file[:len(e_file)], np.float32),
                     float(int_file) * scales.L2 / scales.E))
    nf = max([2] + [len(r[0]) for r in rows])
    spec_e = np.ones((len(rows) + 1, nf), np.float32)
    spec_cdf = np.ones((len(rows) + 1, nf), np.float32)
    spec_cdf[0, 0] = 0.0
    flux = np.zeros((len(rows) + 1,), np.float32)
    for i, (e, p, fl) in enumerate(rows, start=1):
        spec_e[i, :len(e)] = e
        spec_e[i, len(e):] = e[-1]
        spec_cdf[i, :len(p)] = p
        flux[i] = fl
    return spec_e, spec_cdf, flux


def build_window_sources(cfg: SimConfig, scales: Scales,
                         device="cpu") -> WindowSources:
    """Per-window SourceStatic (reader.f:222-283): per-ring temperatures
    and spectrum files, with the star dilution of the upper boundary."""
    g = cfg.grid
    windows = cfg.windows or (
        TimeWindow(
            t0=0.0, t1=float("inf"),
            tbb_upper=(0.0,) * g.nr, tbb_lower=(0.0,) * g.nr,
            tbb_inner=(0.0,) * g.nz, tbb_outer=(0.0,) * g.nz,
        ),
    )
    names: list = []
    for w in windows:
        for nm in tuple(w.lower_spectra) + tuple(w.upper_spectra):
            if nm and nm not in names:
                names.append(nm)
    spec_e, spec_cdf, flux = spectrum_bank(cfg, scales, names)
    row_of = {nm: i + 1 for i, nm in enumerate(names)}
    star = cfg.physics
    dilution = (star.r_star / star.dist_star) ** 2 if star.star_switch else 1.0

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def ring_rows(tbbs, specs, n):
        idx = np.zeros((n,), np.int32)
        fl = np.zeros((n,), np.float32)
        specs = tuple(specs) + (None,) * n
        for k in range(n):
            if tbbs[k] < 0.0 and specs[k]:
                idx[k] = row_of[specs[k]]
                fl[k] = flux[idx[k]]
        return idx, fl

    bank_e, bank_cdf = f(spec_e), f(spec_cdf)
    on, off = [], []
    for w in windows:
        sl, fl_l = ring_rows(w.tbb_lower, w.lower_spectra, g.nr)
        su, fl_u = ring_rows(w.tbb_upper, w.upper_spectra, g.nr)
        src = sourcing.SourceStatic(
            tbb_lower=f(w.tbb_lower), tbb_upper=f(w.tbb_upper),
            tbb_inner=f(w.tbb_inner), tbb_outer=f(w.tbb_outer),
            spec_e=bank_e, spec_cdf=bank_cdf,
            spec_lower=torch.as_tensor(sl, device=device),
            spec_upper=torch.as_tensor(su, device=device),
            flux_lower=f(fl_l), flux_upper=f(fl_u),
            star_dilution=f(dilution),
        )
        on.append(src)
        off.append(src._replace(flux_lower=f(np.zeros(g.nr)),
                                flux_upper=f(np.zeros(g.nr)))
                   if (fl_l.any() or fl_u.any()) else src)
    return WindowSources(
        t0=np.asarray([w.t0 for w in windows], float),
        t1=np.asarray([w.t1 for w in windows], float),
        on=tuple(on), off=tuple(off),
    )


def _estimate_energy_scale(cfg: SimConfig, zone_init: ZoneInit) -> float:
    """Energy unit E0 so per-step scaled energies sit around 1e6. A file
    ring (tbb < 0) counts with its file's flux: the reference takes the
    sentinel's |tbb| as a 1 keV blackbody, which puts a blazar deck's
    scaled weights near 1e-17, where float32 products underflow (its
    census roulette's log bisection among them)."""
    g = cfg.grid
    dt0 = (cfg.run.mcdt * min(g.r_max / g.nr, g.z_max / g.nz)
           / cfg.physics.injection.v)
    area = np.pi * g.r_max**2
    tbb_max = 0.0
    for w in cfg.windows:
        for arr in (w.tbb_lower, w.tbb_upper, w.tbb_inner, w.tbb_outer):
            tbb_max = max(tbb_max, max(arr, default=0.0))
    bb = cn.SIGMA_SB_KEV * tbb_max**4 * area * dt0
    files = {nm for w in cfg.windows
             for nm in tuple(w.lower_spectra) + tuple(w.upper_spectra) if nm}
    flux = max((external_spectrum(nm, cfg.source.external)[3]
                for nm in files), default=0.0)
    vol_tot = np.pi * g.r_max**2 * g.z_max
    sy = (
        1.058e-15
        * float(np.max(zone_init.n_e))
        * float(np.max(zone_init.B_field)) ** 2
        * float(np.max(zone_init.gmax))
        * vol_tot * dt0 * 0.01
    )
    inj = cfg.physics.injection.luminosity * dt0
    return max(bb, flux * area * dt0, sy, inj, 1.0) / 1e6


def select_tracker(cfg: SimConfig, world: int = 1) -> str:
    """The tracker of ``cfg`` on ``world`` ranks (the JAX driver's rule,
    compton2d_tpu/driver.py:1066-1082, with the card in the TPU's place):
    ``pallas_tracking`` "on" takes the flight kernel, "off" the lock-step
    loop, and "auto" the kernel when both grid edges are at most
    flight.MAX_EDGE and each rank's slots are whole flight.TILE tiles,
    else the loop. The JAX rule also asks for a TPU backend, so the JAX
    package takes its loop on every other backend; here the rule is the
    same on the CPU (where the kernel's plain version runs) as on the
    card."""
    run, g = cfg.run, cfg.grid
    if run.pallas_tracking == "on":
        return "kernel"
    if run.pallas_tracking == "off":
        return "loop"
    if run.pallas_tracking != "auto":
        raise ValueError(f"pallas_tracking={run.pallas_tracking!r} is not "
                         "'auto', 'on' or 'off'")
    fits = (g.nz <= flight.MAX_EDGE and g.nr <= flight.MAX_EDGE
            and (run.n_slots // world) % flight.TILE == 0)
    return "kernel" if fits else "loop"




class PairFields(NamedTuple):
    """Section 1b's results, per zone."""

    nph_raw: torch.Tensor   # (nz, nr, n_gg) census field [cm^-3 keV^-1]
    nph_fit: torch.Tensor   # (nz, nr, n_gg) its Wien-tail fit
    k_gg: torch.Tensor      # (nz, nr, n_gg) gamma-gamma opacity [1/L]
    dn_pp: torch.Tensor     # (nz, nr, num_nt) pair production
    dne_pa: torch.Tensor    # (nz, nr, num_nt) electron annihilation sink
    dnp_pa: torch.Tensor    # (nz, nr, num_nt) positron annihilation sink


def pair_fields(photons: PhotonArray, zones: ZoneState, tables: Tables,
                pair_tables: PairTables, grid: Grid, scales: Scales, nz: int,
                nr: int, mesh: Optional[pmesh.PhotonMesh] = None,
                zone_shard: bool = False) -> PairFields:
    """The pair physics of the census field (imcgen2d.f:354-396): the
    census photons' number density on the e_gg grid, its smoothed fit,
    the gamma-gamma opacity, the pair production and the annihilation
    sinks. Under a ``mesh`` the census field is summed over the ranks'
    photons, and with ``zone_shard`` the per-zone tensors are computed on
    the rank's zone slice and gathered."""
    f32 = torch.float32
    nzr = nz * nr
    ngg = tables.e_gg.shape[0]
    egg32 = tables.e_gg.to(f32)
    gbin, in_gg = loggrid_bin(photons.e, tables.e_gg_log0,
                              tables.e_gg_dlog, ngg)
    cnts = torch.where(photons.alive & in_gg,
                       photons.w / torch.clamp_min(photons.e, 1e-30), 0.0)
    zid = (torch.clamp(photons.jz, 0, nz - 1) * nr
           + torch.clamp(photons.kr, 0, nr - 1))
    nph_scaled = hist2d(cnts, zid, nzr, gbin, ngg)
    if mesh is not None:
        nph_scaled = pmesh.all_gather_sum(mesh, nph_scaled)
    # bin widths; the last bin's "width" is 1 (the reference's choice)
    de_gg = torch.cat([torch.diff(egg32), egg32.new_ones(1)])
    nph_phys = (nph_scaled * float(np.float32(scales.nfield_to_dgic))
                / grid.vol.reshape(-1, 1).to(f32) / de_gg[None, :])
    per_zone = (nph_phys, zones.tea.reshape(-1).to(f32),
                zones.f_nt.reshape(nzr, -1).to(f32),
                zones.n_pos.reshape(nzr, -1).to(f32),
                zones.n_e.reshape(-1).to(f32))
    if zone_shard:
        per_zone = [pmesh.zone_slice_flat(mesh, x) for x in per_zone]
    nph_z, tea_z, f_z, npos_z, ne_z = per_zone
    nph_sm = pairs.nph_smooth(nph_z, egg32, tea_z)
    k_gg = torch.matmul(nph_sm, pair_tables.kgg_mat.T)
    dn_pp = pairs.dn_pp_from_field(nph_sm, pair_tables.pp_tensor)
    dne_pa, dnp_pa = pairs.pa_rates(f_z, npos_z, ne_z, pair_tables.vsigma,
                                    tables.gnt.to(f32))
    rates = (nph_sm, k_gg, dn_pp, dne_pa, dnp_pa)
    if zone_shard:
        rates = pmesh.zone_gather(mesh, rates, nz, nr)[0]
    else:
        rates = tuple(x.reshape(nz, nr, -1) for x in rates)
    return PairFields(nph_phys.reshape(nz, nr, ngg), *rates)


def flare_zones(zones: ZoneState, grid: Grid, fl, time, scales: Scales
                ) -> ZoneState:
    """The zones the FP solve sees under a coronal flare
    (update2d.f:543-558): turb_lev + A g and tna (1 + A g), with g a
    Gaussian in r, z (cm, scaled by L) and time (s) about the flare's
    centre; the zones themselves unchanged without a flare."""
    if not fl.enabled:
        return zones
    r_mid = 0.5 * (grid.r_edges[1:] + grid.r_edges[:-1])
    z_mid = 0.5 * (grid.z_edges[1:] + grid.z_edges[:-1])
    y = 0.5 * (
        ((r_mid[None, :] - fl.r_flare / scales.L)
         / (fl.sigma_r / scales.L)) ** 2
        + ((z_mid[:, None] - fl.z_flare / scales.L)
           / (fl.sigma_z / scales.L)) ** 2
        + ((time - fl.t_flare) / fl.sigma_t) ** 2
    )
    tl_flare = torch.where(
        y < 100.0, fl.amplitude / torch.exp(torch.clamp_max(y, 100.0)),
        0.0).to(torch.float32)
    return zones._replace(turb_lev=zones.turb_lev + tl_flare,
                          tna=zones.tna * (1.0 + tl_flare))


def adapt_dt(dt_new, grid: Grid, scales: Scales):
    """The FP ladder's next dt (update2d.f:232-243) held at or above
    dt_min = min(dr_min, dz) L / c (update2d.f:257)."""
    dt_min = torch.minimum(torch.min(torch.diff(grid.r_edges)), grid.dz) \
        * float(np.float32(scales.L / cn.C_LIGHT))
    return torch.maximum(dt_new, dt_min.to(dt_new.dtype))


def fp_zone_farm(mesh: pmesh.PhotonMesh, args: tuple, kw: dict) -> FPResult:
    """``fp_step(*args, **kw)`` as the reference's FP zone farm
    (update2d.f:190-214): this rank solves its zone slice, a (Zs, 1) grid
    with its pad zones inert (no protons or leptons, ``zone_valid`` False),
    and one exchange gathers the zones, takes the largest dT_max and
    substep count and the smallest dt_new (the dt ladder is monotone in
    dT_max), and sums e_el_old, e_el_new and the incomplete zones. Each
    zone's solve is the one it gets on the whole grid, so the zones equal
    those of the replicated solve."""
    zones, n_field, tables, vol, z_max, dz, dt, time, eloss_sy = args[:9]
    nz, nr = zones.tea.shape
    f32 = torch.float32

    def part(x):
        return pmesh.zone_slice(mesh, x)

    valid = pmesh.zone_valid(mesh, nz * nr, vol.device)
    zs = ZoneState(*[part(x) for x in zones])
    zs = zs._replace(n_e=torch.where(valid, zs.n_e, 0.0),
                     tna=torch.where(valid, zs.tna, 0.0))
    j_row = torch.arange(nz, dtype=f32, device=vol.device)[:, None].expand(
        nz, nr)
    kw = {k: (part(v) if k in ("eloss_br", "dn_pp", "dne_pa", "dnp_pa")
              and v is not None else v) for k, v in kw.items()}
    fpr = fp_step(zs, part(n_field), tables, part(vol), z_max, dz, dt, time,
                  part(eloss_sy), *args[9:], j_row=part(j_row),
                  slab_vol=torch.sum(vol.reshape(-1).to(f32)) / nz,
                  zone_valid=valid, **kw)
    zones_new, dT_max, dt_new, e_old, e_new, sub, inc = pmesh.zone_gather(
        mesh, fpr.zones, nz, nr, extra=[
            (fpr.dT_max, pmesh.MAX), (fpr.dt_new, pmesh.MIN),
            (fpr.e_el_old, pmesh.SUM), (fpr.e_el_new, pmesh.SUM),
            (fpr.substeps, pmesh.MAX), (fpr.incomplete, pmesh.SUM)])
    return FPResult(zones=zones_new, dt_new=dt_new, dT_max=dT_max,
                    e_el_old=e_old, e_el_new=e_new, substeps=sub,
                    incomplete=inc)


def _step_impl(state: SimState, src: sourcing.SourceStatic, grid: Grid,
               tables: Tables, cfg: SimConfig, scales: Scales, ncycle: int,
               pair_tables: Optional[PairTables] = None,
               coulomb_tables=None,
               mesh: Optional[pmesh.PhotonMesh] = None,
               ) -> Tuple[SimState, StepOutputs]:
    """One step. ``ncycle`` is the host mirror of ``state.ncycle``. Under a
    ``mesh``, ``state.photons`` are this rank's slots (the order of the
    JAX package's sharded step, compton2d_tpu/driver.py:736-1192)."""
    g, phys, run = cfg.grid, cfg.physics, cfg.run
    nz, nr = g.nz, g.nr
    nzr = nz * nr
    zones = state.zones
    gen = state.key
    dev = state.dt.device
    f32, i32 = torch.float32, torch.int32
    n = state.photons.n_slots
    world = 1 if mesh is None else mesh.world
    zone_shard = world > 1 and run.zone_shard and nzr >= world

    # ---- 0. census replay: reset flight clocks (imcfield2d.f:117) -------
    photons = state.photons._replace(dcen=torch.where(
        state.photons.alive,
        float(np.float32(scales.c)) * state.dt.to(f32), 0.0,
    ))
    zid = (torch.clamp(photons.jz, 0, nz - 1) * nr
           + torch.clamp(photons.kr, 0, nr - 1))
    ecens_prev = segment_sum(
        torch.where(photons.alive, photons.w, 0.0), zid, nzr
    ).reshape(nz, nr)
    if mesh is not None:
        ecens_prev = pmesh.all_gather_sum(mesh, ecens_prev)

    # ---- 1. zone pass (imcgen2d): B, emissivities, budget ---------------
    B = equipartition_b(zones.ep_switch, zones.tea, zones.tna, zones.n_e,
                        zones.f_pair, zones.B_field,
                        tables.gamma_bar.forward)
    zones = zones._replace(B_field=B)
    l_min = torch.minimum(grid.dz, grid.dr) * torch.ones_like(grid.vol)
    em_zones = (zones.f_nt, zones.tea, zones.n_e, B, zones.amxwl, grid.vol,
                grid.zone_surf, l_min, zones.f_pair)
    if zone_shard:
        em_zones = [pmesh.zone_slice(mesh, x) for x in em_zones]
    ve = volume_em(tables.e_ph, tables.gnt, *em_zones[:-1], state.dt,
                   scales, f_pair=em_zones[-1])
    if zone_shard:
        ve = pmesh.zone_gather(mesh, ve, nz, nr)[0]
    # every rank sources its share of nst, weighted over the global count
    nst_eff = cfg.source.nst * max(cfg.source.split, 1)
    budget = sourcing.compute_budget(
        src, ve.eloss_tot, ecens_prev, state.ed_abs,
        grid.area_lower, grid.area_upper, grid.area_inner, grid.area_outer,
        state.dt, state.dt_prev, max(nst_eff // world, 1),
        cfg.source.bias_cap, scales.sigma_sb,
        dh_sentinel=bool(phys.dh_sentinel), replicas=world,
    )

    # census population control (weight-window roulette)
    if run.census_rr:
        u_rr = torch.rand(n, generator=gen, device=dev)
        photons, e_rr, n_rr = census_roulette(
            photons, u_rr, run.census_rr_hi, run.census_rr_lo,
            n_reserve=budget.n_new,
        )
    else:
        e_rr = torch.zeros((), dtype=f32, device=dev)
        n_rr = torch.zeros((), dtype=i32, device=dev)

    # ---- 1c. zone sort (the flight kernel's windowed mode) --------------
    # the windowed mode gives each 1024-slot tile a 2*WIN_Z-zone window:
    # sort the census by zone bucket, dead slots last, so that emission
    # fills the free tail in zone order and the tiles stay zone-coherent
    tracker = select_tracker(cfg, world)
    win_z = flight.window_z(nz, nr) if tracker == "kernel" else 0
    if win_z:
        photons = zone_sort(photons, nz, nr, win_z)

    # ---- 1b. pair physics from the census field (imcgen2d.f:354-396) ----
    if phys.pair_switch:
        pf = pair_fields(photons, zones, tables, pair_tables, grid, scales,
                         nz, nr, mesh, zone_shard)
        state = state._replace(k_gg=pf.k_gg, dn_pp=pf.dn_pp,
                               dne_pa=pf.dne_pa, dnp_pa=pf.dnp_pa)
        nph_raw, nph_fit = pf.nph_raw, pf.nph_fit
    else:
        nph_raw = torch.zeros((nz, nr, g.n_gg), dtype=f32, device=dev)
        nph_fit = nph_raw

    # ---- 2. emit new photons --------------------------------------------
    draws = sourcing.draw_emit_uniforms(gen, n, dev)
    photons, e_src_lost = sourcing.emit(
        photons, draws, budget, src, grid.r_edges, grid.z_edges,
        grid.zone_surf, ve.eps_tot, ve.eps_th, ve.eloss_th, ve.eloss_tot,
        tables.e_ph, state.dt, nz, nr, c_scaled=scales.c,
    )

    # ---- 3. tracking ----------------------------------------------------
    # pairs add 2 f_pair scatterers per electron (imctrk2d.f:164-168)
    f_pair = zones.f_pair if phys.pair_switch else None
    n_scat = zones.n_e * (1.0 + 2.0 * f_pair) if phys.pair_switch \
        else zones.n_e
    sigma_zone = zone_sigma_table(
        tables.sigma_e, zones.f_nt, tables.gnt, zones.n_e, f_pair
    ).reshape(nzr, -1).to(f32)
    kappa_zone = ve.kappa_tot.reshape(nzr, -1).to(f32)
    ctx = TrackContext(
        r_edges=grid.r_edges.to(f32),
        z_edges=grid.z_edges.to(f32),
        opac_zone=torch.stack([sigma_zone, kappa_zone], dim=-1),
        cdf_nt=zones.cdf_nt.reshape(nzr, -1).to(f32),
        gnt=tables.gnt,
        e_ph_log0=float(tables.e_ph_log0),
        e_ph_dlog=float(tables.e_ph_dlog),
        e_gg_log0=tables.e_gg_log0,
        e_gg_dlog=tables.e_gg_dlog,
        e_field_log0=torch.log(tables.e_field[0]),
        e_field_dlog=torch.log(tables.e_field[1] / tables.e_field[0]),
        hu=tables.hu,
        mu_edges=tables.mu_edges,
        lc_lo=tables.lc_lo,
        lc_hi=tables.lc_hi,
        tbbl_pos=src.tbb_lower > 0.0,
        time=state.time,
        dt=state.dt,
        inv_c=float(np.float32(scales.inv_c)),
        # 1/(n_eff sigma_T L F_tot): the stratified-scatter normalizer
        # (Z = <sigma_KN ratio> = sig_s * inv_nsigt, the quadrature of
        # zone_sigma_table)
        inv_nsigt=1.0 / torch.clamp_min(
            n_scat.reshape(-1).to(f32)
            * float(np.float32(SIGMA_T * scales.L))
            * torch.sum(zones.f_nt[..., :-1] * torch.diff(tables.gnt),
                        dim=-1).reshape(-1).to(f32),
            1e-38,
        ),
        kgg_zone=state.k_gg.reshape(nzr, -1).to(f32),
        e_ref=tables.e_ref,
        p_ref_t=tables.p_ref.T.contiguous() if phys.cr_sent else None,
        w_abs_t=tables.w_abs.T.contiguous() if phys.cr_sent else None,
    )
    strat_icut = 0
    if cfg.source.strat_split:
        # the gnt index of the tail boundary gamma_c (gnt holds gamma - 1)
        strat_icut = int(np.searchsorted(gnt_grid(g.num_nt),
                                         cfg.source.strat_gamma_c - 1.0))
        strat_icut = min(max(strat_icut, 1), g.num_nt - 1)
    st = TrackStatics(
        nz=nz, nr=nr, cr_sent=phys.cr_sent, rmin_positive=g.r_min > 1e-10,
        max_iters=run.max_flight_iters,
        max_scatter_tries=run.max_scatter_tries,
        weight_floor=cfg.source.weight_floor, spec_switch=phys.spec_switch,
        pair_switch=bool(phys.pair_switch),
        strat_split=cfg.source.strat_split, strat_icut=strat_icut,
        strat_p_max=cfg.source.strat_p_max,
        strat_copies=cfg.source.strat_copies, tracker=tracker,
    )
    tallies = Tallies.zeros(nz, nr, g.num_nt, g.nphfield, g.n_gg, g.nmu,
                            g.nphtotal, g.nph_lc, device=dev)
    events = EventBuffer.empty(run.event_capacity, device=dev)
    tallies = tallies._replace(
        e_src_lost=tallies.e_src_lost + e_src_lost,
        e_rr=tallies.e_rr + e_rr,
        n_rr=tallies.n_rr + n_rr,
    )
    n_tracked = torch.sum(photons.alive.to(i32), dtype=i32)
    photons, tallies, events = transport_step(
        photons, tallies, events, gen, ctx, st)
    tallies = census_tally(photons, tallies, ctx, st)
    if mesh is not None:
        # the reference's MPI_REDUCE trees (xec2d.f:325-399), in rank order
        tallies, n_tracked = pmesh.all_gather_sum(mesh, (tallies, n_tracked))

    # ---- 4. FP electron update (update2d) -------------------------------
    zero = torch.zeros((), dtype=f32, device=dev)
    zero_i = torch.zeros((), dtype=i32, device=dev)
    dt_next = state.dt
    if not phys.t_const:
        fp_args = (
            flare_zones(zones, grid, phys.flare, state.time, scales),
            tallies.n_field, tables, grid.vol, float(g.z_max), grid.dz,
            state.dt, state.time, ve.eloss_sy, phys, scales)
        fp_kw = dict(eloss_br=ve.eloss_br, dn_pp=state.dn_pp,
                     dne_pa=state.dne_pa, dnp_pa=state.dnp_pa,
                     coulomb=None)
        fpr = (fp_zone_farm(mesh, fp_args, fp_kw) if zone_shard
               else fp_step(*fp_args, **fp_kw))
        # only apply after the field is established (ncycle > 0); the
        # flare's tna / turb_lev are the FP solve's alone (update2d.f:558)
        apply = ncycle > 0
        zones_new = (fpr.zones._replace(tna=zones.tna,
                                        turb_lev=zones.turb_lev)
                     if apply else zones)
        dT_max = fpr.dT_max if apply else zero
        e_el_old, e_el_new = fpr.e_el_old, fpr.e_el_new
        fp_sub = fpr.substeps
        fp_inc = fpr.incomplete if apply else zero_i
        if run.adaptive_dt and apply:
            dt_next = adapt_dt(fpr.dt_new, grid, scales).to(state.dt.dtype)
    else:
        zones_new = zones
        dT_max, e_el_old, e_el_new = zero, zero, zero
        fp_sub, fp_inc = zero_i, zero_i

    # ---- 5. advance time (xec2d.f:100-106) --------------------------------
    new_state = state._replace(
        zones=zones_new,
        photons=photons,
        time=state.time + state.dt,
        dt=dt_next,
        dt_prev=state.dt,
        ncycle=state.ncycle + 1,
        ed_abs=tallies.ed_in - tallies.ed_ref,
        ed_ref=tallies.ed_ref,
    )
    out = StepOutputs(
        tallies=tallies, events=events, bingo=budget.bingo,
        e_el_old=e_el_old, e_el_new=e_el_new, dT_max=dT_max,
        fp_substeps=fp_sub, fp_incomplete=fp_inc, n_tracked=n_tracked,
        nph_raw=nph_raw, nph_fit=nph_fit,
    )
    return new_state, out




class Reference:
    """What the step reads besides the state, worked out from the
    configuration alone: the scales, the grid, the tables and the boundary
    sources (the program's ``Simulation.__init__``, frozen)."""

    def __init__(self, cfg: SimConfig, zone_init: ZoneInit, device,
                 mesh: Optional[pmesh.PhotonMesh] = None):
        from c2dref.grid import initial_dt, make_grid
        from c2dref.state import init_zone_state
        from c2dref.tables import build_pair_tables, build_tables
        from c2dref.units import make_scales

        if cfg.physics.fp_include_coulomb:
            raise NotImplementedError("the Coulomb drift is not frozen here")
        self.cfg, self.mesh, self.device = cfg, mesh, torch.device(device)
        self.scales = make_scales(
            cfg.grid.z_max, cfg.grid.r_max,
            cfg.run.energy_scale or _estimate_energy_scale(cfg, zone_init))
        self.grid = make_grid(cfg.grid, self.scales.L, self.device)
        self.tables = build_tables(cfg.grid, self.scales.L, self.device)
        self.zones0 = init_zone_state(cfg, zone_init, self.tables)
        self.dt0 = initial_dt(self.grid, cfg.run.mcdt,
                              cfg.physics.injection.v,
                              length_scale=self.scales.L)
        self.pair_tables = (build_pair_tables(cfg.grid, self.scales.L,
                                              self.device)
                            if cfg.physics.pair_switch else None)
        self.sources = build_window_sources(cfg, self.scales, self.device)

    def step(self, state: SimState, time: float, dt: float, ncycle: int
             ) -> Tuple[SimState, StepOutputs]:
        """One step from ``state``, whose clock the host reads as ``time``,
        ``dt`` and ``ncycle``; ``state.key`` is advanced in place."""
        src = self.sources.select(time, dt, ncycle)
        return _step_impl(state, src, self.grid, self.tables, self.cfg,
                          self.scales, ncycle, self.pair_tables, None,
                          self.mesh)
