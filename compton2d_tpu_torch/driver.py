"""Simulation driver: the per-step orchestration and time loop
(counterpart of ``compton2d_tpu.driver``).

One step runs the reference's phase order on one device: census clock
reset, zone pass (B field, emissivities, budget), census roulette, the
zone sort of the census (grids above 1024 zones on the flight kernel),
the pair fields from the census (pair_switch), emission, tracking,
census tallies, the Fokker-Planck electron (and positron) update (with a
coronal flare's boost of the zones it sees, and the Coulomb drift under
``fp_include_coulomb``) and the time advance. dt is constant, as in the
reference's active code, unless ``run.adaptive_dt`` applies the FP
solve's dt ladder.

The port covers the reference's options: thermal and file-spectrum
boundaries with their time windows, Compton reflection (cr_sent 1-4),
synchrotron volume emission and shock injection, census roulette,
stratified tail splitting, gamma-gamma pair physics, coronal flares,
adaptive dt and the Coulomb FP drift. Tracking runs on the flight
kernel or on the lock-step loop, as ``run.pallas_tracking`` selects
(:func:`select_tracker`); ``Simulation.tracker`` says which. What a step
takes from the configuration, tables, grid and ranks alone is made once
(:func:`step_constants`).

Under a photon mesh (``parallel.mesh``: one process a rank) each rank
owns ``n_slots / world`` slots, sources ``nst / world`` photons a step
with weights over the global count and draws from its own random stream;
the census energy, the pair field and the tallies are summed over the
ranks in rank order, so every rank holds the same zone state and tallies.
Under ``run.zone_shard`` the zone-batched phases (``volume_em``, the pair
tensors, the FP solve) run on each rank's slice of the zones and are
gathered (the reference's zone farm, update2d.f:190-214). Rank 0 alone
writes the run outputs and the dumps; every rank writes its own event
file and checkpoint shard.

Run-level outputs (``attach_outputs``): the escaping spectrum, light
curves and temperature profile accumulate on the host from each step's
tallies, and each step's event records go to a reference-format event
file; ``run_to_stop`` advances to ``t_stop`` and writes them, or saves a
checkpoint when the walltime guard stops it first (``io.checkpoint``;
a resumed run appends to the event file). Diagnostics:
``write_diagnostics`` (the reference's dumps) and
``Simulation.photon_fill_diagnostic`` (the cycle-1 thermal rates).
"""
from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.config import SimConfig, TimeWindow, ZoneInit
from compton2d_tpu_torch.units import Scales, make_scales
from compton2d_tpu_torch.fp.update import (FPConstants, FPResult,
                                           fp_constants, fp_step,
                                           photon_fill)
from compton2d_tpu_torch.grid import Grid, initial_dt, make_grid
from compton2d_tpu_torch.io import outputs as outs
from compton2d_tpu_torch.io.checkpoint import WalltimeGuard, save_checkpoint
from compton2d_tpu_torch.io.events import EventFileWriter
from compton2d_tpu_torch.io.legacy import external_spectrum
from compton2d_tpu_torch.io.outputs import OutputAccumulator
from compton2d_tpu_torch.parallel import mesh as pmesh
from compton2d_tpu_torch.parallel.distributed import process_event_path
from compton2d_tpu_torch.physics import emissivity_extras as ex
from compton2d_tpu_torch.physics.compton import SIGMA_T, zone_sigma_table
from compton2d_tpu_torch.physics.coulomb import (
    CoulombTables,
    build_coulomb_tables,
)
from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.physics.emissivity import equipartition_b, volume_em
from compton2d_tpu_torch.physics import pairs, planck
from compton2d_tpu_torch.state import (
    EventBuffer,
    PhotonArray,
    SimState,
    Tallies,
    ZoneState,
    init_zone_state,
)
from compton2d_tpu_torch.tables import (
    PairTables,
    Tables,
    build_pair_tables,
    build_tables,
)
from compton2d_tpu_torch.transport import flight, sourcing
from compton2d_tpu_torch.transport.population import (
    census_roulette,
    zone_sort,
)
from compton2d_tpu_torch.transport.tracking import (
    TrackContext,
    TrackStatics,
    census_tally,
    hist2d,
    loggrid_bin,
    segment_sum,
    strat_fractions,
    transport_step,
)

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
            star_dilution=f(dilution), planck_cdf=f(planck.CDF_M),
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


def check_slice(cfg: SimConfig, world: int, tracker: str) -> None:
    """Raise ValueError for slots that do not split evenly over the
    ``world`` ranks and, on the flight kernel (``tracker``, as
    :func:`select_tracker` chose it), NotImplementedError for a grid edge
    above flight.MAX_EDGE and ValueError for ranks' slots that are not
    whole flight.TILE tiles."""
    if cfg.run.n_slots % world:
        raise ValueError(f"n_slots={cfg.run.n_slots} must split evenly "
                         f"over {world} ranks")
    if tracker == "kernel":
        flight.window_z(cfg.grid.nz, cfg.grid.nr)   # raises above 127
        if cfg.run.n_slots % (world * flight.TILE):
            raise ValueError(
                f"n_slots={cfg.run.n_slots} must be a multiple of {world} "
                f"ranks x {flight.TILE} on the flight kernel")


class StepConstants(NamedTuple):
    """What every step of a run takes from its configuration, tables,
    grid, scales and ranks alone, made once by :func:`step_constants`:
    a step re-derives and uploads none of it."""

    cfg: SimConfig
    grid: Grid
    tables: Tables
    scales: Scales
    pair_tables: Optional[PairTables]
    coulomb_tables: Optional[CoulombTables]
    track: TrackStatics       # with the tracker and the strat cut
    ctx: TrackContext         # its per-run fields; a step sets the rest
    fp: FPConstants
    rr_target: torch.Tensor   # () the census roulette's survivor target
    l_min: torch.Tensor       # (nz, nr) the zones' least extent [L]
    # () the least dt the FP ladder sets, min(dr_min, dz) L / c
    # (update2d.f:257)
    dt_min: torch.Tensor
    win_z: int                # the zone sort's bucket (0: no sort)
    zone_shard: bool          # the zone-batched phases on the zone farm


def step_constants(cfg: SimConfig, grid: Grid, tables: Tables,
                   scales: Scales, tracker: str, world: int = 1,
                   pair_tables: Optional[PairTables] = None,
                   coulomb_tables: Optional[CoulombTables] = None
                   ) -> StepConstants:
    """The StepConstants of ``cfg`` on ``world`` ranks with the tracker
    ``tracker`` (:func:`select_tracker`)."""
    g, phys, run, src = cfg.grid, cfg.physics, cfg.run, cfg.source
    f32, dev = torch.float32, grid.vol.device
    strat_icut = 0
    if src.strat_split:
        # the gnt index of the tail boundary gamma_c (gnt holds gamma - 1)
        strat_icut = int(np.searchsorted(gnt_grid(g.num_nt),
                                         src.strat_gamma_c - 1.0))
        strat_icut = min(max(strat_icut, 1), g.num_nt - 1)
    st = TrackStatics(
        nz=g.nz, nr=g.nr, cr_sent=phys.cr_sent,
        rmin_positive=g.r_min > 1e-10, max_iters=run.max_flight_iters,
        max_scatter_tries=run.max_scatter_tries,
        weight_floor=src.weight_floor, spec_switch=phys.spec_switch,
        pair_switch=bool(phys.pair_switch), strat_split=src.strat_split,
        strat_icut=strat_icut, strat_p_max=src.strat_p_max,
        strat_copies=src.strat_copies, tracker=tracker,
    )
    e_field = tables.e_field
    ctx = TrackContext(
        r_edges=grid.r_edges.to(f32), z_edges=grid.z_edges.to(f32),
        opac_zone=None, cdf_nt=None, gnt=tables.gnt,
        e_ph_log0=float(tables.e_ph_log0), e_ph_dlog=float(tables.e_ph_dlog),
        e_gg_log0=tables.e_gg_log0, e_gg_dlog=tables.e_gg_dlog,
        e_field_log0=torch.log(e_field[0]),
        e_field_dlog=torch.log(e_field[1] / e_field[0]),
        hu=tables.hu, mu_edges=tables.mu_edges, lc_lo=tables.lc_lo,
        lc_hi=tables.lc_hi, tbbl_pos=None, time=None, dt=None,
        inv_c=float(np.float32(scales.inv_c)), e_ref=tables.e_ref,
        p_ref_t=tables.p_ref.T.contiguous() if phys.cr_sent else None,
        w_abs_t=tables.w_abs.T.contiguous() if phys.cr_sent else None,
        guide_u=torch.as_tensor(flight.guide_u_edges(), device=dev),
        e_gg_host=(float(tables.e_gg_log0), float(tables.e_gg_dlog)),
        strat_frac=strat_fractions(src.strat_copies, dev),
    )
    return StepConstants(
        cfg=cfg, grid=grid, tables=tables, scales=scales,
        pair_tables=pair_tables, coulomb_tables=coulomb_tables, track=st,
        ctx=ctx, fp=fp_constants(tables.gnt, float(g.z_max), phys),
        rr_target=torch.tensor(run.census_rr_lo * (run.n_slots // world),
                               dtype=f32, device=dev),
        l_min=torch.minimum(grid.dz, grid.dr) * torch.ones_like(grid.vol),
        dt_min=torch.minimum(torch.min(torch.diff(grid.r_edges)), grid.dz)
        * float(np.float32(scales.L / cn.C_LIGHT)),
        win_z=flight.window_z(g.nz, g.nr) if tracker == "kernel" else 0,
        zone_shard=world > 1 and run.zone_shard and g.nz * g.nr >= world,
    )


def _held(name: str):
    """A Simulation attribute that its StepConstants hold: setting it
    remakes them, so that the next step sees the new value."""

    def put(sim: "Simulation", value) -> None:
        c = sim.consts._replace(**{name: value})
        sim.consts = step_constants(
            c.cfg, c.grid, c.tables, c.scales, sim.tracker,
            1 if sim.mesh is None else sim.mesh.world, c.pair_tables,
            c.coulomb_tables)
    return property(lambda sim: getattr(sim.consts, name), put)


class Simulation:
    """Owns the configuration, tables, state and random stream.

    ``device`` is where every tensor lives (under a photon ``mesh`` the
    mesh's device, of which ``device`` must name the type); the random
    stream is a ``torch.Generator`` on that device
    seeded from ``cfg.run.seed`` (``state.key``), and under a mesh from
    ``pmesh.rank_seed(seed, rank)``, so that a mesh of one rank runs as
    ``mesh=None``. Under a mesh ``state.photons`` holds the rank's
    ``n_slots / world`` slots and everything else is the same on every
    rank. Host clock mirror: time/dt/ncycle advance
    deterministically, so the driver tracks them on the host instead of
    reading the device scalars each step (under ``adaptive_dt`` it reads
    the new dt back after each step); assigning ``sim.state`` marks the
    mirror dirty and the next ``step()`` resyncs it. ``cfg``, ``grid``,
    ``tables``, ``scales``, ``pair_tables`` and ``coulomb_tables`` are
    read from ``consts``, the run's :func:`step_constants`.
    """

    cfg, grid, tables, scales, pair_tables, coulomb_tables = map(_held, (
        "cfg", "grid", "tables", "scales", "pair_tables", "coulomb_tables"))
    # "kernel" or "loop": the tracker every step runs (select_tracker)
    tracker = property(lambda sim: sim.consts.track.tracker)

    @property
    def state(self) -> SimState:
        return self._state

    @state.setter
    def state(self, s: SimState):
        self._state = s
        self._clock_dirty = True

    def _sync_clock(self):
        if getattr(self, "_clock_dirty", True):
            s = self._state
            self._host_time = tm.read("step.clock", s.time, float)
            self._host_dt = tm.read("step.clock", s.dt, float)
            self._host_dt_prev = tm.read("step.clock", s.dt_prev, float)
            self._host_ncycle = tm.read("step.clock", s.ncycle, int)
            self._clock_dirty = False

    def __init__(self, cfg: SimConfig, zone_init: Optional[ZoneInit] = None,
                 *, device="cuda", mesh: Optional[pmesh.PhotonMesh] = None):
        world = 1 if mesh is None else mesh.world
        tracker = select_tracker(cfg, world)
        check_slice(cfg, world, tracker)
        self.mesh = mesh
        self.device = torch.device(device)
        if mesh is not None:
            if self.device.type != mesh.device.type or self.device.index \
                    not in (None, mesh.device.index):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        dev = self.device
        if zone_init is None:
            zone_init = ZoneInit.uniform(cfg.grid)
        self.zone_init = zone_init
        e_scale = cfg.run.energy_scale or _estimate_energy_scale(
            cfg, zone_init)
        scales = make_scales(cfg.grid.z_max, cfg.grid.r_max, e_scale)
        grid = make_grid(cfg.grid, scales.L, dev)
        tables = build_tables(cfg.grid, scales.L, dev)
        zones = init_zone_state(cfg, zone_init, tables)
        dt0 = initial_dt(grid, cfg.run.mcdt, cfg.physics.injection.v,
                         length_scale=scales.L)
        g = cfg.grid
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.run.seed) if mesh is None
                        else pmesh.rank_seed(int(cfg.run.seed), mesh.rank))

        def zf(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def scal(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=dev)

        self.state = SimState(
            zones=zones,
            photons=PhotonArray.empty(cfg.run.n_slots // world, dev),
            time=scal(0.0), dt=scal(dt0), dt_prev=scal(dt0),
            ncycle=scal(0, torch.int32), key=gen,
            ed_abs=zf(g.nr), ed_ref=zf(g.nr),
            k_gg=zf(g.nz, g.nr, g.n_gg), dn_pp=zf(g.nz, g.nr, g.num_nt),
            dne_pa=zf(g.nz, g.nr, g.num_nt), dnp_pa=zf(g.nz, g.nr, g.num_nt),
        )
        self.consts = step_constants(
            cfg, grid, tables, scales, tracker, world,
            build_pair_tables(cfg.grid, scales.L, dev)
            if cfg.physics.pair_switch else None,
            build_coulomb_tables(tables.gnt.cpu().numpy(),
                                 lnL=cfg.physics.lnL, device=dev)
            if cfg.physics.fp_include_coulomb else None)
        self.window_sources = build_window_sources(cfg, scales, dev)
        self.src_static = self.window_sources.select(0.0, dt0, 0)
        self.last_outputs: Optional[StepOutputs] = None
        self.outputs: Optional[OutputAccumulator] = None
        self.event_writer: Optional[EventFileWriter] = None

    @property
    def writes_outputs(self) -> bool:
        """Whether this process writes the run outputs (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def with_config(self, cfg: SimConfig) -> "Simulation":
        """A fresh Simulation with a modified config and THIS sim's zone
        initialization, device and mesh."""
        return Simulation(cfg, self.zone_init, device=self.device,
                          mesh=self.mesh)

    def attach_outputs(self, out_dir: str, event_file: str = "evb.dat",
                       resume: bool = False):
        """Enable run-level output accumulation and event-file spooling
        (the reference's graphics and pNNN_evb.dat outputs). With
        ``resume`` (a run continued from a checkpoint) the event file is
        appended to; otherwise it starts empty. The run-level accumulator
        starts empty either way: a checkpoint does not hold it, as the
        reference's does not. Under a mesh every rank writes its own
        records to ``pNNN_<event_file>`` (``process_event_path``) and rank 0
        alone accumulates the run outputs."""
        self.out_dir = out_dir
        if self.writes_outputs:
            self.outputs = OutputAccumulator(
                self.tables.hu.cpu().numpy(),
                self.tables.mu_edges.cpu().numpy(),
                self.cfg.grid.lc_bands, self.scales.E,
            )
        path = os.path.join(out_dir, event_file)
        if self.mesh is not None:
            path = process_event_path(path, self.mesh.rank)
        self.event_writer = EventFileWriter(path, self.scales.E,
                                            append=resume)
        return self

    def step(self) -> StepOutputs:
        with tm.span("step"):
            self._sync_clock()
            self.src_static = self.window_sources.select(
                self._host_time, self._host_dt, self._host_ncycle)
            self._state, out = _step_impl(
                self._state, self.src_static, self._host_ncycle, self.mesh,
                self.consts)
            self._host_time += self._host_dt
            self._host_dt_prev = self._host_dt
            self._host_ncycle += 1
            if self.cfg.run.adaptive_dt:
                # the FP ladder picked the next dt on the device: read it back
                self._host_dt = tm.read("step.dt", self._state.dt, float)
            self.last_outputs = out
            with tm.span("step.outputs"):
                if self.event_writer is not None:
                    self._check_event_overflow(out)
                    self.event_writer.write(out.events)
                if self.outputs is not None:
                    t = out.tallies
                    self.outputs.add_step(
                        t._replace(fout=tm.read("step.outputs", t.fout,
                                                tm.to_host),
                                   edout=tm.read("step.outputs", t.edout,
                                                 tm.to_host)),
                        self._host_time - self._host_dt_prev,
                        self._host_dt_prev,
                        tea=tm.read("step.outputs", self.state.zones.tea,
                                    tm.to_host).numpy(),
                    )
            return out

    def run(self, n_steps: int):
        for _ in range(n_steps):
            self.step()
        return self.last_outputs

    def run_to_stop(self, walltime_budget_s: float = 0.0,
                    checkpoint_path: Optional[str] = None,
                    max_steps: int = 1_000_000,
                    verbose: bool = False) -> bool:
        """Advance until time - dt_prev >= t_stop (xec2d.f:110) and write
        the attached outputs. Returns False, without writing them, when
        the walltime guard (xec2d.f:50-55) stops the run first, after
        saving the state to ``checkpoint_path`` (when given) with its
        ``ncycle`` and ``time`` (``io.checkpoint.save_checkpoint``).

        Under a mesh the ranks take the guard's decision together (the
        largest of their flags, each step): every rank checkpoints and
        returns False on the same step, so no rank waits for ever in a
        collective that the others left (the JAX package decides per
        process)."""
        guard = WalltimeGuard(
            walltime_budget_s or self.cfg.run.walltime_budget_s,
            self.cfg.run.checkpoint_frac,
        )
        for _ in range(max_steps):
            self._sync_clock()
            if self._host_time - self._host_dt_prev >= self.cfg.run.t_stop:
                break
            stop = guard.should_checkpoint()
            if self.mesh is not None:
                stop = bool(pmesh.all_max(self.mesh, torch.tensor(
                    int(stop), dtype=torch.int32, device=self.device)))
            if stop:
                if checkpoint_path:
                    save_checkpoint(
                        checkpoint_path, self.state,
                        {"ncycle": int(self.state.ncycle),
                         "time": float(self.state.time)}, mesh=self.mesh)
                return False
            self.step()
            if verbose:
                print(self.summary())
        if self.outputs is not None:
            self.finalize_outputs()
        return True

    def finalize_outputs(self):
        """Write spectrum.dat, photons.dat, the light curves lc_muNN.dat and
        temp_profile.dat into the output directory."""
        with tm.span("run.finalize"):
            elapsed = (tm.read("run.finalize", self.state.time, float)
                       + tm.read("run.finalize", self.state.dt, float))
            self.outputs.write_spectrum(
                os.path.join(self.out_dir, "spectrum.dat"), elapsed)
            self.outputs.write_spectrum(
                os.path.join(self.out_dir, "photons.dat"), elapsed,
                photons=True)
            self.outputs.write_light_curves(os.path.join(self.out_dir, "lc"))
            self.outputs.write_temperature_profile(
                os.path.join(self.out_dir, "temp_profile.dat"),
                tm.read("run.finalize", self.grid.r_edges,
                        tm.to_host).numpy() * self.scales.L,
                n_e=tm.read("run.finalize", self.state.zones.n_e,
                            tm.to_host).numpy(),
            )

    # ---------------- diagnostics -------------------------------------
    def photon_fill_diagnostic(self):
        """The cycle-1 explicit thermal-rate table (photon_fill,
        update2d.f:1747-1921), which the reference logs for ncycle <= 1
        before the FP farm, from the last step's tallied radiation field
        and the emissivities of the current zones over dt_prev."""
        if self.last_outputs is None:
            raise RuntimeError("run at least one step first")
        zones, grid = self.state.zones, self.grid
        ve = volume_em(self.tables.e_ph, self.tables.gnt, zones.f_nt,
                       zones.tea, zones.n_e, zones.B_field, zones.amxwl,
                       grid.vol, grid.zone_surf, self.consts.l_min,
                       self.state.dt_prev,
                       self.scales, f_pair=zones.f_pair)
        return photon_fill(
            zones, self.last_outputs.tallies.n_field, self.tables, grid.vol,
            self.state.dt_prev, ve.eloss_sy, ve.eloss_br, self.cfg.physics,
            self.scales)

    def _check_event_overflow(self, out) -> int:
        """Warn about escaping-photon records dropped beyond capacity."""
        if getattr(self, "_overflow_checked", None) is out:
            return getattr(self, "n_events_dropped", 0)
        self._overflow_checked = out
        counts = tm.read("step.events", out.events.count,
                         tm.to_host).numpy().reshape(-1)
        cap = out.events.data.shape[0] // counts.shape[0]
        dropped = int(np.sum(np.maximum(counts - cap, 0)))
        if dropped:
            self.n_events_dropped = getattr(self, "n_events_dropped", 0) \
                + dropped
            warnings.warn(
                f"step {int(self.state.ncycle)}: {dropped} escaping-photon "
                f"event records dropped (buffer capacity {cap}); raise "
                "RunConfig.event_capacity", RuntimeWarning, stacklevel=2,
            )
        return getattr(self, "n_events_dropped", 0)

    def summary(self) -> str:
        """One line on the last step (under a mesh ``census`` counts this
        rank's slots)."""
        o = self.last_outputs
        s = self.state
        esc = float(torch.sum(o.tallies.fout)) * self.scales.E
        alive = int(torch.sum(s.photons.alive))
        self._check_event_overflow(o)
        extras = ""
        if int(o.tallies.n_rr):
            extras += f" rr={int(o.tallies.n_rr)}"
        if float(o.tallies.e_src_lost):
            extras += (f" src_lost="
                       f"{float(o.tallies.e_src_lost) * self.scales.E:.2e}")
        if getattr(self, "n_events_dropped", 0):
            extras += f" evt_dropped={self.n_events_dropped}"
        if int(o.fp_incomplete):
            extras += f" fp_incomplete={int(o.fp_incomplete)}"
        if int(o.tallies.n_sct_overflow):
            extras += f" sct_overflow={int(o.tallies.n_sct_overflow)}"
        if self.mesh is not None:
            extras += f" rank={self.mesh.rank}/{self.mesh.world}"
        extras += f" tracker={self.tracker}"
        return (
            f"cycle={int(s.ncycle)} t={float(s.time):.4e}s "
            f"dt={float(s.dt):.3e}s census={alive} "
            f"E_in={float(o.bingo) * self.scales.E:.4e} E_esc={esc:.4e} "
            f"Te[0,0]={float(s.zones.tea[0, 0]):.2f}keV "
            f"dT_max={float(o.dT_max):.3f}" + extras
        )

    def energy_audit(self) -> dict:
        """E_add_up-style photon-side audit (update2d.f:1993-2078) in erg."""
        o = self.last_outputs
        t = o.tallies
        scale = self.scales.E
        census = float(torch.sum(t.ecens)) * scale
        escaped = float(
            torch.sum(t.erlk_inner) + torch.sum(t.erlk_outer)
            + torch.sum(t.erlk_upper) + torch.sum(t.erlk_lower)
        ) * scale
        deposited = float(torch.sum(t.edep)) * scale
        killed = float(t.e_killed) * scale
        scatter_gain = float(t.e_scatter) * scale
        src_lost = float(t.e_src_lost) * scale
        pair_abs = float(t.e_pair_abs) * scale
        absorbed = deposited - scatter_gain
        e_in = float(o.bingo) * scale
        e_rr = float(t.e_rr) * scale
        avail = e_in - src_lost + scatter_gain - e_rr
        return {
            "input": e_in,
            "census": census,
            "escaped": escaped,
            "absorbed": absorbed,
            "scatter_gain": scatter_gain,
            "killed": killed,
            "src_lost": src_lost,
            "pair_abs": pair_abs,
            "rr": e_rr,
            "n_rr": int(t.n_rr),
            "events_dropped": self._check_event_overflow(o),
            "balance": (census + escaped + absorbed + killed + pair_abs)
            / avail if avail > 0 else float("nan"),
        }


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
    with tm.span("pairs.field"):
        gbin, in_gg = loggrid_bin(photons.e, tables.e_gg_log0,
                                  tables.e_gg_dlog, ngg)
        on_grid = photons.alive & in_gg
        if tm.enabled():
            tm.count("pairs.gg_photons", torch.sum(on_grid))
        cnts = torch.where(on_grid,
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
    with tm.span("pairs.fit"):
        nph_sm = pairs.nph_smooth(nph_z, egg32, tea_z)
        if tm.enabled():
            tm.count("pairs.fit_zones", torch.sum(pairs.fitted(nph_z)))
    with tm.span("pairs.rates"):
        k_gg = torch.matmul(nph_sm, pair_tables.kgg_mat.T)
        dn_pp = pairs.dn_pp_from_field(nph_sm, pair_tables.pp_tensor)
        dne_pa, dnp_pa = pairs.pa_rates(f_z, npos_z, ne_z,
                                        pair_tables.vsigma,
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


def _step_impl(state: SimState, src: sourcing.SourceStatic, ncycle: int,
               mesh: Optional[pmesh.PhotonMesh], const: StepConstants
               ) -> Tuple[SimState, StepOutputs]:
    """One step with the run's constants ``const`` (:func:`step_constants`).
    ``ncycle`` is the host mirror of ``state.ncycle``. Under a ``mesh``,
    ``state.photons`` are this rank's slots (the order of the JAX
    package's sharded step, compton2d_tpu/driver.py:736-1192)."""
    cfg, grid, tables, scales = const.cfg, const.grid, const.tables, \
        const.scales
    g, phys, run = cfg.grid, cfg.physics, cfg.run
    nz, nr = g.nz, g.nr
    nzr = nz * nr
    zones = state.zones
    gen = state.key
    dev = state.dt.device
    f32, i32 = torch.float32, torch.int32
    n = state.photons.n_slots
    world = 1 if mesh is None else mesh.world
    zone_shard = const.zone_shard

    # ---- 0. census replay: reset flight clocks (imcfield2d.f:117) -------
    with tm.span("step.census"):
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
    with tm.span("step.zone_pass"):
        B = equipartition_b(zones.ep_switch, zones.tea, zones.tna, zones.n_e,
                            zones.f_pair, zones.B_field,
                            tables.gamma_bar.forward)
        zones = zones._replace(B_field=B)
        em_zones = (zones.f_nt, zones.tea, zones.n_e, B, zones.amxwl, grid.vol,
                    grid.zone_surf, const.l_min, zones.f_pair)
        if zone_shard:
            em_zones = [pmesh.zone_slice(mesh, x) for x in em_zones]
        ve = volume_em(tables.e_ph, tables.gnt, *em_zones[:-1], state.dt,
                       scales, f_pair=em_zones[-1])
        if zone_shard:
            ve = pmesh.zone_gather(mesh, ve, nz, nr)[0]
    # every rank sources its share of nst, weighted over the global count
    with tm.span("step.source"):
        nst_eff = cfg.source.nst * max(cfg.source.split, 1)
        budget = sourcing.compute_budget(
            src, ve.eloss_tot, ecens_prev, state.ed_abs,
            grid.area_lower, grid.area_upper, grid.area_inner, grid.area_outer,
            state.dt, state.dt_prev, max(nst_eff // world, 1),
            cfg.source.bias_cap, scales.sigma_sb,
            dh_sentinel=bool(phys.dh_sentinel), replicas=world,
        )

    # census population control (weight-window roulette)
    with tm.span("step.census"):
        if run.census_rr:
            u_rr = torch.rand(n, generator=gen, device=dev)
            photons, e_rr, n_rr = census_roulette(
                photons, u_rr, run.census_rr_hi, const.rr_target,
                n_reserve=budget.n_new,
            )
        else:
            e_rr = torch.zeros((), dtype=f32, device=dev)
            n_rr = torch.zeros((), dtype=i32, device=dev)

        # ---- 1c. zone sort (the flight kernel's windowed mode) --------------
        # the windowed mode gives each 1024-slot tile a 2*WIN_Z-zone window:
        # sort the census by zone bucket, dead slots last, so that emission
        # fills the free tail in zone order and the tiles stay zone-coherent
        if const.win_z:
            photons = zone_sort(photons, nz, nr, const.win_z)

    # ---- 1b. pair physics from the census field (imcgen2d.f:354-396) ----
    if phys.pair_switch:
        with tm.span("step.pairs"):
            pf = pair_fields(photons, zones, tables, const.pair_tables,
                             grid, scales, nz, nr, mesh, zone_shard)
        state = state._replace(k_gg=pf.k_gg, dn_pp=pf.dn_pp,
                               dne_pa=pf.dne_pa, dnp_pa=pf.dnp_pa)
        nph_raw, nph_fit = pf.nph_raw, pf.nph_fit
    else:
        nph_raw = torch.zeros((nz, nr, g.n_gg), dtype=f32, device=dev)
        nph_fit = nph_raw

    # ---- 2. emit new photons --------------------------------------------
    with tm.span("step.source"):
        draws = sourcing.draw_emit_uniforms(gen, n, dev)
        photons, e_src_lost = sourcing.emit(
            photons, draws, budget, src, grid.r_edges, grid.z_edges,
            grid.zone_surf, ve.eps_tot, ve.eps_th, ve.eloss_th, ve.eloss_tot,
            tables.e_ph, state.dt, nz, nr, c_scaled=scales.c,
        )

    # ---- 3. tracking ----------------------------------------------------
    with tm.span("step.track"):
        # pairs add 2 f_pair scatterers per electron (imctrk2d.f:164-168)
        f_pair = zones.f_pair if phys.pair_switch else None
        n_scat = zones.n_e * (1.0 + 2.0 * f_pair) if phys.pair_switch \
            else zones.n_e
        sigma_zone = zone_sigma_table(
            tables.sigma_e, zones.f_nt, tables.gnt, zones.n_e, f_pair
        ).reshape(nzr, -1).to(f32)
        kappa_zone = ve.kappa_tot.reshape(nzr, -1).to(f32)
        ctx = const.ctx._replace(
            opac_zone=torch.stack([sigma_zone, kappa_zone], dim=-1),
            cdf_nt=zones.cdf_nt.reshape(nzr, -1).to(f32),
            tbbl_pos=src.tbb_lower > 0.0,
            time=state.time,
            dt=state.dt,
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
            photons, tallies, events, gen, ctx, const.track)
        tallies = census_tally(photons, tallies, ctx, const.track)
        if mesh is not None:
            # the reference's MPI_REDUCE trees (xec2d.f:325-399), in rank order
            tallies, n_tracked = pmesh.all_gather_sum(
                mesh, (tallies, n_tracked))

    # ---- 4. FP electron update (update2d) -------------------------------
    zero = torch.zeros((), dtype=f32, device=dev)
    zero_i = torch.zeros((), dtype=i32, device=dev)
    dt_next = state.dt
    if not phys.t_const:
        with tm.span("step.fp"):
            fp_args = (
                flare_zones(zones, grid, phys.flare, state.time, scales),
                tallies.n_field, tables, grid.vol, float(g.z_max), grid.dz,
                state.dt, state.time, ve.eloss_sy, phys, scales, const.fp)
            fp_kw = dict(eloss_br=ve.eloss_br, dn_pp=state.dn_pp,
                         dne_pa=state.dne_pa, dnp_pa=state.dnp_pa,
                         coulomb=const.coulomb_tables)
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
                # the FP ladder's next dt (update2d.f:232-243), at least dt_min
                dt_next = torch.maximum(fpr.dt_new, const.dt_min.to(
                    fpr.dt_new.dtype)).to(state.dt.dtype)
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


def write_diagnostics(sim: Simulation, out_dir: str, extras: bool = False):
    """The reference's diagnostic dumps (SURVEY.md §4): icloss.dat,
    seb.dat, the fnt snapshots, and from the last step nfield.dat,
    eic.dat, esp.dat, and under pair_switch n_ph1.dat / n_ph2.dat (the
    census photon field and its fit).

    ``extras=True`` also dumps the channels the reference deactivates
    (volume2d.f:253-339, excluded from the active budget in both codes,
    volume2d.f:347-353, imcgen2d.f:328-331): eloss_cy.dat and j_cy.dat
    (thermal cyclotron) and under pair_switch j_pa.dat (the
    pair-annihilation spectrum). Every file has the reference's text for
    the same arrays. Under a mesh rank 0 alone writes them (the zone state
    and the tallies are the same on every rank)."""
    if not sim.writes_outputs:
        return
    os.makedirs(out_dir, exist_ok=True)
    t, s = sim.tables, sim.state
    if extras:
        e_ph = t.e_ph.cpu().numpy()
        tea = s.zones.tea.cpu().numpy()
        n_e = s.zones.n_e.cpu().numpy()
        B = s.zones.B_field.cpu().numpy()
        # zone by zone: ex.cyclotron accumulates into one zone's row, so
        # the JAX package's write_diagnostics raises on larger grids
        j_cy = np.stack([
            ex.cyclotron(e_ph, te, ne, b)[0][0]
            for te, ne, b in zip(tea.ravel(), n_e.ravel(), B.ravel())
        ]).reshape(tea.shape + e_ph.shape)
        np.savetxt(os.path.join(out_dir, "eloss_cy.dat"),
                   ex.eloss_cy(e_ph, j_cy).reshape(tea.shape[0], -1),
                   fmt="%14.6e")
        np.savetxt(os.path.join(out_dir, "j_cy.dat"),
                   j_cy.reshape(-1, e_ph.shape[0]), fmt="%14.6e")
        if sim.cfg.physics.pair_switch:
            j_pa = ex.annihilation_spectrum(
                e_ph, t.gnt.cpu().numpy(), s.zones.f_nt.cpu().numpy(),
                s.zones.n_pos.cpu().numpy(), n_e)
            np.savetxt(os.path.join(out_dir, "j_pa.dat"),
                       j_pa.reshape(-1, e_ph.shape[0]), fmt="%14.6e")
    outs.write_icloss(os.path.join(out_dir, "icloss.dat"), t.gnt,
                      t.e_field, t.f_ic)
    outs.write_seb(os.path.join(out_dir, "seb.dat"), t.gnt, s.zones.f_nt,
                   s.zones.n_pos)
    outs.write_electron_snapshots(out_dir, t.gnt, s.zones.f_nt,
                                  s.zones.n_pos, int(s.ncycle))
    o = sim.last_outputs
    if o is None:
        return
    outs.write_nfield(os.path.join(out_dir, "nfield.dat"), t.e_field,
                      o.tallies.n_field, sim.scales.E)
    outs.write_eic(os.path.join(out_dir, "eic.dat"), t.gnt, o.tallies.e_ic,
                   sim.scales.E)
    outs.write_esp(os.path.join(out_dir, "esp.dat"), t.gnt, o.tallies.n_esp)
    if sim.cfg.physics.pair_switch:
        outs.write_nph(os.path.join(out_dir, "n_ph1.dat"), t.e_gg,
                       o.nph_raw)
        outs.write_nph(os.path.join(out_dir, "n_ph2.dat"), t.e_gg,
                       o.nph_fit)
