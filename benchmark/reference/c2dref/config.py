"""A copy of the reference's jax-free
``compton2d_tpu.config``, so that the port imports nothing
of the JAX package. Keep the two in step.

Typed configuration for the simulation.

Replaces the reference's fixed-format, order-dependent text inputs
(``input/input.dat`` parsed by ``reference/src/reader.f:157-597`` and
per-zone ``input/input_JJ_KK.dat`` files, ``reader.f:608-657``) with frozen
dataclasses. A compatibility importer for the legacy formats lives in
:mod:`compton2d_tpu.io.legacy`.

Everything in these classes is *static* under ``jax.jit`` — array-valued
initial conditions (per-zone temperatures etc.) live in
:class:`ZoneInit` which is converted to the device-resident ``ZoneState``
pytree at setup.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

from c2dref import constants as cn


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TimeWindow:
    """One boundary-condition time window (reference t0/t1 + tbb* arrays,
    reader.f:222-283).

    ``tbb_*`` hold one blackbody temperature [keV] per boundary cell; a
    negative value means "external file spectrum" (the reference
    convention) and the matching entry of ``upper_spectra`` /
    ``lower_spectra`` names the 4-column spectrum file for that ring
    (reader.f:231-241 reads one ``u_fname``/``l_fname`` per ring per
    window). File boundaries only switch on once ``time + dt/2 >= t0``
    (imcgen2d.f:127,139,156,173).
    """

    t0: float                      # window start time [s]
    t1: float                      # window end time [s]
    tbb_upper: Tuple[float, ...]   # per r-ring, boundary z = z_max
    tbb_lower: Tuple[float, ...]   # per r-ring, boundary z = 0
    tbb_inner: Tuple[float, ...]   # per z-row, boundary r = r_min
    tbb_outer: Tuple[float, ...]   # per z-row, boundary r = r_max
    # per-ring external spectrum files for rings with tbb < 0
    # (empty tuple = none; entries may be None for thermal rings)
    upper_spectra: Tuple[Optional[str], ...] = ()
    lower_spectra: Tuple[Optional[str], ...] = ()


# ---------------------------------------------------------------------------
# Grid
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GridConfig:
    """Spatial / spectral / angular grids.

    The reference builds uniform-linear zone edges (setup2d.f:60-75), a
    linear mu grid (setup2d.f:148-153) and a piecewise-log photon-energy
    output grid from up to 5 regions (setup2d.f:163-173).
    """

    nz: int = 9                  # zones in z  (reference nz <= 99)
    nr: int = 5                  # zones in r  (reference nr <= 99)
    z_max: float = 1.0e15        # cm, domain height (z in [0, z_max])
    r_min: float = 0.0           # cm, inner radius (0 => transparent axis)
    r_max: float = 1.0e15        # cm, outer radius

    # spectral output regions: (E_min [keV], E_max [keV], n_bins) each
    # (reader.f:290-357)
    spectral_regions: Tuple[Tuple[float, float, int], ...] = (
        (1.0e-7, 1.0e-2, 40),
        (1.0e-2, 1.0e3, 48),
        (1.0e3, 1.0e7, 40),
    )
    nmu: int = 8                 # angular bins (linear in [-1, 1])

    # light-curve bands: (E_min, E_max) [keV]  (reader.f:374-418)
    lc_bands: Tuple[Tuple[float, float], ...] = ((2.0, 10.0),)

    # physics-table sizes (overridable; defaults = reference general.pa)
    num_nt: int = cn.NUM_NT
    n_vol: int = cn.N_VOL
    nphfield: int = cn.NPHFIELD
    n_gg: int = cn.N_GG
    n_ref: int = cn.N_REF

    @property
    def n_zones(self) -> int:
        return self.nz * self.nr

    @property
    def nphtotal(self) -> int:
        return sum(n for (_, _, n) in self.spectral_regions)

    @property
    def nph_lc(self) -> int:
        return len(self.lc_bands)

    def spectral_edges(self) -> np.ndarray:
        """Piecewise-log bin edges ``hu`` [keV], shape (nphtotal+1,).

        Mirrors setup2d.f:163-173.
        """
        edges = []
        for m, (emin, emax, nb) in enumerate(self.spectral_regions):
            e = np.geomspace(emin, emax, nb + 1)
            edges.append(e if m == 0 else e[1:])
        return np.concatenate(edges)

    def mu_edges(self) -> np.ndarray:
        """Upper edges of the nmu linear mu bins (setup2d.f:148-153)."""
        dmu = 2.0 / self.nmu
        return -1.0 + dmu * np.arange(1, self.nmu + 1)


# ---------------------------------------------------------------------------
# Physics switches / parameters
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FlareConfig:
    """Coronal-flare Gaussian turbulence enhancement (reader.f:512-542,
    update2d.f:543-558)."""

    enabled: bool = False
    r_flare: float = 0.0
    z_flare: float = 0.0
    t_flare: float = 0.0
    sigma_r: float = 1.0
    sigma_z: float = 1.0
    sigma_t: float = 1.0
    amplitude: float = 0.0


@dataclass(frozen=True)
class InjectionConfig:
    """Shock / pick-up electron injection (reader.f:544-580,
    update2d.f:1229-1301)."""

    # inj_switch: 0 off, 1 on (shock front sweeping in +z at speed v)
    switch: int = 0
    distribution: int = 2       # 1: Gaussian, 2: power law * exp cutoff
    g1: float = 1.0e2           # PL low cutoff
    g2: float = 1.0e4           # PL high cutoff
    p: float = 2.4              # PL index
    t_start: float = 0.0        # front enters domain at this time [s]
    gauss_g: float = 1.0e3      # Gaussian centroid
    gauss_sigma: float = 1.0e2  # Gaussian width
    luminosity: float = 0.0     # erg/s injected
    v: float = cn.C_LIGHT       # front speed (from bulk Gamma, reader.f:578)
    g2var_switch: int = 0       # growing upper cutoff (update2d.f:1262-1269)
    # constant pick-up injection (pick_sw, update2d.f:1229-1245)
    pickup: bool = False
    pickup_rate: float = 0.0    # cm^-3 s^-1


@dataclass(frozen=True)
class PhysicsConfig:
    """Physics switches mirroring reader.f:473-597 plus FP options."""

    # Compton reflection sentinel (reader.f:476-486):
    # 0 none; 1 lower boundary; 2 outer disk; 3 both; 4 mirror lower bnd.
    cr_sent: int = 0
    # upper_sent: parsed for config parity only — the reference reads it
    # but its reflecting-upper-boundary branch is commented out
    # (imcleak2d.f:286), so it has no effect here either.
    upper_sent: int = 0
    dh_sentinel: int = 0        # disk re-heating by absorbed flux
    pair_switch: int = 0        # gamma-gamma pair production
    t_const: bool = False       # freeze electron temperatures (no FP solve)
    # spec_switch=1: tally the spectra *incident on* the top/bottom
    # boundaries instead of the escaping spectrum (photon-bubble runs,
    # imcleak2d.f:53-58)
    spec_switch: int = 0
    star_switch: int = 0        # dilute upper illumination by (R*/d)^2
    r_star: float = 1.0
    dist_star: float = 1.0

    # escape / acceleration timescales in units of z_max/c
    # (reader.f:544-552, update2d.f:460-461)
    r_esc: float = 3.0
    r_acc: float = 1.0e9

    lnL: float = 20.0           # Coulomb logarithm

    # FP operator term switches. The reference's *active* operator is
    # dgdt = dg_sy + dg_ic + dg_A and disp = disp_A
    # (update2d.f:1048-1049); Coulomb/Moller/bremsstrahlung drift terms are
    # computed but excluded there. We keep them available.
    fp_include_coulomb: bool = False
    fp_include_bremsstrahlung: bool = False
    fp_max_substeps: int = 256
    temp_min: float = 5.0       # keV clamp (update2d.f:345-346,266-276)
    temp_max: float = 1.0e3

    flare: FlareConfig = field(default_factory=FlareConfig)
    injection: InjectionConfig = field(default_factory=InjectionConfig)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExternalRadiationConfig:
    """Blazar external photon fields (disk/BLR/IR torus) entering through
    the lower boundary, Ghisellini-Tavecchio style
    (imcsurf2d_para.f:544-685, reader.f:581-586)."""

    R_blr: float = 0.0      # BLR radius [cm]
    fr_blr: float = 0.0     # BLR covering fraction
    R_ir: float = 0.0       # IR torus radius [cm]
    fr_ir: float = 0.0      # torus covering fraction
    R_disk: float = 0.0     # disk characteristic radius [cm]
    d_jet: float = 0.0      # emission-region distance along jet [cm]
    g_bulk: float = 1.0     # bulk Lorentz factor of the jet frame


@dataclass(frozen=True)
class SourceConfig:
    """Monte-Carlo sourcing parameters (reader.f:464-471,587-597)."""

    nst: int = 10000            # MC particles per cycle
    bias_cap: float = 10.0      # clamp total new particles to cap*nst
                                # (imcgen2d.f:491-517)
    # Variance reduction: the reference's 3-level in-flight splitting
    # (imctrk2d.f:105-661) is replaced by source-side replication with
    # 1/split weights (statistically equivalent; the reference's own
    # det_src variant runs split1=1). split == 1 disables.
    split: int = 1
    # Russian-roulette relative weight floor (wtmin = wkth * ew_birth,
    # imctrk2d.f:81-91)
    weight_floor: float = 1.0e-10
    # Stratified tail splitting: the in-flight analogue of the
    # reference's split2/split3 scheme (imctrk2d.f:593-661). At each
    # scatter in a zone whose electron tail above strat_gamma_c has
    # probability p in (0, strat_p_max], the photon splits in two:
    # the parent samples the electron from the sub-gamma_c stratum
    # (weight fraction 1-p), a copy in a free slot samples from the
    # tail stratum (weight fraction p). Exactly unbiased (unlike the
    # reference's resample-until-big spl3 loop) and guarantees every
    # scatter populates the deep-KN tail.
    strat_split: bool = False
    strat_gamma_c: float = 1.0e3   # tail stratum boundary [gamma]
    strat_p_max: float = 0.5       # only stratify genuinely rare tails
    # tail-copy multiplicity per scattering event: each of the M copies
    # samples an equal sub-stratum of the tail with weight p_tail/M —
    # the unbiased analogue of the reference's split3 resample count
    # (imctrk2d.f:629-661). Raises deep-KN statistics linearly in M on
    # optically thin workloads where scatters themselves are rare.
    strat_copies: int = 1
    external: ExternalRadiationConfig = field(
        default_factory=ExternalRadiationConfig
    )


# ---------------------------------------------------------------------------
# Run control
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RunConfig:
    """Time stepping, capacities, RNG, I/O."""

    t_stop: float = 1.0e4        # s
    mcdt: float = 0.3            # initial dt = mcdt*min(dr,dz)/inj_v
                                 # (setup2d.f:50-51)
    seed: int = 12345
    # fixed photon-slot capacity per device (replaces the reference's
    # 5e6-photon census hard stop, general.pa:7 / imctrk2d.f:573-577)
    n_slots: int = 1 << 16
    max_flight_iters: int = 512  # bound on flight segments per step
    max_scatter_tries: int = 64  # bound on rejection-sampling rounds
    event_capacity: int = 1 << 16  # escaping-photon records per step
    # census population control (replaces the reference's census
    # hard-stop, general.pa:7 / imctrk2d.f:573-577): weight-preserving
    # Russian roulette to census_rr_lo occupancy whenever alive slots
    # exceed census_rr_hi, so fresh emission never starves
    census_rr: bool = True
    census_rr_hi: float = 0.85
    census_rr_lo: float = 0.60
    # Pallas flight megakernel (plan M4): "auto" uses it on TPU when the
    # grid fits the kernel's zone cap and n_slots/device is a multiple
    # of the 1024-photon tile; "on"/"off" force it. The XLA while_loop
    # path remains the fallback (and the CPU-test path).
    pallas_tracking: str = "auto"
    # shard the zone-batched phases (volume_em / FP solve / pair
    # tensors) over the device mesh and all-gather the small per-zone
    # results — the TPU analogue of the reference's FP zone farm
    # (update2d.f:190-214, fp_mpi.f:612-852). Replicated zone compute
    # is otherwise the Amdahl floor at scale. No-op on 1 device.
    zone_shard: bool = True
    # energy unit E0 [erg]: all device energies are stored / E0 (f32
    # range safety, see compton2d_tpu.units). None = auto-estimated from
    # the configuration at setup.
    energy_scale: Optional[float] = None
    out_dir: str = "output"
    event_file: str = "evb.dat"
    walltime_budget_s: float = 0.0   # 0 = no walltime checkpointing
    checkpoint_frac: float = 0.95    # checkpoint at this fraction of budget
    # opt-in adaptive time step: apply the FP dT_max ladder
    # (update2d.f:232-243, dt_min=dr_min/c guard at :257) to the next
    # step's dt. The reference computes the ladder but its apply site is
    # dead code (verified), so constant dt stays the faithful default.
    # When on, the host clock mirror fetches dt after each step (one
    # small blocking device read per step).
    adaptive_dt: bool = False


@dataclass(frozen=True)
class SimConfig:
    grid: GridConfig = field(default_factory=GridConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    source: SourceConfig = field(default_factory=SourceConfig)
    run: RunConfig = field(default_factory=RunConfig)
    windows: Tuple[TimeWindow, ...] = ()

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Per-zone initial conditions (array-valued; reader.f:608-657)
# ---------------------------------------------------------------------------
@dataclass
class ZoneInit:
    """Initial per-zone fields, each shape (nz, nr) float64.

    Mirrors the 11 fields of ``input/input_JJ_KK.dat``
    (``reader.f:608-657``).
    """

    tea: np.ndarray          # electron temperature [keV]
    tna: np.ndarray          # proton temperature [keV]
    n_e: np.ndarray          # electron (proton) density [cm^-3]
    B_field: np.ndarray      # magnetic field [G]
    amxwl: np.ndarray        # Maxwellian fraction in [0, 1]
    gmin: np.ndarray         # nonthermal PL low cutoff
    gmax: np.ndarray         # nonthermal PL high cutoff
    p_nth: np.ndarray        # nonthermal PL index
    q_turb: np.ndarray       # turbulence spectral index
    turb_lev: np.ndarray     # turbulence level
    ep_switch: np.ndarray    # equipartition-B option (imcgen2d.f:216-236)

    @classmethod
    def uniform(
        cls,
        grid: GridConfig,
        tea: float = 100.0,
        tna: float = 100.0,
        n_e: float = 1.0e10,
        B_field: float = 1.0,
        amxwl: float = 1.0,
        gmin: float = 1.0e3,
        gmax: float = 1.0e5,
        p_nth: float = 2.5,
        q_turb: float = 1.6667,
        turb_lev: float = 0.0,
        ep_switch: int = 0,
    ) -> "ZoneInit":
        shape = (grid.nz, grid.nr)
        f = lambda v: np.full(shape, float(v))
        return cls(
            tea=f(tea), tna=f(tna), n_e=f(n_e), B_field=f(B_field),
            amxwl=f(amxwl), gmin=f(gmin), gmax=f(gmax), p_nth=f(p_nth),
            q_turb=f(q_turb), turb_lev=f(turb_lev),
            ep_switch=np.full(shape, int(ep_switch), dtype=np.int32),
        )
