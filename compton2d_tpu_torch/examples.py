"""Ready-made configurations (counterpart of ``compton2d_tpu.examples``)."""
from __future__ import annotations

from typing import Tuple

from compton2d_tpu_torch.config import (
    GridConfig,
    InjectionConfig,
    PhysicsConfig,
    RunConfig,
    SimConfig,
    SourceConfig,
    TimeWindow,
    ZoneInit,
)
from compton2d_tpu_torch.driver import Simulation


def small_corona(device="cuda", mesh=None, **kw) -> Simulation:
    """A small 2-D accreting corona: a hot thermal electron cloud above a
    cool blackbody disk (the lower boundary). Same configuration as the
    reference's ``small_corona``, built on ``device`` (on a photon
    ``mesh``, this rank's share of it); ``kw`` are
    :func:`corona_config`'s."""
    cfg, zi = corona_config(**kw)
    return Simulation(cfg, zi, device=device, mesh=mesh)


def corona_config(
    nz: int = 4,
    nr: int = 3,
    nst: int = 2000,
    n_slots: int = 4096,
    tea: float = 100.0,
    tbb: float = 0.5,
    n_e: float = 1.0e10,
    t_const: bool = False,
    seed: int = 0,
    num_nt: int = 100,
    n_vol: int = 128,
    nphfield: int = 128,
    max_flight_iters: int = 256,
    amxwl: float = 1.0,
    gmin: float = 1.0e3,
    gmax: float = 1.0e5,
    p_nth: float = 2.5,
    **phys_kw,
) -> Tuple[SimConfig, ZoneInit]:
    """:func:`small_corona`'s configuration and zone initialisation, with
    no Simulation built."""
    grid = GridConfig(
        nz=nz, nr=nr, z_max=1.0e15, r_max=1.0e15,
        num_nt=num_nt, n_vol=n_vol, nphfield=nphfield,
        n_gg=32, n_ref=100, nmu=4,
        spectral_regions=((1e-4, 1e-1, 20), (1e-1, 1e4, 40)),
        lc_bands=((2.0, 10.0),),
    )
    win = TimeWindow(
        t0=0.0, t1=1e30,
        tbb_lower=(tbb,) * nr,
        tbb_upper=(0.0,) * nr,
        tbb_inner=(0.0,) * nz,
        tbb_outer=(0.0,) * nz,
    )
    cfg = SimConfig(
        grid=grid,
        physics=PhysicsConfig(t_const=t_const, **phys_kw),
        source=SourceConfig(nst=nst),
        run=RunConfig(seed=seed, n_slots=n_slots,
                      max_flight_iters=max_flight_iters,
                      event_capacity=n_slots),
        windows=(win,),
    )
    zi = ZoneInit.uniform(
        grid, tea=tea, tna=tea, n_e=n_e, B_field=10.0, amxwl=amxwl,
        gmin=gmin, gmax=gmax, p_nth=p_nth,
    )
    return cfg, zi


def blazar_jet(
    nz: int = 10,
    nr: int = 5,
    nst: int = 5000,
    n_slots: int = 16384,
    seed: int = 0,
    device="cuda",
    **phys_kw,
) -> Simulation:
    """A nonthermal blazar-like zone setup: power-law electrons with
    synchrotron volume emission and shock injection, no external boundary
    illumination. Same configuration as the reference's ``blazar_jet``."""
    grid = GridConfig(
        nz=nz, nr=nr, z_max=1.0e16, r_max=3.0e15,
        num_nt=160, n_vol=256, nphfield=256, n_gg=64, n_ref=100, nmu=8,
        spectral_regions=((1e-7, 1e-2, 30), (1e-2, 1e3, 40),
                          (1e3, 1e7, 30)),
        lc_bands=((2.0, 10.0), (1e5, 1e7)),
    )
    win = TimeWindow(
        t0=0.0, t1=1e30,
        tbb_lower=(0.0,) * nr,
        tbb_upper=(0.0,) * nr,
        tbb_inner=(0.0,) * nz,
        tbb_outer=(0.0,) * nz,
    )
    inj = InjectionConfig(
        switch=1, distribution=2, g1=1e2, g2=1e4, p=2.4,
        luminosity=1e42, t_start=0.0,
    )
    cfg = SimConfig(
        grid=grid,
        physics=PhysicsConfig(
            t_const=False, r_acc=1e3, r_esc=3.0, injection=inj, **phys_kw
        ),
        source=SourceConfig(nst=nst),
        run=RunConfig(seed=seed, n_slots=n_slots,
                      event_capacity=n_slots),
        windows=(win,),
    )
    zi = ZoneInit.uniform(
        grid, tea=10.0, tna=10.0, n_e=1e4, B_field=1.0, amxwl=0.1,
        gmin=1e2, gmax=1e4, p_nth=2.4,
    )
    return Simulation(cfg, zi, device=device)


# Mrk 421 light-curve bands from the reference post-processing workload
# (postprocessing/mrk421_lc.input: Gamma=33, r_max=1e16, dt=700 s,
# mu in [0.99944, 0.99964], 7 bands from optical to TeV)
MRK421_GAMMA = 33.0
MRK421_MU_RANGE = (0.99944, 0.99964)
MRK421_DT_S = 700.0
MRK421_BANDS = (
    (1e-3, 3e-3),     # optical
    (2.0, 4.0),       # soft X
    (9.0, 15.0),
    (15.0, 20.0),
    (20.0, 60.0),     # hard X
    (5e5, 5e7),       # GeV
    (1e9, 1e10),      # TeV
)


def mrk421(
    nz: int = 10,
    nr: int = 4,
    nst: int = 20000,
    n_slots: int = 1 << 16,
    seed: int = 0,
    num_nt: int = 200,
    n_vol: int = 400,
    nphfield: int = 400,
    inj_luminosity: float = 4.0e41,
    n_e: float = 20.0,
    device="cuda",
    **phys_kw,
) -> Simulation:
    """The Mrk 421 SSC flare workload: a jet blob (comoving frame) with a
    shock front injecting a power-law electron population; synchrotron
    volume emission and SSC make the broadband SED; light curves are
    Doppler-boosted in post-processing with Gamma = 33. Same configuration
    as the reference's ``mrk421``."""
    grid = GridConfig(
        nz=nz, nr=nr, z_max=1.0e16, r_max=2.5e15,
        num_nt=num_nt, n_vol=n_vol, nphfield=nphfield,
        n_gg=64, n_ref=100, nmu=10,
        spectral_regions=(
            (1e-8, 1e-3, 30), (1e-3, 1e2, 40), (1e2, 1e8, 40),
        ),
        lc_bands=MRK421_BANDS,
    )
    win = TimeWindow(
        t0=0.0, t1=1e30,
        tbb_lower=(0.0,) * nr, tbb_upper=(0.0,) * nr,
        tbb_inner=(0.0,) * nz, tbb_outer=(0.0,) * nz,
    )
    inj = InjectionConfig(
        switch=1, distribution=2, g1=5e2, g2=2e5, p=2.2,
        luminosity=inj_luminosity, t_start=0.0,
    )
    cfg = SimConfig(
        grid=grid,
        physics=PhysicsConfig(
            t_const=False, r_acc=3e2, r_esc=3.0, injection=inj, **phys_kw
        ),
        source=SourceConfig(nst=nst),
        run=RunConfig(seed=seed, n_slots=n_slots, event_capacity=n_slots,
                      t_stop=7.0e4),
        windows=(win,),
    )
    zi = ZoneInit.uniform(
        grid, tea=5.0, tna=5.0, n_e=n_e, B_field=0.1, amxwl=0.05,
        gmin=5e2, gmax=2e5, p_nth=2.2, q_turb=1.6667,
    )
    return Simulation(cfg, zi, device=device)
