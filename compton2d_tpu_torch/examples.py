"""Ready-made configurations (counterpart of ``compton2d_tpu.examples``)."""
from __future__ import annotations

from compton2d_tpu_torch.config import (
    GridConfig,
    PhysicsConfig,
    RunConfig,
    SimConfig,
    SourceConfig,
    TimeWindow,
    ZoneInit,
)
from compton2d_tpu_torch.driver import Simulation


def small_corona(
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
    device="cpu",
    **phys_kw,
) -> Simulation:
    """A small 2-D accreting corona: a hot thermal electron cloud above a
    cool blackbody disk (the lower boundary). Same configuration as the
    reference's ``small_corona``, built on ``device``."""
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
    return Simulation(cfg, zi, device=device)
